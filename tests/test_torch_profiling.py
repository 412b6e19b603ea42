"""PyTorch port: ``utils/profiling.py`` held against the JAX package's —
``MetricsLog`` gives the same summary and the same saved lines on the same
records, ``StageTimer`` reports JAX's keys, ``trace`` writes a Chrome
trace on the CPU — and the modules of the command-line slice load neither
JAX, nor the JAX package, nor matplotlib."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radar_tpu.utils import profiling as jprof

from radar_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("run_simulation", "run_headline_5target", "run_snr_sweep",
           "run_streaming_mc", "run_calibration", "run_roc", "run_pfa",
           "run_roc_full", "run_pfa_means_ab", "run_monopulse_ab",
           "run_tracking_mc", "run_roc_realdata", "run_doa_accuracy")


def _records(mod, n):
    rng = np.random.default_rng(n)
    return [mod.FrameMetrics(i + 1, float(rng.uniform(0, 360)),
                             int(rng.integers(0, 40)), int(rng.integers(0, 5)),
                             float(rng.exponential(12.0)))
            for i in range(n)]


@pytest.mark.parametrize("n", [0, 1, 7])
def test_metrics_log_matches_jax(n, tmp_path):
    logs = []
    for mod in (jprof, tprof):
        log = mod.MetricsLog()
        for m in _records(mod, n):
            log.record(m)
        logs.append(log)
    jlog, tlog = logs
    assert tlog.summary() == jlog.summary()
    jlog.save(str(tmp_path / "j.jsonl"))
    tlog.save(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    if n:
        m = _records(tprof, 1)[0]
        assert json.loads(m.to_json())["frame_idx"] == 1


def test_stage_timer_reports_jax_keys():
    timers = [jprof.StageTimer(), tprof.StageTimer()]
    jt, tt = timers
    jt.time_stage("pc", lambda: np.ones(4))
    with jt.stage("cfar"):
        pass
    x = torch.ones(8)
    out = tt.time_stage("pc", lambda v: v * 2, x)
    assert torch.equal(out, 2 * x)
    with tt.stage("cfar", sync_value={"a": (x, [x])}):
        pass
    with tt.stage("cfar", sync_value=x):
        pass
    jr, tr = jt.report(), tt.report()
    assert list(tr) == list(jr) == ["cfar", "pc"]
    for k in tr:
        assert set(tr[k]) == set(jr[k]) == {"total_s", "calls", "mean_ms"}
    assert tr["cfar"]["calls"] == 2 and tr["pc"]["calls"] == 1
    assert tr["pc"]["mean_ms"] == pytest.approx(1e3 * tr["pc"]["total_s"])
    assert tt.samples_per_second("pc", 100) > 0.0
    assert tt.samples_per_second("never", 100) == 0.0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.fft.fft(torch.randn(64, 64, dtype=torch.complex64))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in e.get("name", "") for e in events)
    assert any("fft" in a.key for a in prof.key_averages())


def test_slice_loads_no_jax_and_no_matplotlib():
    """``import radar_tpu_torch`` and every module of the slice (the
    profiling and plotting modules and all the port's scripts) load
    neither JAX, nor the JAX package, nor matplotlib."""
    mods = ["radar_tpu_torch", "radar_tpu_torch.utils",
            "radar_tpu_torch.viz", "radar_tpu_torch.viz.plots"] + [
        f"radar_tpu_torch.scripts.{s}" for s in SCRIPTS]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'matplotlib'"
            " or m == 'radar_tpu' or m.startswith(('jax.', 'matplotlib.',"
            " 'radar_tpu.'))]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
