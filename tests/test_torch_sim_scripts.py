"""PyTorch port: the simulation entry points — ``python -m
radar_tpu_torch.scripts.run_simulation``, ``run_headline_5target``,
``run_snr_sweep``, ``run_streaming_mc`` and ``run_calibration`` — at the
small config on the CPU.

- The slice against JAX: ``run_simulation.run`` with the frame processor
  fed JAX's AWGN draws for each frame writes a ``detection_log.json``
  equal to the one JAX's ``save_detection_log_json`` writes for JAX's
  ``run_multiframe`` on the same scene and seed (rtol 1e-4; frames
  exact), as ``tests/test_torch_driver.py`` holds the driver.
- Both resume routes at 2 -> 4 frames give the uninterrupted run's log.
- ``run_calibration`` prints the pointing angles and K LUT that
  ``radar_tpu.doa.calibrate`` gives (rtol 1e-6).
- One subprocess runs the five scripts in turn and loads neither JAX, nor
  the JAX package, nor matplotlib; their JSON keys hold the JAX scripts'.
- Without a card, without ``--cpu``, each script exits before any work;
  a figure asked for without matplotlib exits naming it; a ``--dp`` that
  does not divide the trials is refused."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.doa import calibrate as jcal
from radar_tpu.io.checkpoint import save_detection_log_json as j_save_log
from radar_tpu.pipeline import driver as jdriver
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.scenario import default_two_target_scene as j_scene
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config.params import small_test_config
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.scripts import (run_calibration, run_headline_5target,
                                     run_simulation, run_snr_sweep,
                                     run_streaming_mc)
from radar_tpu_torch.waveform.precompute import from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_LOADED = ("bad = [m for m in sys.modules if m in ('jax', 'matplotlib',"
              " 'radar_tpu') or m.startswith(('jax.', 'matplotlib.',"
              " 'radar_tpu.'))]; assert not bad, bad")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Small shapes: torch on two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sim_args(out, *extra):
    return run_simulation.parse_args(["--cpu", "--small", "--out", str(out),
                                      *extra])


def _log_rows(path):
    with open(path) as f:
        return json.load(f)


def test_run_simulation_log_matches_jax(tmp_path):
    frames = 4
    jcfg = jparams.small_test_config()
    jpre = j_precompute(jcfg)
    jlog, _, _ = jdriver.run_multiframe(jcfg, j_scene(), frames, seed=0,
                                        precomp=jpre)
    j_save_log(str(tmp_path / "jax.json"), jlog)

    process = make_frame_processor(small_test_config(),
                                   from_numpy(jpre._asdict()), device="cpu")
    cfg = jcfg.sig
    shape = (cfg.prt_num, jpre.tx_pulse.shape[0], cfg.channel_num)
    key = jax.random.PRNGKey(0)

    def with_jax_noise(fseed, targets):
        fkey = jax.random.fold_in(key, fseed & 0xFFFFFFFF)
        noise = np.array(j_add_noise(fkey, jnp.zeros(shape, jnp.complex64)))
        return process(fseed, targets, noise=noise)

    args = _sim_args(tmp_path / "port", "--frames", str(frames))
    report = run_simulation.run(args, torch.device("cpu"),
                                processor=with_jax_noise)
    got = _log_rows(tmp_path / "port" / "detection_log.json")
    want = _log_rows(tmp_path / "jax.json")
    assert len(got) == len(want) >= frames
    assert [r["frame"] for r in got] == [r["frame"] for r in want]
    for key_ in ("range_m", "velocity_ms", "elevation_deg", "power",
                 "azimuth_deg"):
        np.testing.assert_allclose([r[key_] for r in got],
                                   [r[key_] for r in want], rtol=1e-4,
                                   err_msg=key_)
    assert report["detections"] == len(got) and report["tracks"] >= 1
    assert report["device"] == "cpu"


@pytest.mark.parametrize("route", ["host", "device-scan"])
def test_resume_routes_give_the_uninterrupted_log(route, tmp_path, capsys):
    extra = ["--device-scan"] if route == "device-scan" else []
    run_simulation.main(["--cpu", "--small", "--frames", "4", *extra,
                         "--out", str(tmp_path / "whole")])
    for frames in ("2", "4"):
        run_simulation.main(["--cpu", "--small", "--frames", frames,
                             "--resume", *extra, "--out",
                             str(tmp_path / "resumed")])
    out = capsys.readouterr().out
    assert ("resuming: chunks ending at [2]" in out if extra
            else "resuming: frames 1..2 replay" in out)
    assert "processed 4 frames" in out
    whole = _log_rows(tmp_path / "whole" / "detection_log.json")
    assert whole and _log_rows(
        tmp_path / "resumed" / "detection_log.json") == whole
    if extra:
        # the store's chunk size (2) must divide a rerun's frame count
        with pytest.raises(SystemExit, match="not divisible"):
            run_simulation.main(["--cpu", "--small", "--frames", "3",
                                 "--resume", *extra, "--out",
                                 str(tmp_path / "resumed")])


def _printed_list(out, name):
    m = re.search(rf"^{name}\s*= \[(.*)\]$", out, re.M)
    return np.array([float(x) for x in m.group(1).split()])


@pytest.mark.parametrize("flags", [[], ["--procedure", "reference"],
                                   ["--reference-quirks", "--fc-mhz",
                                    "9500"], ["--channels", "8"]])
def test_run_calibration_prints_jax_luts(flags, tmp_path, capsys):
    rep = run_calibration.main(["--cpu", *flags, "--json",
                                str(tmp_path / "cal.json")])
    out = capsys.readouterr().out
    ch = int(flags[1]) if flags[:1] == ["--channels"] else 16
    fc = float(flags[-1]) * 1e6 if "--fc-mhz" in flags else None
    sig = jparams.SigConfig(channel_num=ch,
                            beam_num=13 if ch >= 16 else ch - 3)
    cfg = jparams.RadarConfig(sig=sig,
                              array=jparams.ArrayConfig(num_elements=ch))
    pre = j_precompute(cfg)
    w = np.asarray(pre.dbf_w)
    lam = sig.c / fc if fc else sig.wavelength
    if "--reference-quirks" in flags:
        scan, resp, peaks = jcal.beam_patterns_reference(
            w, cfg.array.element_spacing)
    else:
        scan, resp, peaks = jcal.beam_patterns(
            w, cfg.array.element_spacing, sig.wavelength,
            wavelength_override=lam)
    if "reference" in flags:
        ks = jcal.calibrate_k_slopes(np.fliplr(w),
                                     np.asarray(pre.beam_angles_deg),
                                     cfg.array.element_spacing, lam,
                                     ratio="complex", span_factor=1.0)
    else:
        ks = jcal.calibrate_k_slopes(w, peaks, cfg.array.element_spacing,
                                     lam)
    np.testing.assert_allclose(rep["beam_angles_deg"], peaks, rtol=1e-6)
    np.testing.assert_allclose(rep["k_slopes_lut"], ks, rtol=1e-6)
    # the printed, paste-ready lines (1 and 4 decimals)
    np.testing.assert_allclose(_printed_list(out, "beam_angles_deg"),
                               np.round(peaks, 1), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_printed_list(out, "k_slopes_LUT"),
                               np.round(ks, 4), rtol=1e-6, atol=1e-9)
    assert out.count("\npair ") == len(peaks) - 1
    assert ("pair 11:" in out) == (ch == 16)
    assert json.loads((tmp_path / "cal.json").read_text())["device"] == "cpu"


def test_scripts_in_one_process_load_no_jax(tmp_path):
    """The five scripts in turn in one subprocess at tiny sizes: their
    JSON keys hold the JAX scripts' (and the committed artifacts'), and
    nothing of JAX, the JAX package or matplotlib is loaded."""
    t = str(tmp_path)
    calls = [
        ("run_simulation", ["--cpu", "--small", "--frames", "3", "--smooth",
                            "--checkpoint", "--perf", "--out", t + "/sim"]),
        ("run_headline_5target", ["--cpu", "--small", "--frames", "4",
                                  "--seeds", "2", "--out", t + "/h.json"]),
        ("run_snr_sweep", ["--cpu", "--small", "--trials", "3",
                           "--snr=0:10:10", "--lowrank", "--bf16", "--rbg",
                           "--json", t + "/s.json"]),
        ("run_streaming_mc", ["--cpu", "--small", "--perf", "--scenes", "2",
                              "--targets", "3", "--trials", "2", "--orbax",
                              t + "/ck", "--json", t + "/st.json"]),
        ("run_streaming_mc", ["--cpu", "--small", "--perf", "--scenes", "3",
                              "--targets", "3", "--trials", "2", "--orbax",
                              t + "/ck", "--json", t + "/st3.json"]),
        ("run_calibration", ["--cpu", "--json", t + "/cal.json"]),
    ]
    code = "import sys\n"
    for mod, argv in calls:
        code += (f"from radar_tpu_torch.scripts import {mod}\n"
                 f"{mod}.main({argv!r})\n")
    code += NOT_LOADED + "\n"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    out = proc.stdout
    assert "processed 3 frames" in out and "smoothed:" in out
    assert "resuming: scenes [1, 2] replay" in out
    assert os.path.exists(t + "/sim/checkpoints")

    def keys(name):
        with open(os.path.join(REPO, "results", name)) as f:
            return set(json.load(f))

    rep = json.load(open(t + "/sim/run.json"))
    assert rep["device"] == "cpu" and rep["frames"] == 3
    assert rep["config"]["path"] == "perf"
    assert len(_log_rows(t + "/sim/detection_log.json")) == \
        rep["detections"] >= 3
    h = json.load(open(t + "/h.json"))
    assert keys("headline_5target.json") <= set(h)
    assert h["robustness"]["seeds"] == 2 and len(h["per_target"]) == 5
    assert h["track_pd"] == 1.0
    s = json.load(open(t + "/s.json"))
    assert keys("snr_sweep_perf.json") <= set(s)
    assert s["pipeline"]["rbg"] and s["pipeline"]["lowrank"]
    assert s["detection_probability"] == [1.0, 1.0]
    st, st3 = json.load(open(t + "/st.json")), json.load(open(t + "/st3.json"))
    assert {"perf_config", "injected_targets", "wall_s", "targets_per_s",
            "overall_rate", "rate_by_snr", "snr_bin_edges", "range_rmse_m",
            "velocity_rmse_ms"} <= set(st)
    assert st3["injected_targets"] == 18 and st["device"] == "cpu"
    cal = json.load(open(t + "/cal.json"))
    assert len(cal["beam_angles_deg"]) == 13 == len(cal["pairs"]) + 1
    for r in (rep, h, s, st):
        assert set(r["launches"]) == {"K1", "K1c", "K2", "K3", "K5",
                                      "labels", "tail_captures",
                                      "tail_replays"}
        assert not any(r["launches"].values())   # the CPU: no kernel


SCRIPTS = [
    (run_simulation, ["--out", "{t}/sim"]),
    (run_headline_5target, ["--out", "{t}/h.json"]),
    (run_snr_sweep, ["--json", "{t}/s.json"]),
    (run_streaming_mc, ["--json", "{t}/st.json"]),
    (run_calibration, ["--json", "{t}/cal.json"]),
]


@pytest.mark.parametrize("idx", range(len(SCRIPTS)))
def test_scripts_refuse_a_missing_card(idx, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script, argv = SCRIPTS[idx]
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main([a.format(t=tmp_path) for a in argv])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("script,argv", [
    (run_simulation, ["--small", "--figures", "--out", "{t}/sim"]),
    (run_headline_5target, ["--small", "--figures", "--out", "{t}/h.json"]),
    (run_snr_sweep, ["--small", "--out", "{t}/s.png", "--json",
                     "{t}/s.json"]),
    (run_calibration, ["--out", "{t}/c.png", "--json", "{t}/c.json"])])
def test_a_figure_without_matplotlib_exits_first(script, argv, tmp_path,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        script.main(["--cpu"] + [a.format(t=tmp_path) for a in argv])
    assert not os.listdir(tmp_path)


def test_figures_are_drawn_when_asked(tmp_path):
    run_simulation.main(["--cpu", "--small", "--frames", "3", "--smooth",
                         "--figures", "--out", str(tmp_path)])
    for name in ("ppi", "rhi", "track_history", "clusters",
                 "smoothed_tracks"):
        assert os.path.getsize(tmp_path / f"{name}.png") > 2000, name


@pytest.mark.parametrize("script", [run_snr_sweep, run_streaming_mc])
def test_dp_is_refused(script, tmp_path):
    """A --dp that does not divide the trials is refused before any work
    (a dividing one runs: tests/test_torch_multiprocess.py)."""
    with pytest.raises(SystemExit, match="multiple"):
        script.main(["--cpu", "--small", "--dp", "2", "--trials", "3",
                     "--json", str(tmp_path / "x.json")])
    assert not os.listdir(tmp_path)


def test_snr_sweep_post_gain_bound_on_a_scaled_geometry(tmp_path):
    """``--channels``: the reference bound also at the post-integration
    SNR, in float64 numpy from the waveform's windows (JAX's
    ``scripts/run_snr_sweep.py:145-177``), on JAX's precompute."""
    rep = run_snr_sweep.main(["--cpu", "--channels", "16", "--pulses", "64",
                              "--trials", "2", "--snr=0:10:10", "--json",
                              str(tmp_path / "s.json")])
    pre = j_precompute(jparams.scaled_config(channels=16, pulses=64))

    def eff(w):
        w = np.abs(np.asarray(w)).astype(float)
        return float(w.sum() ** 2 / (len(w) * (w * w).sum()))

    gain = (16 * float(np.mean([eff(r) for r in np.asarray(pre.dbf_w)]))
            * len(pre.mf_long_win) * eff(pre.mf_long_win)
            * 64 * eff(pre.mtd_win))
    raw = np.asarray(rep["theory_bound_raw_snr_deg"])
    snr = 10.0 ** (np.asarray(rep["snr_db"]) / 10.0)
    np.testing.assert_allclose(rep["theory_bound_post_gain_deg"],
                               raw * np.sqrt(snr) / np.sqrt(snr * gain),
                               rtol=1e-12)
    assert rep["integration_gain_db"] == round(10 * np.log10(gain), 2)
    assert rep["config"] == "scaled 16ch x 64p"
    assert "theory_bound_deg" not in rep
