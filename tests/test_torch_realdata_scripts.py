"""PyTorch port: the entry points of the real-data and DoA paths, ``python
-m radar_tpu_torch.scripts.run_roc_realdata`` and ``run_doa_accuracy``,
modelled on ``tests/test_roc_scripts.py``: a tiny ``--cpu`` run of each
writes the JAX script's JSON keys (plus the port's timings), finds what
the JAX script finds, and loads no JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_JAX = ("assert 'jax' not in sys.modules, 'jax imported'; "
          "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
          "for m in sys.modules), 'radar_tpu imported'")


def _run(module: str, args: list) -> subprocess.CompletedProcess:
    code = (f"import runpy, sys; sys.argv = ['{module}'] + sys.argv[1:]; "
            f"runpy.run_module('radar_tpu_torch.scripts.{module}', "
            f"run_name='__main__'); {NO_JAX}; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--cpu"] + args, cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc


def test_run_roc_realdata_smoke(tmp_path):
    out = tmp_path / "roc.json"
    proc = _run("run_roc_realdata", ["--trials", "3", "--noise-frames", "2",
                                     "--out", str(out)])
    rep = json.loads(out.read_text())
    assert {"device", "config", "amp", "truth_cell", "trials_per_t",
            "noise_frames", "noise_cells", "t_factors", "pd", "pd_hits",
            "pd_ci95", "pfa", "pfa_hits", "pfa_95_upper_bound", "headline",
            "note", "ref", "wall_s", "seed"} <= set(rep)
    assert rep["device"] == "cpu" and rep["trials_per_t"] == 3
    # the injected gate's cell, found from the noiseless echo
    assert rep["truth_cell"][1] == 1500
    assert len(rep["pd"]) == len(rep["t_factors"]) == 9
    # Pd falls and Pfa falls as the threshold rises
    assert rep["pd"] == sorted(rep["pd"], reverse=True)
    assert rep["pd"][0] == 1.0 and rep["pfa_hits"][0] > 0
    assert rep["pfa_hits"] == sorted(rep["pfa_hits"], reverse=True)
    assert "HEADLINE" in proc.stdout


def test_run_roc_realdata_png_needs_matplotlib(tmp_path, monkeypatch):
    """The figure needs matplotlib (absent on the card's machine): drawing
    without it fails saying so; the run without ``--png`` never imports it
    (asserted in ``test_run_roc_realdata_smoke``)."""
    from radar_tpu_torch.scripts import run_roc_realdata

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        run_roc_realdata.plot({}, str(tmp_path / "roc.png"))


def test_run_doa_accuracy_smoke(tmp_path):
    out = tmp_path / "doa.json"
    _run("run_doa_accuracy", ["--trials", "2", "--snapshots", "256",
                              "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["device"] == "cpu" and rep["elements"] == 128
    assert rep["dtype"] == "complex128"
    one, two = rep["1d_ula"], rep["2d_ura_16x8"]
    assert set(one["rmse_deg"]) == set(one["ms_per_call"]) == {
        "music_grid", "root_music", "tls_esprit",
        "root_music_coherent_smooth64"}
    assert set(two["rmse_deg"]) == set(two["ms_per_call"]) == {
        "music_grid_1deg", "music_zoom", "esprit_2d",
        "esprit_2d_coherent_smooth12x6"}
    # the JAX artifact's accuracy classes (results/doa_accuracy.json):
    # the grid floors near its step, the search-free methods go below
    assert one["rmse_deg"]["root_music"] < 0.1
    assert one["rmse_deg"]["tls_esprit"] < 0.1
    assert one["rmse_deg"]["root_music_coherent_smooth64"] < 0.1
    assert two["rmse_deg"]["music_grid_1deg"] < 0.6
    for k in ("music_zoom", "esprit_2d", "esprit_2d_coherent_smooth12x6"):
        assert two["rmse_deg"][k] < 0.1, k


def test_scripts_refuse_a_missing_card(tmp_path):
    """Without --cpu the scripts need the card; without one they exit
    with a message before any work instead of running on the host."""
    import torch

    from radar_tpu_torch.scripts import run_doa_accuracy, run_roc_realdata

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for script in (run_roc_realdata, run_doa_accuracy):
        with pytest.raises(SystemExit, match="no CUDA device"):
            script.main(["--out", str(tmp_path / "never.json")])
    assert not os.listdir(tmp_path)
