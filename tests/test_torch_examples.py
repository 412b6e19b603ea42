"""PyTorch port: the tutorials ``radar_tpu_torch/examples/01-07`` (the
counterparts of ``examples/``), each run through its ``main`` with
``--cpu`` in a temporary working directory, so that 02's ``out_debug/``
and 04's ``out_realdata/`` land there.

Each is held to what its JAX tutorial shows: 01's PC peak one gate before
the injected delay (JAX's 499 for 500), 02's target within 2 gates, 03's
MUSIC, root-MUSIC and ESPRIT within 0.1 deg of the truths, 04's detection
at the injected gate, 05's dp=2 resume equal to the uninterrupted dp=4
run bit for bit, 06's five targets all tracked, 07's collectives,
sharded frames and dp batches equal to one rank's (it raises
otherwise). Nothing is written into the repository's ``out_*``
directories."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["01_pulse_compression_basics", "02_single_frame_debug",
         "03_music_doa", "04_realdata_stages", "05_elastic_checkpointing",
         "06_five_target_tracking", "07_multichip_sharding"]
DELTA_R = 5.996


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores, and these tests
    start ranks of their own: torch runs on one thread here, as in every
    rank (the one-rank runs then sum in the ranks' order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    return importlib.import_module(f"radar_tpu_torch.examples.{name}")


def _repo_outputs():
    out = set()
    for d in ("out_debug", "out_realdata"):
        p = os.path.join(REPO, d)
        if os.path.isdir(p):
            out |= {(d, f) for f in os.listdir(p)}
    return out


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """A temporary cwd; the repository's outputs unchanged."""
    before = _repo_outputs()
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    assert _repo_outputs() == before


def test_examples_cover_the_jax_tutorials():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(
        REPO, "examples")) if f.endswith(".py"))
    port = sorted(f[:-3] for f in os.listdir(os.path.join(
        REPO, "radar_tpu_torch", "examples")) if f[0].isdigit())
    assert port == jax_names == NAMES


def test_01_pulse_compression(in_tmp):
    out = _example(NAMES[0]).main(["--cpu"])
    assert out["peak_gate"] == 499 and out["gain"] > 100.0


@pytest.mark.parametrize("figures", [False, True])
def test_02_single_frame_debug(in_tmp, figures):
    argv = ["--cpu"] + (["--figures"] if figures else [])
    out = _example(NAMES[1]).main(argv)
    with open(in_tmp / "out_debug" / "stage_taps.json") as fh:
        assert json.load(fh) == out
    assert out["taps"]["rdm"] == [32, 3404, 5]
    assert out["num_final"] >= 1
    assert min(abs(r - 3000.0) for r in out["final"]["range_m"]) \
        <= 2 * DELTA_R
    pngs = sorted(p.name for p in (in_tmp / "out_debug").glob("*.png"))
    assert pngs == (["pc_profile.png", "rdm.png"] if figures else [])


def test_02_figures_without_matplotlib_exit_first(in_tmp, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        _example(NAMES[1]).main(["--cpu", "--figures"])
    assert not os.listdir(in_tmp)


def test_03_music_doa(in_tmp):
    out = _example(NAMES[2]).main(["--cpu"])
    for key in ("music_1d", "root_music", "esprit_1d"):
        np.testing.assert_allclose(np.sort(out[key]), out["truth"],
                                   atol=0.1, err_msg=key)
    for key in ("music_2d", "esprit_2d"):
        got = np.asarray(out[key])
        np.testing.assert_allclose(got[np.argsort(got[:, 0])],
                                   out["truth2"][np.argsort(
                                       out["truth2"][:, 0])], atol=0.1,
                                   err_msg=key)


def test_04_realdata_stages(in_tmp):
    best = _example(NAMES[3]).main(["--cpu"])
    assert abs(best["range_m"] - 1500 * DELTA_R) <= 2 * DELTA_R
    assert abs(best["velocity_ms"] - 12.0) < 1.5
    assert sorted(os.listdir(in_tmp / "out_realdata")) == [
        "baseband_raw_data", "beam_diff_estimation", "cfar_flags",
        "mtd_data"]


def test_05_elastic_checkpointing(in_tmp):
    out = _example(NAMES[4]).main(["--cpu"])
    assert out["log_rows"] > 0 and out["tracks"] >= 1
    res, full = out["resumed"], out["uninterrupted"]
    assert res.total_targets == 48 and res.total_detected > 0
    assert res.detection_rate == full.detection_rate
    assert not os.listdir(in_tmp)


def test_06_five_target_tracking(in_tmp):
    out = _example(NAMES[5]).main(["--cpu"])
    assert out["track_pd"] == 1.0 and out["detections"] > 0


def test_07_multichip_sharding(in_tmp):
    r0 = _example(NAMES[6]).main(["--cpu"])
    assert max(r0["dbf"][2], r0["pc"][1], r0["mtd"][2]) <= 1e-4
    assert len(r0["dp"]["num_raw"]) == 8
    assert int(r0["sharded"]["num_final"]) >= 1
