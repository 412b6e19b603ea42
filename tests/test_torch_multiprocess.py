"""PyTorch port: ``python -m radar_tpu_torch.scripts.run_multiprocess`` (the
counterpart of ``scripts/run_multiprocess.py``) and the CLIs' ``--dp``, on
the CPU.

- The orchestrator starts its workers as processes joined through the
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``):
  the parity mode's four checks pass on every worker, and the streaming
  arms 1 and 2 give bit-equal statistics.
- ``run_snr_sweep --dp 2`` and ``run_streaming_mc --dp 2`` equal their
  one-rank runs (every rank and this process on one torch thread, so
  their sums are taken in one order); ``run_streaming_mc --orbax`` stopped
  on ``--dp 2`` resumes on ``--dp 1`` to the one-rank statistics."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from radar_tpu_torch.scripts import (run_multiprocess, run_snr_sweep,
                                     run_streaming_mc)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores, and these tests
    start ranks of their own: torch runs on one thread here, as in every
    rank (the one-rank runs then sum in the ranks' order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parity_workers_join_from_the_environment(tmp_path):
    """Two workers (the parity mode's smallest even count; four on the
    card in chip_smoke.py): every check on each."""
    out = run_multiprocess.main(["--cpu", "--nproc", "2", "--logdir",
                                 str(tmp_path), "--out",
                                 str(tmp_path / "parity.json")])
    assert out["multiprocess_parity"] and out["rcs"] == [0, 0]
    assert [c["name"] for c in out["checks"]] == [
        "stream_dpxch", "lowrank_dpxcpi", "trials_dp", "perf_dp"]
    assert all(c["ok"] for c in out["checks"])
    assert out["checks"][0]["mesh"] == {"dp": 1, "ch": 2, "cpi": 1}
    with open(tmp_path / "mp_parity_2_1.log") as fh:
        log = fh.read()
    assert "ALL PARITY CHECKS PASSED" in log
    assert "local slice 2:4" in log


def test_streaming_arms_are_bit_equal(tmp_path):
    out = run_multiprocess.main([
        "--cpu", "--streaming", "--arms", "1,2", "--scenes", "2",
        "--targets-per-scene", "4", "--trials-per-scene", "2",
        "--logdir", str(tmp_path), "--out", str(tmp_path / "st.json")])
    assert out["parity_exact_across_arms"]
    one, two = out["arms"]["1"], out["arms"]["2"]
    assert one["injected_targets"] == 16 and one["total_detected"] > 0
    for k in run_multiprocess.STAT_KEYS:
        assert one[k] == two[k], k
    assert len(two["walls_per_worker_s"]) == 2
    with open(tmp_path / "st.json") as fh:
        assert json.load(fh)["parity_exact_across_arms"] is True


def test_snr_sweep_dp_equals_one_rank(tmp_path):
    argv = ["--cpu", "--small", "--prng", "--trials", "4", "--batch", "2",
            "--snr=0:20:20"]
    one = run_snr_sweep.main(argv + ["--json", str(tmp_path / "1.json")])
    two = run_snr_sweep.main(argv + ["--dp", "2", "--json",
                                     str(tmp_path / "2.json")])
    for k in ("angle_error_std_deg", "detection_probability", "snr_db"):
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    assert two["dp"] == 2 and len(two["launches_per_rank"]) == 2
    assert one["detection_probability"][-1] == 1.0
    with open(tmp_path / "2.json") as fh:
        assert json.load(fh)["detection_probability"] == \
            one["detection_probability"]


def test_streaming_mc_dp_resumes_on_another_dp(tmp_path):
    argv = ["--cpu", "--small", "--perf", "--targets", "3", "--trials", "2"]
    keys = ("overall_rate", "rate_by_snr", "range_rmse_m",
            "velocity_rmse_ms", "injected_targets")
    ck = str(tmp_path / "ck")
    one = run_streaming_mc.main(argv + ["--scenes", "2", "--json",
                                        str(tmp_path / "1.json")])
    stopped = run_streaming_mc.main(argv + [
        "--scenes", "1", "--dp", "2", "--orbax", ck, "--json",
        str(tmp_path / "2.json")])
    assert stopped["config"]["dp"] == 2
    assert sorted(os.listdir(ck)) == ["frame_000001", "run_manifest.json"]
    resumed = run_streaming_mc.main(argv + [
        "--scenes", "2", "--dp", "1", "--orbax", ck, "--json",
        str(tmp_path / "3.json")])
    assert one["injected_targets"] == 12 and one["overall_rate"] > 0
    for k in keys:
        np.testing.assert_array_equal(resumed[k], one[k], err_msg=k)
