"""PyTorch port: the streaming many-target Monte-Carlo
(``pipeline/streaming.py``) held against the JAX package's
``radar_tpu/pipeline/streaming.py``.

Scenes, truth matching and the statistics are host numpy in both
packages: equal inputs give equal outputs (float64 rtol 1e-12, NaN where
NaN). The port's small runs on the CPU are held by the bounds of
``tests/test_streaming.py::test_streaming_mc_single_device``: every target
counted, detection rate > 0.7 at 12-20 dB, range RMSE < 20 m, velocity
RMSE < 3 m/s."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.pipeline.streaming import _match_rate as j_match_rate
from radar_tpu.pipeline.streaming import aggregate_stats as j_aggregate
from radar_tpu.pipeline.streaming import random_scene as j_random_scene

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.streaming import (HostTargets, _match_rate,
                                                aggregate_stats,
                                                random_scene,
                                                run_streaming_mc)
from radar_tpu_torch.sim.scenario import TargetBatch

PERF = {**tparams.PERF_OVERRIDES, "matmul_precision": "f32"}


@pytest.mark.parametrize("config", ["small", "full"])
def test_random_scene_matches_jax(config):
    make = "small_test_config" if config == "small" else "full_config"
    jcfg, tcfg = getattr(jparams, make)(), getattr(tparams, make)()
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for snr_range in ((0.0, 20.0), (-5.0, 20.0)):
        want = j_random_scene(a, 32, jcfg, snr_range)
        got = random_scene(b, 32, tcfg, snr_range)
        for f in TargetBatch._fields:
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-12)
    assert isinstance(got, TargetBatch)


def test_match_rate_matches_jax():
    rng = np.random.default_rng(3)
    truth = TargetBatch.make(rng.uniform(1000, 20000, 6),
                             rng.uniform(-30, 30, 6), np.zeros(6),
                             np.zeros(6))
    r = np.concatenate([truth.range_m[:4] + rng.normal(0, 20, 4),
                        rng.uniform(1000, 20000, 4)])
    v = np.concatenate([truth.velocity_ms[:4] + rng.normal(0, 1, 4),
                        rng.uniform(-30, 30, 4)])
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    final = HostTargets(valid, r.astype(np.float32), v.astype(np.float32))
    want = j_match_rate(final, truth, 60.0, 3.0)
    got = _match_rate(final, truth, 60.0, 3.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() >= 2
    none = HostTargets(np.zeros(8, bool), r, v)
    assert not _match_rate(none, truth, 60.0, 3.0)[0].any()


def test_aggregate_stats_match_jax():
    rng = np.random.default_rng(5)
    n = 200
    snr = rng.uniform(-5, 20, n)
    det = rng.uniform(size=n) < 0.7
    dr = np.where(det, rng.normal(0, 8, n), np.nan)
    dv = np.where(det, rng.normal(0, 0.3, n), np.nan)
    want = j_aggregate(snr, det, dr, dv, (-5.0, 20.0))
    got = aggregate_stats(snr, det, dr, dv, (-5.0, 20.0))
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, err_msg=f)


@pytest.mark.parametrize("route", ["reference", "perf"])
def test_streaming_mc_single_device(route):
    """After tests/test_streaming.py::test_streaming_mc_single_device."""
    cfg = tparams.small_test_config(channels=8, pulses=32)
    if route == "perf":
        cfg = cfg.replace(**PERF)
    stats = run_streaming_mc(cfg, num_scenes=3, targets_per_scene=4,
                             trials_per_scene=2, seed=0,
                             snr_range=(12.0, 20.0), device="cpu")
    assert stats.total_targets == 3 * 4 * 2
    assert stats.detection_rate > 0.7, stats
    assert stats.range_rmse_m < 20.0
    assert stats.velocity_rmse_ms < 3.0
    assert stats.snr_bin_counts.sum() == stats.total_targets


def test_streaming_mc_reuses_a_processor_and_is_deterministic():
    cfg = tparams.small_test_config().replace(**PERF)
    kw = dict(num_scenes=2, targets_per_scene=3, trials_per_scene=2,
              seed=4, snr_range=(-5.0, 20.0), device="cpu")
    a = run_streaming_mc(cfg, **kw)
    b = run_streaming_mc(cfg, processor=make_frame_processor(cfg,
                                                             device="cpu"),
                         **kw)
    assert a.total_detected == b.total_detected
    np.testing.assert_array_equal(a.snr_bin_rate, b.snr_bin_rate)
    assert a.range_rmse_m == b.range_rmse_m


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"dp_trials": True},
                                {"store": object()}],
                         ids=["mesh", "dp_trials", "store"])
def test_unported_routes_are_refused(kw):
    cfg = tparams.small_test_config()
    with pytest.raises(NotImplementedError, match=next(iter(kw))):
        run_streaming_mc(cfg, num_scenes=1, device="cpu", **kw)


def test_streaming_mc_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_streaming_mc(tparams.small_test_config(), num_scenes=1)
