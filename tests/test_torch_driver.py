"""PyTorch port: the multi-frame driver and inter-frame track association,
held against the JAX package. Association: same partition, component
order and track fields (rtol 1e-12 on float64 logs). ``run_multiframe``:
the port's frames get the AWGN JAX draws for each frame
(``fold_in(PRNGKey(seed), frame_idx)``), and the logs agree to rtol 1e-4
with the same tracks and point counts."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.pipeline import driver as jdriver
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.pipeline import driver as tdriver
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOG_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "power", "frame",
              "azimuth_deg")
TRACK_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "azimuth_deg",
                "power", "first_frame", "last_frame", "num_points")


def _logs(**cols):
    return (jdriver.DetectionLog(**{k: np.array(v) for k, v in cols.items()}),
            tdriver.DetectionLog(**{k: np.array(v) for k, v in cols.items()}))


def _same_tracks(got, want, rtol=1e-12):
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        for f in TRACK_FIELDS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=rtol, err_msg=f)
        np.testing.assert_array_equal(a.member_idx, b.member_idx)
        assert a.height_m == pytest.approx(b.height_m, rel=rtol)


def _split_log():
    """tests/test_pipeline.py:57-82: two targets over two frames."""
    return _logs(range_m=[1000.0, 1010.0, 5000.0, 5005.0],
                 velocity_ms=[10.0, 10.1, -5.0, -5.1],
                 elevation_deg=[10.0, 10.2, 20.0, 20.1],
                 power=[1.0, 2.0, 3.0, 4.0], frame=[1, 2, 1, 2],
                 azimuth_deg=[0.0, 0.3, 0.0, 0.3])


@pytest.mark.parametrize("frames", [[1, 2, 1, 2], [1, 7, 1, 2]])
def test_associate_tracks_on_pipeline_logs(frames):
    jlog, tlog = _split_log()
    jlog.frame = tlog.frame = np.array(frames)
    cfg_j, cfg_t = jparams.small_test_config(), tparams.small_test_config()
    _same_tracks(tdriver.associate_tracks(tlog, cfg_t),
                 jdriver.associate_tracks(jlog, cfg_j))
    _same_tracks(tdriver.tracks_without_association(tlog),
                 jdriver.tracks_without_association(jlog))


@pytest.mark.parametrize("wrap", [False, True])
def test_associate_tracks_azimuth_wrap(wrap):
    """tests/test_pipeline.py:85-110: a track crossing north."""
    jlog, tlog = _logs(range_m=[2000.0, 2001.0], velocity_ms=[5.0, 5.0],
                       elevation_deg=[10.0, 10.0], power=[1.0, 1.0],
                       frame=[1, 2], azimuth_deg=[359.5, 0.5])
    cfgs = [m.small_test_config() for m in (jparams, tparams)]
    cfg_j, cfg_t = [c.replace(inter_frame=dataclasses.replace(
        c.inter_frame, wrap_azimuth=wrap)) for c in cfgs]
    got = tdriver.associate_tracks(tlog, cfg_t)
    want = jdriver.associate_tracks(jlog, cfg_j)
    assert len(got) == len(want) == (1 if wrap else 2)
    _same_tracks(got, want, rtol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_associate_tracks_random_log(seed):
    rng = np.random.default_rng(seed)
    n = 120
    jlog, tlog = _logs(
        range_m=rng.choice([3000.0, 3020.0, 5000.0], n) + rng.normal(0, 8, n),
        velocity_ms=rng.choice([10.0, -4.0], n) + rng.normal(0, 0.2, n),
        elevation_deg=rng.uniform(5, 15, n), power=rng.exponential(5, n),
        frame=np.sort(rng.integers(1, 30, n)),
        azimuth_deg=rng.uniform(0, 20, n))
    cfg_j, cfg_t = jparams.small_test_config(), tparams.small_test_config()
    _same_tracks(tdriver.associate_tracks(tlog, cfg_t),
                 jdriver.associate_tracks(jlog, cfg_j))
    assert tdriver.associate_tracks(tdriver.DetectionLog.empty(), cfg_t) == []


def test_frame_seeds_are_distinct_per_frame_and_run():
    seeds = {tdriver.frame_seed(s, i) for s in range(4) for i in range(1, 50)}
    assert len(seeds) == 4 * 49
    assert tdriver.frame_seed(3, 7) & 0xFFFFFFFF == 7


def test_run_multiframe_matches_jax():
    jcfg = jparams.small_test_config(channels=8, pulses=32)
    tcfg = tparams.small_test_config(channels=8, pulses=32)
    jpre = j_precompute(jcfg)
    init = ([3000.0], [15.0], [10.0], [18.0])
    jlog, jtracks, jscen = jdriver.run_multiframe(
        jcfg, JTargets.make(*init), 6, seed=0, precomp=jpre)
    process = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                                   device="cpu")
    shape = (32, jpre.tx_pulse.shape[0], 8)
    key = jax.random.PRNGKey(0)

    def with_jax_noise(fseed, targets):
        fkey = jax.random.fold_in(key, fseed & 0xFFFFFFFF)
        noise = np.array(j_add_noise(fkey, jnp.zeros(shape, jnp.complex64)))
        return process(fseed, targets, noise=noise)

    log, tracks, scen = tdriver.run_multiframe(
        tcfg, TargetBatch.make(*init), 6, seed=0, processor=with_jax_noise,
        device="cpu")
    assert len(log) == len(jlog) >= 5
    np.testing.assert_array_equal(log.frame, jlog.frame)
    for f in LOG_FIELDS:
        np.testing.assert_allclose(getattr(log, f), getattr(jlog, f),
                                   rtol=1e-4, err_msg=f)
    _same_tracks(tracks, jtracks, rtol=1e-4)
    assert [t.num_points for t in tracks] == [t.num_points for t in jtracks]
    assert scen.azimuth_deg == pytest.approx(jscen.azimuth_deg, rel=1e-12)


def test_run_multiframe_own_noise_and_refusals():
    cfg = tparams.small_test_config()
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    log, tracks, _ = tdriver.run_multiframe(cfg, tb, 3, seed=2,
                                            kinematics="simple",
                                            device="cpu")
    main = max(tracks, key=lambda t: t.num_points)
    assert main.num_points >= 3 and abs(main.range_m - 3000.0) < 60.0
    with pytest.raises(NotImplementedError, match="store"):
        tdriver.run_multiframe(cfg, tb, 1, store=object(), device="cpu")
    off = cfg.replace(inter_frame=dataclasses.replace(cfg.inter_frame,
                                                      enable=False))
    log2, tracks2, _ = tdriver.run_multiframe(off, tb, 2, device="cpu")
    assert len(tracks2) == len(log2) and all(t.num_points == 1
                                             for t in tracks2)


@pytest.mark.parametrize("entry", ["make_frame_processor", "run_multiframe"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` the entry points run on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = tparams.small_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "make_frame_processor":
            make_frame_processor(cfg)
        else:
            tdriver.run_multiframe(cfg, TargetBatch.make([3000.0], [15.0],
                                                         [10.0], [10.0]), 1)
