"""PyTorch port: the multi-frame device-scan runner
(``pipeline/driver.py::make_device_multiframe``, ``device_results_to_log``,
``run_multiframe_device``) held against the JAX package's ``lax.scan``
runner and against the port's own host loop.

- Kinematics: with the frame processor replaced in both packages by a stub
  that returns the frame's targets, the per-frame truths and the carry
  agree at rtol 1e-6 and the azimuths within 1e-4 deg (float32 in both;
  XLA's and numpy's float32 ``arcsin``/``cos`` may differ in the last
  ulp), for both kinematic models, unchunked and in chunks
  (``frame_offset``/``carry_in``); the port's chunks equal its unchunked
  run bit for bit, and frame ``i`` takes ``frame_seed(seed, i)``.
- The log: equal stacked results give an identical log.
- The port's device scan against its host loop on the same seeds, at JAX's
  own tolerances (``tests/test_pipeline.py:171-188``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.pipeline import driver as jdriver
from radar_tpu.sim.scenario import TargetBatch as JTargets

from radar_tpu_torch.cluster.stages import ClusteredTargets
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.pipeline import driver as tdriver
from radar_tpu_torch.pipeline.frame import FrameResult
from radar_tpu_torch.sim.scenario import TargetBatch

SCENE = ([3000.0, 9000.0, 5000.0], [20.0, 25.0, -12.0], [10.0, 30.0, 5.0],
         [10.0, 12.0, 8.0])
LOG_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "power", "frame",
              "azimuth_deg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stub_processors(monkeypatch):
    """Both packages' frame processors replaced by one that returns the
    frame's targets; the port's records the frame seeds it is given."""
    seeds = []

    def jax_stub(cfg, precomp=None, dtype=None, jit=True):
        return lambda key, tb: tb

    def port_stub(cfg, precomp=None, device="cuda"):
        def process(frame_seed, tb):
            seeds.append(frame_seed)
            return TargetBatch(*(torch.as_tensor(x) for x in tb))
        return process

    monkeypatch.setattr(jdriver, "make_frame_processor", jax_stub)
    monkeypatch.setattr(tdriver, "make_frame_processor", port_stub)
    return seeds


def _close(got, want):
    """Port (stacked TargetBatch of tensors, azimuths, carry) against JAX's
    at the kinematics' tolerances."""
    (res, az, carry), (jres, jaz, jcarry) = got, want
    for f in TargetBatch._fields:
        a, b = res._asdict()[f].numpy(), np.asarray(getattr(jres, f))
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    assert az.dtype == np.float32
    np.testing.assert_allclose(az, np.asarray(jaz), rtol=0, atol=1e-4)
    assert abs(float(carry[0]) - float(jcarry[0])) <= 1e-4
    np.testing.assert_allclose(carry[1], np.asarray(jcarry[1]), rtol=1e-6)


@pytest.mark.parametrize("kinematics", ["altitude", "simple"])
def test_kinematics_match_jax_scan(stub_processors, kinematics):
    jcfg = jparams.small_test_config(channels=8, pulses=32)
    tcfg = tparams.small_test_config(channels=8, pulses=32)
    jrun = jdriver.make_device_multiframe(jcfg, kinematics=kinematics)
    trun = tdriver.make_device_multiframe(tcfg, kinematics=kinematics,
                                          device="cpu")
    jtb, ttb = JTargets.make(*SCENE), TargetBatch.make(*SCENE)
    key = jax.random.PRNGKey(0)
    full = trun(7, ttb, 6)
    jfull = jrun(key, jtb, 6)
    _close(full, jfull)
    # in chunks: frames 1-4, then 5-6 from the carry, against JAX's chunks
    a = trun(7, ttb, 4)
    b = trun(7, ttb, 2, 4, a[2])
    ja = jrun(key, jtb, 4)
    jb = jrun(key, jtb, 2, 4, ja[2])
    _close(a, ja)
    _close(b, jb)
    # the port's chunks are its unchunked run, bit for bit
    for f in TargetBatch._fields:
        assert torch.equal(torch.cat([a[0]._asdict()[f], b[0]._asdict()[f]]),
                           full[0]._asdict()[f]), f
    np.testing.assert_array_equal(np.concatenate([a[1], b[1]]), full[1])
    assert full[2][0] == b[2][0]
    np.testing.assert_array_equal(full[2][1], b[2][1])
    # absolute frame indices seed the frames
    want = [tdriver.frame_seed(7, i) for i in range(1, 7)]
    assert stub_processors == want + want[:4] + want[4:]


def test_kinematics_refusals(stub_processors):
    cfg = tparams.small_test_config()
    with pytest.raises(ValueError, match="kinematics"):
        tdriver.make_device_multiframe(cfg, kinematics="ballistic",
                                       device="cpu")
    run = tdriver.make_device_multiframe(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_frames"):
        run(0, TargetBatch.make(*SCENE), 0)


def _stacked_results(rng, frames, slots):
    valid = rng.uniform(size=(frames, slots)) < 0.4
    valid[1] = False                                   # a frame with none
    f32 = lambda lo, hi: rng.uniform(lo, hi, (frames, slots)).astype(
        np.float32)
    targets = ClusteredTargets(f32(1000, 20000), f32(-30, 30), f32(-10, 40),
                               f32(0.1, 50), valid)
    return (FrameResult(targets, valid.sum(1).astype(np.int32) + 3,
                        valid.sum(1).astype(np.int32)),
            rng.uniform(0, 360, frames).astype(np.float32))


@pytest.mark.parametrize("as_tensors", [False, True])
def test_results_to_log_matches_jax(as_tensors):
    rng = np.random.default_rng(11)
    results, azimuths = _stacked_results(rng, 7, 16)
    want = jdriver.device_results_to_log(results, azimuths)
    if as_tensors:
        targets = ClusteredTargets(*(torch.as_tensor(x)
                                     for x in results.targets[:5]))
        results = FrameResult(targets, torch.as_tensor(results[1]),
                              torch.as_tensor(results[2]))
        azimuths = torch.as_tensor(azimuths)
    got = tdriver.device_results_to_log(results, azimuths)
    assert len(got) == len(want) > 10
    for f in LOG_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    none = results._replace(targets=results.targets._replace(
        valid=results.targets.valid & False))
    empty = tdriver.device_results_to_log(none, azimuths)
    assert len(empty) == 0 and empty.frame.dtype == want.frame.dtype


@pytest.mark.parametrize("config", ["exact", "perf"])
def test_device_scan_matches_host_loop(config):
    """The port's runner against its host loop, JAX's tolerances
    (float32 kinematics against the host's float64 explain only sub-cell
    differences)."""
    cfg = tparams.small_test_config(channels=8, pulses=32)
    if config == "perf":
        cfg = tparams.perf_config(cfg)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    log_h, tracks_h, _ = tdriver.run_multiframe(cfg, tb, 5, seed=0,
                                                device="cpu")
    log_d, tracks_d = tdriver.run_multiframe_device(cfg, tb, 5, seed=0,
                                                    device="cpu")
    assert len(log_d) == len(log_h) >= 5
    np.testing.assert_array_equal(log_d.frame, log_h.frame)
    np.testing.assert_allclose(log_d.range_m, log_h.range_m, atol=1.0)
    np.testing.assert_allclose(log_d.velocity_ms, log_h.velocity_ms,
                               atol=0.5)
    np.testing.assert_allclose(log_d.azimuth_deg, log_h.azimuth_deg,
                               atol=1e-3)
    assert len(tracks_d) == len(tracks_h)


@pytest.mark.parametrize("entry", ["make_device_multiframe",
                                   "run_multiframe_device"])
def test_device_scan_defaults_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = tparams.small_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "make_device_multiframe":
            tdriver.make_device_multiframe(cfg)
        else:
            tdriver.run_multiframe_device(cfg, TargetBatch.make(*SCENE), 1)
