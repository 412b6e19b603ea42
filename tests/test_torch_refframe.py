"""PyTorch port: the reference-stream frame (per-element echoes -> AWGN ->
DBF -> PC -> MTD -> vgq tail with kernel K3's plain version) and its
variants, held against the JAX package's own ``make_frame_processor`` on
the same AWGN: JAX draws it from a key, and the port is handed the very
draws (``noise=``).

Tolerances: equal final counts; range, velocity, angle and power rtol
1e-4; the stage taps of ``return_intermediates`` within 1e-5 of the RMS
(RMS of the difference; single cells within 1e-4 of the RMS, for the f32
sums of up to 700 taps taken in another order), detections exactly, and
any raw-mask difference only at cells within 1e-5 of the threshold."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.cfar import goca_cfar_2d as j_cfar
from radar_tpu.pipeline.frame import make_frame_processor as j_make
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.echo import white_complex_noise as j_white
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import awgn as k5
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")
# a 512-point MTD of 32 pulses spreads a target over ~32 Doppler bins, so
# that case widens the Doppler guard band to keep the targets detectable
WIDE_V = dict(ref_cells_v=4, guard_cells_v=24)
CASES = {
    "threefry": ({}, {}),
    "v7_7_fft512": ({"dbf_variant": "v7_7", "mtd_fft_len": 512}, WIDE_V),
    "pc_mtd_fft": ({"pc_method": "fft", "mtd_method": "fft"}, {}),
    "bf16": ({"matmul_precision": "bf16"}, {}),
    "fused": ({"fused_synth_dbf": True}, {}),
    "pallas_cfar": ({"use_pallas_cfar": True}, {}),
}


def _cfgs(name):
    over, cfar = CASES[name]
    out = []
    for mod in (jparams, tparams):
        cfg = mod.small_test_config().replace(**over)
        out.append(cfg.replace(cfar=dataclasses.replace(cfg.cfar, **cfar)))
    return out


def _rows(t):
    """Valid clustered targets as rows (range, velocity, angle, power)."""
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    valid = host(t.valid)
    return np.stack([host(getattr(t, f))[valid] for f in FIELDS],
                    1).astype(np.float64)


def _assert_same_targets(got, want, **kw):
    """Rows of ``got`` paired with the nearest row of ``want`` in (range,
    velocity) (targets split by the clustering can share a range to
    1e-4), then compared with ``assert_allclose``."""
    a, b = _rows(got), _rows(want)
    assert a.shape == b.shape
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    assert len(set(pair.tolist())) == len(pair)
    np.testing.assert_allclose(a, b[pair], **kw)


def _jax_noise(key, cfg, pre, fused):
    """The draws JAX's frame makes from ``key``: the channel AWGN cube of
    the reference stream or the white beam cube of the fused stream."""
    p, s = cfg.sig.prt_num, pre.tx_pulse.shape[0]
    if fused:
        return np.array(j_white(key, (p, s, cfg.sig.beam_num)))
    return np.array(j_add_noise(key, jnp.zeros((p, s, cfg.sig.channel_num),
                                               jnp.complex64)))


@pytest.fixture(scope="module", params=list(CASES))
def frame_pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jpre = j_precompute(jcfg)
    key = jax.random.PRNGKey(4)
    want = j_make(jcfg, jpre)(key, JTargets.make(*TARGETS))
    noise = _jax_noise(key, jcfg, jpre, jcfg.fused_synth_dbf)
    got = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                               device="cpu")(0, TargetBatch.make(*TARGETS),
                                             noise=noise)
    return request.param, got, want


def test_frame_matches_jax(frame_pair):
    name, got, want = frame_pair
    assert int(got.num_final) == int(want.num_final) >= 2, name
    _assert_same_targets(got.targets, want.targets, rtol=1e-4, err_msg=name)
    assert int(got.num_raw_detections) == int(want.num_raw_detections)


@pytest.fixture(scope="module")
def stages():
    """JAX's and the port's FrameIntermediates of one reference frame."""
    jcfg, tcfg = _cfgs("threefry")
    jpre = j_precompute(jcfg)
    key = jax.random.PRNGKey(8)
    want = j_make(jcfg, jpre, return_intermediates=True)(
        key, JTargets.make(*TARGETS))
    got = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                               device="cpu", return_intermediates=True)(
        0, TargetBatch.make(*TARGETS),
        noise=_jax_noise(key, jcfg, jpre, False))
    return jcfg, tcfg, got, want


@pytest.mark.parametrize("tap", ["raw_iq", "beams", "pc", "rdm",
                                 "pair_maps"])
def test_intermediates_match_jax(stages, tap):
    _, _, got, want = stages
    a, b = getattr(got, tap).numpy(), np.asarray(getattr(want, tap))
    assert a.shape == b.shape and a.dtype == b.dtype
    rms = float(np.sqrt(np.mean(np.abs(b) ** 2)))
    err = np.abs(a.astype(np.complex128) - b)
    assert float(np.sqrt(np.mean(err ** 2))) <= 1e-5 * rms, tap
    assert float(err.max()) <= 1e-4 * rms, tap


def test_intermediate_detections_match_jax(stages):
    jcfg, tcfg, got, want = stages
    gd, wd = got.detections, want.detections
    for f in ("v_idx", "r_idx", "pair_idx", "valid"):
        np.testing.assert_array_equal(getattr(gd, f).numpy(),
                                      np.asarray(getattr(wd, f)), f)
    assert int(gd.count) == int(wd.count) >= 10
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got.params, f).numpy(),
                                   np.asarray(getattr(want.params, f)),
                                   rtol=1e-4, atol=1e-4)
    assert int(got.stage1.count) == int(want.stage1.count)
    _assert_same_targets(got.result.targets, want.result.targets, rtol=1e-4)
    # the raw masks (K3's plain version on the port's magnitudes, JAX's
    # CFAR on its maps) differ at most at cells sitting on the threshold
    mag = torch.from_numpy(np.ascontiguousarray(
        np.abs(got.rdm.numpy()).transpose(2, 0, 1)))
    mask_t, _ = ck.goca_cfar_2d_fused(mag, tcfg.cfar)
    maps_j = np.asarray(want.pair_maps)
    mask_j, thr_j = j_cfar(jnp.asarray(maps_j), jcfg.cfar)
    diff = mask_t.numpy() != np.asarray(mask_j)
    thr_j = np.asarray(thr_j)
    assert np.all(np.abs(maps_j[diff] - thr_j[diff])
                  <= 1e-5 * np.abs(thr_j[diff]))


# ------------------------------------------------ K5 frame, rules, refusals


def test_pallas_noise_frame_detects_and_is_deterministic():
    cfg = tparams.small_test_config().replace(noise_impl="pallas")
    process = make_frame_processor(cfg, device="cpu")
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [20.0])
    before = k5.launch_count
    a, b, c = process(7, tb), process(7, tb), process(8, tb)
    assert k5.launch_count == before          # the CPU runs the plain twin
    r = a.targets.range_m[a.targets.valid].numpy()
    delta_r = cfg.sig.c / cfg.sig.fs / 2
    assert int(a.num_final) >= 1 and np.min(np.abs(r - 3000.0)) < 2 * delta_r
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(a.targets, f), getattr(b.targets, f))
    assert not torch.equal(a.targets.power, c.targets.power)


def test_injected_noise_makes_pallas_and_threefry_frames_equal():
    base = tparams.small_test_config()
    tb = TargetBatch.make(*TARGETS)
    noise = (np.random.default_rng(3).standard_normal(
        (32, 5819, 8, 2)) * np.sqrt(0.5)).astype(np.float32)
    noise = torch.view_as_complex(torch.from_numpy(noise))
    a = make_frame_processor(base, device="cpu")(1, tb, noise=noise)
    b = make_frame_processor(base.replace(noise_impl="pallas"),
                             device="cpu")(2, tb, noise=noise)
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(a.targets, f), getattr(b.targets, f))


def test_extract_impl_rowfetch_runs_the_direct_extraction():
    base = tparams.small_test_config()
    tb = TargetBatch.make(*TARGETS)
    a = make_frame_processor(base, device="cpu")(5, tb)
    b = make_frame_processor(base.replace(extract_impl="rowfetch"),
                             device="cpu")(5, tb)
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(a.targets, f), getattr(b.targets, f))


PERF = {**tparams.PERF_OVERRIDES, "matmul_precision": "f32"}


# the rank-K stream's xla route on threefry draws, which the test reproduces
PERF_XLA = {**PERF, "noise_rdm_impl": "xla", "noise_dist": "normal",
            "noise_prng": "threefry"}


@pytest.mark.parametrize("over", [{}, PERF_XLA], ids=["vgq_tail", "perf"])
def test_native_scan_matches_jax_where_jax_runs_it(over):
    """JAX runs the native scan on the vgq tail
    (radar_tpu/ops/cfar.py:468-480), on the reference stream and on the
    rank-K stream: the port's frame on JAX's draws gives JAX's targets and
    raw count."""
    from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
    from radar_tpu.ops.pulse_compression import make_matmul_plan
    from radar_tpu.ops.pulse_compression import make_plan as j_make_plan
    from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank

    jcfg, tcfg = (mod.small_test_config().replace(
        **over, extract_native_scan=True) for mod in (jparams, tparams))
    jpre = j_precompute(jcfg)
    key = jax.random.PRNGKey(4)
    want = j_make(jcfg, jpre)(key, JTargets.make(*TARGETS))
    if over:
        jl = j_lowrank(jcfg, jpre, j_make_plan(jpre), make_matmul_plan(jpre),
                       j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num),
                       jpre.mtd_win, jnp.complex64)
        noise = np.array(jl.gen_noise(key))
    else:
        noise = _jax_noise(key, jcfg, jpre, False)
    got = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                               device="cpu")(0, TargetBatch.make(*TARGETS),
                                             noise=noise)
    assert int(got.num_final) == int(want.num_final) >= 2
    _assert_same_targets(got.targets, want.targets, rtol=1e-4)
    assert int(got.num_raw_detections) == int(want.num_raw_detections)


@pytest.mark.parametrize("over", [{}, PERF], ids=["qvg_tail", "perf"])
def test_native_scan_warns_where_jax_ignores_it(over):
    cfg = tparams.small_test_config().replace(
        **over, extract_native_scan=True, use_pallas_cfar=True)
    with pytest.warns(UserWarning, match="extract_native_scan is ignored"):
        process = make_frame_processor(cfg, device="cpu")
    jcfg = jparams.small_test_config().replace(
        **over, extract_native_scan=True, use_pallas_cfar=True)
    with pytest.warns(UserWarning, match="extract_native_scan is ignored"):
        j_make(jcfg)
    assert int(process(3, TargetBatch.make(*TARGETS)).num_final) >= 2


def test_wrong_injected_noise_is_refused():
    cfg = tparams.small_test_config()
    tb = TargetBatch.make(*TARGETS)
    ref = make_frame_processor(cfg, device="cpu")
    with pytest.raises(ValueError, match="channel AWGN"):
        ref(0, tb, noise=torch.zeros((32, 5819, 5), dtype=torch.complex64))
    with pytest.raises(ValueError, match="noise_planes"):
        ref(0, tb, noise_planes=[])
    fused = make_frame_processor(cfg.replace(fused_synth_dbf=True),
                                 device="cpu")
    with pytest.raises(ValueError, match="white beam noise"):
        fused(0, tb, noise=torch.zeros((32, 5819, 8), dtype=torch.complex64))
    perf = make_frame_processor(cfg.replace(**PERF), device="cpu")
    with pytest.raises(ValueError, match="noise_planes"):
        perf(0, tb, noise=torch.zeros((32, 5819, 5), dtype=torch.complex64))


@pytest.mark.parametrize("flag,value", [("noise_impl", "rbg"),
                                        ("pc_method", "direct"),
                                        ("mtd_method", "dft")])
def test_unknown_stream_choices_are_refused(flag, value):
    cfg = tparams.small_test_config().replace(**{flag: value})
    with pytest.raises(ValueError, match=flag):
        make_frame_processor(cfg, device="cpu")
