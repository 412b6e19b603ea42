"""PyTorch port: the stages of the exact reference stream and its default
vgq tail, held against the JAX package on identical inputs — DBF, FFT
pulse compression, FFT MTD, the matmul PC/MTD on the full-width cube,
kernel K3's plain version, the vgq first-K extraction, the vgq stencil
estimation and the host connected components.

Tolerances: f32 stages rtol 1e-5 of the reference's largest magnitude
(bf16-operand matmuls 1e-2); K3's mask and threshold, the extraction's
indices and counts, and component ids exactly; estimates rtol 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.cluster.connected import connected_components_np as j_cc
from radar_tpu.config import params as jparams
from radar_tpu.measure.estimate import estimate_parameters as j_estimate
from radar_tpu.ops.dbf import dbf as j_dbf
from radar_tpu.ops.dbf import dbf_weights_effective as j_weights
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.mtd import mtd as j_mtd
from radar_tpu.ops.mtd import mtd_matmul as j_mtd_matmul
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_mplan
from radar_tpu.ops.pulse_compression import make_plan as j_plan
from radar_tpu.ops.pulse_compression import pulse_compress as j_pc
from radar_tpu.ops.pulse_compression import pulse_compress_matmul as j_pcm
from radar_tpu.ops.cfar import extract_detections as j_extract
from radar_tpu.ops.cfar import first_k_true_vgq as j_first_k_vgq
from radar_tpu.ops.cfar import goca_cfar_2d as j_cfar
from radar_tpu.ops.pallas_kernels import goca_cfar_2d_pallas
from radar_tpu.pipeline.frame import measure_consts as j_consts
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.cluster.connected import connected_components_np
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.measure.estimate import estimate_parameters
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.ops import dbf as tdbf
from radar_tpu_torch.ops import mtd as tmtd
from radar_tpu_torch.ops import pulse_compression as tpc
from radar_tpu_torch.ops.cfar import extract_detections, first_k_true_vgq
from radar_tpu_torch.pipeline.frame import measure_consts
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"f32": 1e-5, "bf16": 1e-2}
SMALL = dict(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5, guard_cells_r=10)
T = lambda x: torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.max(np.abs(want))),
                                               1e-30))


def _rand_c64(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


@pytest.fixture(scope="module")
def setup():
    jcfg = jparams.small_test_config()
    jpre = j_precompute(jcfg)
    tpre = from_numpy(jpre._asdict())
    rng = np.random.default_rng(1)
    p, s = jcfg.sig.prt_num, jpre.tx_pulse.shape[0]
    beams = _rand_c64(rng, (p, s, jcfg.sig.beam_num))    # full fast time
    return jcfg, jpre, tpre, beams


@pytest.mark.parametrize("variant", ["v8", "v7_7", "realdata"])
def test_dbf_matches_jax(setup, variant):
    jcfg, jpre, _, _ = setup
    raw = _rand_c64(np.random.default_rng(2), (6, 700, jcfg.sig.channel_num))
    w = np.asarray(jpre.dbf_w)
    want = j_dbf(jnp.asarray(raw), jnp.asarray(w), variant)
    got = tdbf.dbf(torch.from_numpy(raw), w, variant)
    _close(got, want)
    with pytest.raises(ValueError, match="variant"):
        tdbf.dbf(torch.from_numpy(raw), w, "v9")


@pytest.mark.parametrize("variant", ["v8", "v7_7", "realdata"])
def test_dbf_weights_effective_matches_jax(setup, variant):
    """The effective weights on tensors, bit for bit against JAX's, in
    complex64 and complex128."""
    _, jpre, _, _ = setup
    for dtype in (np.complex64, np.complex128):
        w = np.asarray(jpre.dbf_w).astype(dtype)
        want = np.asarray(j_weights(jnp.asarray(w), variant))
        got = tdbf.dbf_weights_effective(torch.from_numpy(w), variant)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype == dtype
    with pytest.raises(ValueError, match="variant"):
        tdbf.dbf_weights_effective(torch.from_numpy(w), "v9")


@pytest.mark.parametrize("trim", [True, False])
def test_pulse_compress_fft_matches_jax(setup, trim):
    _, jpre, tpre, beams = setup
    want = j_pc(jnp.asarray(beams), jpre,
                              j_plan(jpre, trim=trim))
    plan = tpc.make_plan(tpre, trim=trim)
    assert plan._asdict() == {k: v for k, v in
                              j_plan(jpre, trim=trim)._asdict().items()
                              if k in plan._fields}
    got = tpc.pulse_compress(torch.from_numpy(beams), tpre, plan)
    _close(got, want)


@pytest.mark.parametrize("fft_len", [None, 512])
def test_mtd_fft_matches_jax(setup, fft_len):
    jcfg, jpre, _, _ = setup
    pc = _rand_c64(np.random.default_rng(3), (jcfg.sig.prt_num, 400, 5))
    win = np.asarray(jpre.mtd_win, np.float32)
    want = j_mtd(jnp.asarray(pc), jnp.asarray(win), fft_len)
    got = tmtd.mtd(torch.from_numpy(pc), win, fft_len)
    _close(got, want)
    # and the folded-matrix MTD with the same fft_len
    m = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num, fft_len)
    _close(tmtd.mtd_matmul(torch.from_numpy(pc), m), want)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_matmul_pc_and_mtd_on_full_width_cube(setup, precision):
    """pulse_compress_matmul over all 5819 samples of every beam, then
    mtd_matmul with the 512-point matrix, against JAX."""
    jcfg, jpre, tpre, beams = setup
    m = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num, 512)
    jplan = j_mplan(jpre)
    pc_j = jax.jit(lambda x: j_pcm(
        x, jplan, precision=precision))(jnp.asarray(beams))
    pc_t = tpc.pulse_compress_matmul(torch.from_numpy(beams),
                                     tpc.make_matmul_plan(tpre),
                                     precision=precision)
    _close(pc_t, pc_j, TOL[precision])
    rdm_j = jax.jit(lambda x: j_mtd_matmul(x, m, precision=precision))(
        pc_j)
    rdm_t = tmtd.mtd_matmul(T(pc_j), m, precision=precision)
    _close(rdm_t, rdm_j, TOL[precision])


# -------------------------------------------------------------- K3 plain


def _mag(seed, shape, hits=10):
    rng = np.random.default_rng(seed)
    mag = rng.exponential(size=shape).astype(np.float32)
    for _ in range(hits):
        mag[rng.integers(0, shape[0]), rng.integers(10, shape[1] - 10),
            rng.integers(20, shape[2] - 20)] += 60.0
    return mag


@pytest.mark.parametrize("method", ["GOCA", "SOCA", "CA"])
def test_k3_plain_matches_jax_pallas_kernel(method):
    """K3's plain version vs JAX's goca_cfar_2d_pallas in interpret mode,
    on G = 700 gates (not a multiple of the TPU kernel's 512-gate tile):
    mask and threshold identical, [V, G, pairs] layout."""
    mag = _mag(0, (4, 48, 700))
    mask_j, thr_j = goca_cfar_2d_pallas(
        jnp.asarray(mag), jparams.CfarParams(method=method, **SMALL),
        interpret=True)
    mask, thr = ck.goca_cfar_2d_fused(
        torch.from_numpy(mag), tparams.CfarParams(method=method, **SMALL))
    assert mask.shape == mask_j.shape == (48, 700, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(thr_j))
    assert int(mask.sum()) >= 8


def test_k3_plain_equals_cfar_of_pair_sums():
    """At the default window: goca_cfar_2d(pair_sum_maps(rdm)) of the
    JAX package (jitted, so its division is the reciprocal multiply)."""
    rng = np.random.default_rng(4)
    rdm = _rand_c64(rng, (64, 900, 5)) * 2
    rdm[30, 400, 2] += 90.0
    mag = np.ascontiguousarray(np.abs(rdm).transpose(2, 0, 1))
    params = jparams.CfarParams()
    want = jax.jit(lambda x: j_cfar(x[..., :-1] + x[..., 1:], params))(
        jnp.asarray(np.abs(rdm)))
    got = ck.goca_cfar_2d_fused(torch.from_numpy(mag), tparams.CfarParams())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[0][30, 400, 1]) and bool(got[0][30, 400, 2])


def test_k3_refuses_what_jax_refuses():
    mag = torch.zeros((3, 40, 300))
    with pytest.raises(ValueError, match="HALO"):
        ck.goca_cfar_2d_fused(mag, tparams.CfarParams(ref_cells_r=100,
                                                      guard_cells_r=40))
    with pytest.raises(ValueError, match="method"):
        ck.goca_cfar_2d_fused(mag, tparams.CfarParams(method="GO"))
    with pytest.raises(NotImplementedError, match="means_impl"):
        ck.goca_cfar_2d_fused(mag, tparams.CfarParams(means_impl="matmul"))


# ------------------------------------------------- vgq extraction, estimates


@pytest.mark.parametrize("capacity", [8, 64, 512])
def test_extract_detections_vgq_matches_jax(capacity):
    """First-K extraction on a [V, G, pairs] mask, below and above
    capacity: same indices, amplitudes, validity and true count."""
    rng = np.random.default_rng(3)
    num_v, num_g, num_q = 32, 300, 4
    mask = rng.random((num_v, num_g, num_q)) < 0.004
    maps = rng.exponential(size=mask.shape).astype(np.float32)
    got = extract_detections(torch.from_numpy(mask), torch.from_numpy(maps),
                             capacity, layout="vgq")
    want = j_extract(jnp.asarray(mask), jnp.asarray(maps), capacity,
                     layout="vgq", impl="direct")
    for f in ("v_idx", "r_idx", "pair_idx", "amp", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert int(got.count) == int(want.count) == int(mask.sum())
    idx, valid = first_k_true_vgq(torch.from_numpy(mask), capacity)
    idx_j, valid_j = j_first_k_vgq(jnp.asarray(mask), capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    # the same detections read from a permuted view of [pairs, V, G]
    view = torch.from_numpy(np.ascontiguousarray(mask.transpose(2, 0, 1))
                            ).permute(1, 2, 0)
    again = extract_detections(view, torch.from_numpy(maps), capacity,
                               layout="vgq")
    assert torch.equal(again.v_idx, got.v_idx)
    assert torch.equal(again.pair_idx, got.pair_idx)


def test_estimate_parameters_vgq_matches_jax():
    """Spline + monopulse estimation from vgq pair maps with range clip and
    Doppler wrap at the map edges, against JAX (fields rtol 1e-5)."""
    cfg = jparams.small_test_config(max_detections=32)
    pre = j_precompute(cfg)
    rng = np.random.default_rng(5)
    num_v, num_g, num_b = cfg.sig.prt_num, pre.n_total_gate, 5
    rdm = _rand_c64(rng, (num_v, num_g, num_b))
    for v, g, b in ((12, 500, 1), (0, 2000, 3), (31, 1, 0), (5, num_g - 1, 2)):
        rdm[v, g, b] += 80.0 * np.exp(1j * v)
    mag = np.abs(rdm)
    maps = mag[..., :-1] + mag[..., 1:]                       # [V, G, Q]
    mask = maps > 60.0
    dets = j_extract(jnp.asarray(mask), jnp.asarray(maps), 32, layout="vgq",
                     impl="direct")
    ip = cfg.interp
    want = j_estimate(dets, jnp.asarray(maps), jnp.asarray(rdm),
                      j_consts(cfg, pre, np.float32), ip.extra_dots,
                      ip.r_interp_times, ip.v_interp_times)
    tdets = extract_detections(T(mask), T(maps), 32, layout="vgq")
    got = estimate_parameters(
        tdets, T(maps), T(rdm),
        measure_consts(tparams.small_test_config(), from_numpy(
            pre._asdict()), device="cpu"),
        ip.extra_dots, ip.r_interp_times, ip.v_interp_times,
        layout="vgb", maps_layout="vgq")
    assert int(tdets.count) >= 4
    for f in ("range_m", "velocity_ms", "angle_deg", "power"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("fft_len", [None, 512])
def test_measure_consts_respan_the_velocity_axis(fft_len):
    jcfg = jparams.small_test_config().replace(mtd_fft_len=fft_len)
    tcfg = tparams.small_test_config().replace(mtd_fft_len=fft_len)
    pre = j_precompute(jcfg)
    want = j_consts(jcfg, pre, np.float32)
    got = measure_consts(tcfg, from_numpy(pre._asdict()), device="cpu")
    np.testing.assert_array_equal(got.velocity_axis.numpy(),
                                  want.velocity_axis)
    assert got.delta_v == want.delta_v
    assert got.velocity_axis.shape[0] == (fft_len or jcfg.sig.prt_num)


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.random(150) * 30
    adj = np.abs(x[:, None] - x[None, :]) <= 0.4
    np.testing.assert_array_equal(connected_components_np(adj), j_cc(adj))
