"""PyTorch port: the planes kernel's schedules (``variant=`` "beams",
"resident", "stacked", "allbeams") and their multiply types, the plain
version of kernels K1, K10, K7 and K9, held against the JAX
``noise_rdm_pallas`` run in interpret mode on the same compact white cube,
at ``small_test_config()`` (5 beams, 32 pulses, 3404 gates).

Tolerances, relative to the reference's RMS: at float32 the RMS of the
difference within 1e-5 (f32 sums of up to 700 x 32 terms in another order)
and every element within rtol = atol = 3e-4 (as tests/test_pallas_rdm.py);
at bfloat16 the RMS of the difference within 1e-4: both sides round the
same values at the same points, but a sum taken in another order can move
an intermediate across a bf16 rounding boundary (2^-8 on that element);
with bf16 output planes 2e-4, and the output rounding itself exact.
Each case makes one JAX call. The bfloat16 strips of the plan, which the
strip GEMM of K7 and K9 multiplies by, are held exactly, and the strip
schedule on the planes against the plain version's banded windows (rtol
1e-5: the same products, f32 sums in another order). The kernels
themselves run only on the card (tests marked ``cuda``, in
test_torch_cuda.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import (make_rdm_plan as j_rdm_plan,
                                      noise_rdm_pallas,
                                      noise_rdm_pallas_planes)
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.waveform.precompute import from_numpy

SEED = (3, 5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(np.asarray(x, np.complex128)) ** 2)))


@pytest.fixture(scope="module")
def setup():
    jcfg = jparams.small_test_config()
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jplan = j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    plan = nr.make_rdm_plan(from_numpy(jpre._asdict()), mtd,
                            jcfg.sig.prt_num, device="cpu")
    lt = torch.as_tensor(l_np).to(torch.complex64)
    rng = np.random.default_rng(17)
    shape = (l_np.shape[0], jcfg.sig.prt_num, plan.s_compact)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * np.sqrt(0.5)).astype(np.complex64)
    return dict(jplan=jplan, l_np=l_np, plan=plan, lt=lt, z=z)


def _jax_bf16_out(setup):
    """JAX's resident schedule with bf16 multiplies and bf16 output planes
    (``noise_rdm_pallas_planes``, planes padded as ``noise_rdm_pallas``
    pads them)."""
    jplan, z = setup["jplan"], setup["z"]
    zr = jnp.real(jnp.asarray(z)).astype(jnp.bfloat16)
    zi = jnp.imag(jnp.asarray(z)).astype(jnp.bfloat16)
    xrs, xis = [], []
    for seg in jplan.segments:
        pad = ((0, 0), (0, jplan.p_pad - z.shape[1]),
               (seg.pad_front, seg.pad_tail))
        xrs.append(jnp.pad(zr[:, :, seg.c0:seg.c0 + seg.r_len], pad))
        xis.append(jnp.pad(zi[:, :, seg.c0:seg.c0 + seg.r_len], pad))
    return noise_rdm_pallas_planes(xrs, xis, jplan, setup["l_np"],
                                   interpret=True, mul_dtype=jnp.bfloat16,
                                   variant="resident",
                                   out_dtype=jnp.bfloat16)


@pytest.mark.parametrize("variant,dtype,out", [
    ("beams", "f32", "f32"), ("resident", "f32", "f32"),
    ("stacked", "f32", "f32"), ("allbeams", "f32", "f32"),
    ("resident", "bf16", "f32"), ("stacked", "bf16", "f32"),
    ("allbeams", "bf16", "f32"), ("resident", "bf16", "bf16")])
def test_variant_matches_jax(setup, variant, dtype, out):
    """``noise_rdm_compact(variant=, mul_dtype=, out_dtype=)`` (plain on
    the CPU) vs JAX's interpret-mode kernel of the same schedule; at bf16
    also 1e-3..1e-2 RMS away from the port's own f32 map, which shows the
    rounding happened."""
    jmd, tmd = DTYPES[dtype]
    z = setup["z"]
    if out == "bf16":
        want = np.asarray(_jax_bf16_out(setup))
    else:
        want = np.asarray(noise_rdm_pallas(jnp.asarray(z), setup["jplan"],
                                           setup["l_np"], interpret=True,
                                           mul_dtype=jmd, variant=variant))
    counts = (nr.k7_launch_count, nr.k9_launch_count, nr.k10_launch_count)
    got = nr.noise_rdm_compact(torch.from_numpy(z), setup["plan"],
                               setup["lt"], variant=variant, mul_dtype=tmd,
                               out_dtype=DTYPES[out][1])
    assert counts == (nr.k7_launch_count, nr.k9_launch_count,
                      nr.k10_launch_count)
    assert got.shape == want.shape and got.dtype == torch.complex64
    got = got.numpy()
    rms = _rms(want)
    assert rms > 0.0
    if dtype == "f32":
        assert _rms(got - want) <= 1e-5 * rms
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
        return
    f32 = nr.noise_rdm_compact(torch.from_numpy(z), setup["plan"],
                               setup["lt"], variant=variant).numpy()
    assert 1e-3 * rms <= _rms(got - f32) <= 1e-2 * rms
    if out == "f32":
        assert _rms(got - want) <= 1e-4 * rms
        return
    # bf16 output planes: the f32-output map rounded once more, exactly;
    # against JAX a pre-rounding difference that straddles an output
    # rounding boundary becomes a whole output ulp (2^-8), so the RMS
    # bound is twice the bf16-multiply one
    f32_out = nr.noise_rdm_compact(torch.from_numpy(z), setup["plan"],
                                   setup["lt"], variant=variant,
                                   mul_dtype=tmd)
    assert torch.equal(torch.from_numpy(got), nr.round_mul(f32_out, tmd))
    assert _rms(got - want) <= 2e-4 * rms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stacked_draw_mode_is_planes_mode_on_philox_planes(setup, dtype):
    """``stacked=True`` in draw mode equals the stacked planes schedule fed
    the plain Philox planes, bit for bit on the CPU (K1's draws, as the
    TPU's rolling kernel with ``stacked=True`` draws its own)."""
    md = DTYPES[dtype][1]
    plan, lt = setup["plan"], setup["lt"]
    a = nr.noise_rdm(plan, lt, seed=SEED, stacked=True, mul_dtype=md,
                     layout="bvg")
    b = nr.noise_rdm(plan, lt, planes=nr.philox_planes(plan, SEED, 5,
                                                      device="cpu"),
                     variant="stacked", mul_dtype=md, layout="bvg")
    assert torch.equal(a, b) and float(a.abs().max()) > 0.0


@pytest.mark.parametrize("kwargs,error", [
    ({"variant": "stacked", "mul_dtype": torch.bfloat16,
      "out_dtype": torch.bfloat16}, ValueError),
    ({"variant": "allbeams", "out_dtype": torch.bfloat16}, ValueError),
    ({"variant": "beams", "mul_dtype": torch.bfloat16}, NotImplementedError),
    ({"variant": "beams", "rolling": False, "out_dtype": torch.bfloat16},
     NotImplementedError),
    ({"variant": "blocked"}, ValueError),
    ({"mul_dtype": torch.float16}, ValueError),
    ({"stacked": True}, ValueError)])
def test_planes_schedules_refuse_what_they_do_not_run(setup, kwargs, error):
    """stacked/allbeams write float32 only (as JAX raises); K1 and K4
    ("beams") multiply in float32 only and K4 writes float32 only (K1's
    bfloat16 output is held in test_torch_kernel_maps.py); unknown variants
    and types raise; ``stacked=True`` is the draw-mode option."""
    planes = nr.planes_from_compact(torch.from_numpy(setup["z"]),
                                    setup["plan"])
    with pytest.raises(error):
        nr.noise_rdm(setup["plan"], setup["lt"], planes=planes, **kwargs)


@pytest.mark.parametrize("kwargs,error", [
    ({"variant": "resident"}, ValueError),
    ({"stacked": True, "rolling": False}, ValueError),
    ({"rolling": False, "mul_dtype": torch.bfloat16}, NotImplementedError),
    ({"mul_dtype": torch.bfloat16}, NotImplementedError)])
def test_draw_mode_refuses_planes_schedules(setup, kwargs, error):
    """Draw mode runs K1, K4 (float32) or the stacked products
    (``stacked=True``, rolling only, as JAX); the planes schedules need
    planes."""
    with pytest.raises(error):
        nr.noise_rdm(setup["plan"], setup["lt"], seed=SEED, **kwargs)


def test_rdm_plan_strip_is_the_rounded_toeplitz_block(setup):
    """``RdmSegSpec.strip`` equals ``round_mul`` of the float32 strip
    mp[:STRIP_BN+lh-1, :STRIP_BN] bit for bit (k contiguous, zero padding
    rows), and mp is the Toeplitz band that strip describes."""
    bf = torch.bfloat16
    for seg in setup["plan"].segments:
        lh = seg.taps.shape[0]
        band = nr.STRIP_BN + lh - 1
        assert seg.strip.dtype == bf and seg.strip.shape[:2] == (2, 128)
        assert seg.strip.shape[2] % nr.STRIP_BK == 0
        m = nr.round_mul(seg.mp, bf)
        for plane, part in zip(seg.strip, (m.real, m.imag)):
            got = plane.T.float()
            assert torch.equal(got[:band], part[:band, :nr.STRIP_BN])
            assert not bool(got[band:].any())
        col = seg.mp[:lh, 0]
        s = torch.complex(nr.toeplitz_strip(col.real),
                          nr.toeplitz_strip(col.imag))
        assert torch.equal(seg.mp[:band, :nr.STRIP_BN], s[:band])
        assert not bool(seg.mp[band:].abs().any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_strip_schedule_on_planes_equals_banded_windows(setup, dtype):
    """The strip GEMM's schedule on the planes of ``planes_from_compact``
    (rows flattened, each 128-gate block j0 the product of samples j0 ..
    j0+k_pad-1, zeros past the buffer, with the strip) equals the plain
    version's product of [W, T] windows with mp, per segment."""
    md = DTYPES[dtype][1]
    plan = setup["plan"]
    planes = nr.planes_from_compact(torch.from_numpy(setup["z"]), plan, md)
    for seg, (xr, xi) in zip(plan.segments, planes):
        x = torch.complex(xr.float(), xi.float())
        mp = nr.round_mul(seg.mp, md)
        want = torch.matmul(x.unfold(-1, seg.window, seg.tile), mp)
        want = want.reshape(*x.shape[:2], -1)[..., :seg.j_len]
        lh = seg.taps.shape[0]
        s = torch.complex(nr.toeplitz_strip(mp[:lh, 0].real),
                          nr.toeplitz_strip(mp[:lh, 0].imag))
        k_pad, bn = s.shape[0], nr.STRIP_BN
        nb = -(-seg.j_len // bn)
        rows = x.reshape(-1, x.shape[-1])
        rows = torch.nn.functional.pad(
            rows, (0, max((nb - 1) * bn + k_pad - rows.shape[1], 0)))
        got = torch.matmul(rows.unfold(-1, k_pad, bn)[:, :nb], s)
        got = got.reshape(*x.shape[:2], nb * bn)[..., :seg.j_len]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-4 * _rms(want.numpy()))


def test_rdm_plan_d_bf16_is_the_rounded_dft(setup):
    """``RdmPlan.d_bf16``, the bf16 DFT GEMM's A operand made once per plan,
    equals ``round_mul`` of D's planes bit for bit, with zero columns up to
    a multiple of 8 pulses."""
    plan = setup["plan"]
    num_v, num_p = plan.d.shape
    d16 = plan.d_bf16
    assert d16.dtype == torch.bfloat16 and d16.is_contiguous()
    assert d16.shape == (2, num_v, -(-num_p // 8) * 8)
    want = nr.round_mul(plan.d, torch.bfloat16)
    assert torch.equal(d16[0, :, :num_p].float(), want.real)
    assert torch.equal(d16[1, :, :num_p].float(), want.imag)
    assert not bool(d16[:, :, num_p:].float().any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_constants_rounded_once_per_tensor(setup, dtype):
    """The plan's bf16 strip (``strip``, the filter of K7's bf16 PC in
    planes and in draw mode, made once per plan) equals the Toeplitz strip
    of mp's first column rounded with ``round_mul``, contiguous; L's
    (``_rounded_l``) at ``dtype`` equals ``round_mul`` of L, a second call
    returns the kept copy, and after a change to L in place the copy
    follows it (a new rounded copy at bf16; at f32 L itself)."""
    md = DTYPES[dtype][1]
    plan = setup["plan"]
    for seg in plan.segments:
        col = nr.round_mul(seg.mp[:seg.taps.shape[0], 0], torch.bfloat16)
        for plane, part in zip(seg.strip, (col.real, col.imag)):
            assert torch.equal(plane.T.float(), nr.toeplitz_strip(part))
        assert seg.strip.is_contiguous()
    lt = setup["lt"].clone()
    first = nr._rounded_l(lt, md)
    assert torch.equal(first, nr.round_mul(lt, md)) and first.is_contiguous()
    assert nr._rounded_l(lt, md) is first
    lt.mul_(2.0)
    again = nr._rounded_l(lt, md)
    assert (again is lt) if dtype == "f32" else (again is not first)
    assert torch.equal(again, nr.round_mul(lt, md))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_schedule_on_planes_equals_banded_windows(setup, dtype):
    """The bf16 ring schedule (K10's first bf16 PC, kept by
    ``scripts/ablate_k3_k10.py``) on the planes of ``planes_from_compact``:
    each 64-gate tile j0 of a row is the product of its samples j0 ..
    j0 + 64 kt - 1 (kt = ceil((64 + lh - 1) / 64) ring chunks, zeros past
    the buffer) with the first 64 gates of the plan's strip, the same for
    every tile; it equals the plain version's product of [W, T] windows
    with mp, per segment (rtol 1e-5: the same products, f32 sums in another
    order)."""
    md = DTYPES[dtype][1]
    plan = setup["plan"]
    planes = nr.planes_from_compact(torch.from_numpy(setup["z"]), plan, md)
    bn = 64                    # a ring tile's gates
    for seg, (xr, xi) in zip(plan.segments, planes):
        x = torch.complex(xr.float(), xi.float())
        mp = nr.round_mul(seg.mp, md)
        want = torch.matmul(x.unfold(-1, seg.window, seg.tile), mp)
        want = want.reshape(*x.shape[:2], -1)[..., :seg.j_len]
        lh = seg.taps.shape[0]
        kt = -(-(bn + lh - 1) // 64)
        strip = seg.strip.float()                     # [2, 128, k_pad]
        assert strip.shape[2] >= 64 * kt
        s = torch.complex(strip[0, :bn, :64 * kt].T, strip[1, :bn, :64 * kt].T)
        if dtype == "f32":
            s = torch.complex(nr.toeplitz_strip(mp[:lh, 0].real, bn=bn),
                              nr.toeplitz_strip(mp[:lh, 0].imag, bn=bn)
                              )[:64 * kt]
        nb = -(-seg.j_len // bn)
        rows = x.reshape(-1, x.shape[-1])
        rows = torch.nn.functional.pad(
            rows, (0, max((nb - 1) * bn + 64 * kt - rows.shape[1], 0)))
        got = torch.matmul(rows.unfold(-1, 64 * kt, bn)[:, :nb], s)
        got = got.reshape(*x.shape[:2], nb * bn)[..., :seg.j_len]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-4 * _rms(want.numpy()))


def _unswizzle(stage: torch.Tensor) -> torch.Tensor:
    """A drawn stage [2, 128, 64] in the 128-byte swizzle's byte order back
    to [2, rows, samples]: sample k of row r sits at ((k // 8) ^ (r % 8)) *
    8 + k % 8 of the row."""
    r = torch.arange(stage.shape[1])[:, None]
    k = torch.arange(stage.shape[2])[None, :]
    return stage[:, r.expand(-1, k.shape[1]), ((k // 8) ^ (r % 8)) * 8 + k % 8]


@pytest.mark.parametrize("si", [0, 1, 2])
def test_strip_draw_stage_plain_matches_philox_planes(setup, si):
    """The plain twin of a stage the strip GEMM's drawing producers make
    (``strip_draw_stage_plain``: Philox draws rounded to bf16 in the
    128-byte swizzle) holds, unswizzled, the bf16 rounding of
    ``philox_planes`` at its rows and samples: at the first samples (zeros
    before pad_front), inside, and at the last block (zeros from xlen on
    and past the last row)."""
    plan = setup["plan"]
    num_b = setup["lt"].shape[0]
    seg = plan.segments[si]
    rows = num_b * plan.n_pulses
    xr, xi = nr.philox_planes(plan, SEED, num_b, device="cpu")[si]
    width = seg.xlen + 3 * nr.STRIP_BK
    planes = torch.stack([torch.nn.functional.pad(
        x.reshape(rows, seg.xlen), (0, width - seg.xlen, 0, nr.STRIP_BN))
        for x in (xr, xi)]).to(torch.bfloat16)
    last = (seg.xlen - 1) // nr.STRIP_BK * nr.STRIP_BK
    for m0, n0 in ((0, 0), (64, nr.STRIP_BK), (rows - 7, last)):
        got = _unswizzle(nr.strip_draw_stage_plain(plan, SEED, num_b, si, m0,
                                                   n0))
        want = planes[:, m0:m0 + nr.STRIP_BN, n0:n0 + nr.STRIP_BK]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        assert bool(got.float().any())
