"""PyTorch port: the fused noise RDM (the plain version of kernels K1 and
K4, the Philox draws that K1c exports) held against the JAX Pallas
kernels run in interpret mode with f32 multiplies: the rolling and
non-rolling draw kernels fed the planes JAX's exporter writes, and the
planes kernel.

Tolerance of the RDM comparisons, relative to the reference's RMS: the
RMS of the difference within 1e-5, every element within 1e-4 (f32 sums of
up to 700 x 332 terms taken in another order: the banded PC per 128-gate
tile, the DFT, the mix); K1c's CPU path bit-equal to ``philox_planes``.
The kernels themselves run only on the card (tests marked ``cuda``, in
test_torch_cuda.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import (gen_noise_planes_pallas,
                                      make_rdm_plan as j_rdm_plan,
                                      noise_rdm_pallas,
                                      noise_rdm_pallas_gen,
                                      noise_rdm_pallas_planes,
                                      segment_buffer_len)
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
SEED = (3, 5)


def _close(got, want, rtol=1e-5):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))
    err = got - want
    assert rms(err) <= rtol * rms(want)
    assert float(np.max(np.abs(err))) <= 10 * rtol * rms(want)


@pytest.fixture(scope="module")
def setup():
    over = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32",
            "use_pallas_cfar": True}
    tcfg = tparams.small_test_config().replace(**over)
    jcfg = jparams.small_test_config().replace(**over)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jplan = j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    jl = j_lowrank(jcfg, jpre, None, j_matmul_plan(jpre), mtd, jpre.mtd_win,
                   jnp.complex64)
    tpre = from_numpy(jpre._asdict())
    tl = make_lowrank_stages(tcfg, tpre, device="cpu")
    factors = tl.signal_factors(TargetBatch.make(*TARGETS))
    return dict(tcfg=tcfg, tpre=tpre, jplan=jplan, l_np=l_np, jl=jl, tl=tl,
                factors=factors)



def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 suite."""
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        got = nr.philox4x32_10(*[torch.tensor(c, dtype=torch.int64)
                                 for c in ctr], *key)
        assert tuple(int(g) for g in got) == want


def test_philox_rail_statistics():
    """1e6 uniform rails: mean 0 within 5 sigma, variance 1/2 within 1%,
    support inside [-sqrt(1.5), sqrt(1.5))."""
    n = torch.arange(1_000_000, dtype=torch.int64)
    w0, w1, _, _ = nr.philox4x32_10(n, torch.tensor(7), torch.tensor(2),
                                    torch.tensor(1), 11, 13)
    for w in (w0, w1):
        u = nr._uniform_rail(w).double()
        assert abs(float(u.mean())) < 5 * np.sqrt(0.5 / u.numel())
        assert abs(float(u.var()) / 0.5 - 1.0) < 0.01
        assert float(u.min()) >= -nr.A_UNIF and float(u.max()) < nr.A_UNIF


def test_philox_planes_zero_pad_front_and_are_keyed(setup):
    plan = setup["tl"].rplan
    a = nr.philox_planes(plan, SEED, 5, device="cpu")
    b = nr.philox_planes(plan, (SEED[0], SEED[1] + 1), 5, device="cpu")
    for seg, (xr, xi), (yr, _) in zip(plan.segments, a, b):
        assert xr.shape == (5, plan.n_pulses, seg.xlen)
        assert torch.all(xr[..., :seg.pad_front] == 0)
        assert torch.all(xi[..., :seg.pad_front] == 0)
        assert torch.all(xr[..., seg.pad_front:] != 0)
        assert not torch.equal(xr, yr)
    # the segment index keys the stream: equal geometry, other draws
    assert not torch.equal(a[1][0][..., :100], a[2][0][..., :100])


def test_planes_mode_matches_jax_planes_kernel(setup):
    """Plain K1 in planes mode + fused signal vs the JAX DMA-plane kernel
    fed the same numpy planes, plus the JAX XLA signal RDM."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    num_b, num_p = l_np.shape[0], tl.rplan.n_pulses
    rng = np.random.default_rng(11)
    xrs, xis = [], []
    for seg in jplan.segments:
        shape = (num_b, jplan.p_pad, segment_buffer_len(seg))
        xr = rng.standard_normal(shape).astype(np.float32)
        xi = rng.standard_normal(shape).astype(np.float32)
        xr[..., :seg.pad_front] = 0.0
        xi[..., :seg.pad_front] = 0.0
        xrs.append(xr)
        xis.append(xi)
    want = (noise_rdm_pallas_planes([jnp.asarray(x) for x in xrs],
                                    [jnp.asarray(x) for x in xis], jplan,
                                    l_np, interpret=True,
                                    mul_dtype=jnp.float32)
            + setup["jl"].signal_rdm(JTargets.make(*TARGETS)))
    planes = [(torch.from_numpy(xr[:, :num_p]), torch.from_numpy(xi[:, :num_p]))
              for xr, xi in zip(xrs, xis)]
    got = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                       planes=planes, layout="vgb")
    assert got.shape == want.shape and got.dtype == torch.complex64
    _close(got, want)


def test_plain_matches_jax_rolling_gen_kernel_on_its_planes(setup):
    """Plain K1 vs the JAX in-kernel-draw rolling kernel with the rank-K
    signal fused, fed the exact planes that kernel draws (exported by
    gen_noise_planes_pallas)."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    num_p = tl.rplan.n_pulses
    seed = jnp.asarray(SEED, jnp.int32)
    a = float(np.sqrt(1.5))
    sig = tuple(jnp.asarray(f.numpy()) for f in setup["factors"])
    want = noise_rdm_pallas_gen(seed, jplan, l_np, a, interpret=True,
                                mul_dtype=jnp.float32,
                                out_dtype=jnp.float32, rolling=True,
                                signal=sig)
    xrs, xis = gen_noise_planes_pallas(seed, jplan, l_np.shape[0], a,
                                       interpret=True, mul_dtype=jnp.float32)
    planes = [(torch.from_numpy(np.array(xr)[:, :num_p]),
               torch.from_numpy(np.array(xi)[:, :num_p]))
              for xr, xi in zip(xrs, xis)]
    got = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                       planes=planes, layout="vgb")
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got, want)


def test_draw_mode_is_plain_on_philox_planes(setup):
    tl = setup["tl"]
    planes = nr.philox_planes(tl.rplan, SEED, 5, device="cpu")
    a = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"], seed=SEED,
                     layout="bvg")
    b = nr.noise_rdm_plain(tl.rplan, tl.l_factor, planes, setup["factors"])
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, planes=planes)


def test_noise_power_matches_cholesky_factor(setup):
    """Noise-only draw-mode RDM: the per-beam power equals
    diag(L L^H) x (PC filter energy x DFT row energy) to MC error."""
    tl = setup["tl"]
    rdm = nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, layout="bvg")
    plan = tl.rplan
    l2 = (tl.l_factor.abs() ** 2).sum(1).double()              # [B]
    d2 = (plan.d.abs() ** 2).sum(1).double()                    # [V]
    g = []
    for seg in plan.segments:
        g.append(torch.full((seg.j_len,),
                            float((seg.taps.abs() ** 2).sum())))
    h2 = torch.cat(g).double()                                   # [G]
    want = l2[:, None, None] * d2[None, :, None] * h2[None, None, :]
    # pad_front zeros lower the first gates of segment 0: compare the rest
    sl = slice(plan.segments[0].pad_front, None)
    ratio = float((rdm.abs() ** 2).double()[..., sl].mean()
                  / want[..., sl].mean())
    assert abs(ratio - 1.0) < 0.02


@pytest.fixture(scope="module")
def gen_planes(setup):
    """The planes JAX's generator exports for SEED (interpret, f32)."""
    jplan, l_np = setup["jplan"], setup["l_np"]
    seed = jnp.asarray(SEED, jnp.int32)
    xrs, xis = gen_noise_planes_pallas(seed, jplan, l_np.shape[0],
                                       float(np.sqrt(1.5)), interpret=True,
                                       mul_dtype=jnp.float32)
    num_p = setup["tl"].rplan.n_pulses
    return seed, [(torch.from_numpy(np.array(xr)[:, :num_p]),
                   torch.from_numpy(np.array(xi)[:, :num_p]))
                  for xr, xi in zip(xrs, xis)]


@pytest.mark.parametrize("per_step", ["one", "all"])
def test_window_schedule_matches_jax_non_rolling_kernel(setup, gen_planes,
                                                        per_step):
    """K4's plain path (``rolling=False``) vs JAX's non-rolling in-kernel
    draw kernel with 1 or B beams per grid step, fed the planes that
    kernel draws."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    k = 1 if per_step == "one" else l_np.shape[0]
    seed, planes = gen_planes
    want = noise_rdm_pallas_gen(seed, jplan, l_np, float(np.sqrt(1.5)),
                                interpret=True, mul_dtype=jnp.float32,
                                out_dtype=jnp.float32, rolling=False,
                                beams_per_step=k)
    got = nr.noise_rdm(tl.rplan, tl.l_factor, planes=planes, layout="vgb",
                       rolling=False, beams_per_step=k)
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got, want)


def test_gen_noise_planes_on_cpu_is_philox_planes(setup):
    """K1c's CPU path is its plain version, ``philox_planes``, bit for bit,
    and planes mode on them equals draw mode; no kernel launches."""
    tl = setup["tl"]
    before = nr.k1c_launch_count
    got = nr.gen_noise_planes(tl.rplan, SEED, 5, device="cpu")
    want = nr.philox_planes(tl.rplan, SEED, 5, device="cpu")
    assert nr.k1c_launch_count == before
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert torch.equal(
        nr.noise_rdm(tl.rplan, tl.l_factor, planes=got, layout="bvg"),
        nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, layout="bvg"))


def test_k1c_layout_is_one_aligned_allocation(setup):
    """K1c's segment table: every plane of every segment in one allocation,
    on its own 256-byte boundary, without overlap, in the plan's segment
    order with its pad_front and xlen (what the one launch writes)."""
    plan = setup["tl"].rplan
    table, spans, floats = nr.k1c_layout(plan, 5)
    assert len(table) == 4 * len(plan.segments) == 4 * len(spans)
    ends = []
    for si, (seg, (r, i, size, xlen)) in enumerate(zip(plan.segments,
                                                       spans)):
        assert table[4 * si:4 * si + 4] == [seg.pad_front, seg.xlen, r, i]
        assert size == 5 * plan.n_pulses * seg.xlen and xlen == seg.xlen
        assert r % 64 == 0 and i % 64 == 0
        ends += [(r, r + size), (i, i + size)]
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] <= floats < ends[-1][1] + 64


def test_schedule_arguments_are_checked(setup):
    tl = setup["tl"]
    with pytest.raises(ValueError, match="rolling=False"):
        nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, beams_per_step=2)
    for bad in (0, 6):
        with pytest.raises(ValueError, match="beams_per_step"):
            nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, rolling=False,
                         beams_per_step=bad)
    a = nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, rolling=False)
    assert torch.equal(a, nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED))


# ------------------------------------------------ K1's 3xTF32 arithmetic


def test_split_tf32_parts():
    """``_split_tf32``: hi keeps the top 19 bits (its low 13 are zero),
    rounded to nearest (ties away, as ``cvt.rna.tf32.f32``); lo is the
    rounded remainder, and hi + lo is x within 2^-21 |x|."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000), rng.standard_normal(1000) * 1e-6,
        rng.standard_normal(1000) * 1e6]).astype(np.float32))
    hi, lo = nr._split_tf32(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool((x - hi).abs().le(2.0 ** -11 * x.abs()).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # ties go away from zero: 1 + 2^-11 (a tie) rounds up in magnitude
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert nr._split_tf32(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                              -(1.0 + 2.0 ** -10)]


def test_plan_tf32_planes_reconstruct_strip_and_d(setup):
    """The plan's split constants: each segment's strip_tf32 (re_hi, re_lo,
    im_hi, im_lo) sums to the f32 Toeplitz strip of its filter within 2^-21
    of each value, k padded to the GEMM's 32; d_tf32 to D, zero-padded to
    128 rows and 4 columns."""
    plan = setup["tl"].rplan
    for seg in plan.segments:
        lh = seg.taps.shape[0]
        st = seg.strip_tf32
        assert st.dtype == torch.float32 and st.shape[:2] == (4, nr.STRIP_BN)
        assert st.shape[2] % nr.TF32_BK == 0
        assert st.shape[2] - nr.TF32_BK < nr.STRIP_BN + lh - 1 <= st.shape[2]
        for p, m in enumerate((seg.mp.real, seg.mp.imag)):
            want = nr.toeplitz_strip(m[:lh, 0], bk=nr.TF32_BK).T.double()
            got = st[2 * p].double() + st[2 * p + 1].double()
            assert bool(((got - want).abs()
                         <= 2.0 ** -21 * want.abs()).all())
    d4 = plan.d_tf32
    num_v, num_p = plan.d.shape
    assert d4.shape == (4, -(-num_v // 128) * 128, -(-num_p // 4) * 4)
    for p, m in enumerate((plan.d.real, plan.d.imag)):
        got = (d4[2 * p].double() + d4[2 * p + 1].double())
        assert bool(((got[:num_v, :num_p] - m.double()).abs()
                     <= 2.0 ** -21 * m.double().abs()).all())
        assert not bool(got[num_v:].any()) and not bool(got[:, num_p:].any())


def _trunc_tf32(x):
    """x with its low 13 bits cleared: what the tensor cores read of an f32
    operand in shared memory."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """Complex a @ b as K1's tensor cores form it: each real plane split
    into TF32 parts, hi*hi + hi*lo + lo*hi (exact products, f32 sums), the
    data operand's hi read truncated in the hi*lo term."""
    def real(x, y):
        (xh, xl), (yh, yl) = nr._split_tf32(x), nr._split_tf32(y)
        return xh @ yh + _trunc_tf32(x) @ yl + xl @ yh
    return torch.complex(real(a.real, b.real) - real(a.imag, b.imag),
                         real(a.real, b.imag) + real(a.imag, b.real))


def _tf32_pc_emulated(plan, planes):
    """K1's strip-GEMM PC in its arithmetic on the CPU: per segment the
    strip GEMM over 128-gate blocks (the block's samples j0 .. j0 + k_pad -
    1 times the strip), hi*hi + hi*lo + lo*hi with the strip's TF32 parts:
    pc [B, P, G]."""
    num_b, num_p = planes[0][0].shape[0], plan.n_pulses
    pcs = []
    for seg, (xr, xi) in zip(plan.segments, planes):
        st = seg.strip_tf32                  # [4, 128, k_pad], split
        k_pad, nblk = st.shape[2], -(-seg.j_len // nr.STRIP_BN)
        x = torch.complex(xr[:, :num_p], xi[:, :num_p])
        need = (nblk - 1) * nr.STRIP_BN + k_pad
        x = torch.nn.functional.pad(x, (0, max(need - x.shape[-1], 0)))
        win = x[..., :need].unfold(-1, k_pad, nr.STRIP_BN)  # [B, P, nblk, k]
        xs = win.reshape(-1, k_pad)
        sr, si = (st[0], st[1]), (st[2], st[3])
        xr_, xi_ = xs.real.contiguous(), xs.imag.contiguous()
        (ah, al), (bh, bl) = nr._split_tf32(xr_), nr._split_tf32(xi_)
        at, bt = _trunc_tf32(xr_), _trunc_tf32(xi_)
        # hi*hi + hi*lo + lo*hi with the strip's parts
        prod = lambda h, t, l, s: h @ s[0].T + t @ s[1].T + l @ s[0].T
        y = torch.complex(prod(ah, at, al, sr) - prod(bh, bt, bl, si),
                          prod(ah, at, al, si) + prod(bh, bt, bl, sr))
        pcs.append(y.reshape(num_b, num_p, -1)[..., :seg.j_len])
    return torch.cat(pcs, dim=-1)


def _add_signal(out, signal):
    dv, pb, st = signal
    for k in range(dv.shape[0]):
        out = out + st[k][:, None, None] * (dv[k][:, None] * pb[k][None, :])
    return out


def _k1_tf32_emulated(plan, l_factor, planes, signal):
    """K1's schedule in its arithmetic on the CPU: the strip-GEMM PC, the
    beam mix, the DFT, the rank-K signal."""
    pc = torch.einsum("bc,cpg->bpg", l_factor, _tf32_pc_emulated(plan, planes))
    return _add_signal(_mm3(plan.d, pc), signal)                # [B, V, G]


def _schedules_tf32_emulated(plan, l_factor, planes, signal=None):
    """The f32 schedules' arithmetic (K10, K7, K9 and K7's draw mode, on
    K1's GEMMs) on the CPU: the strip-GEMM PC, the DFT of the un-mixed PC,
    then the beam mix after it, then the rank-K signal."""
    mt = _mm3(plan.d, _tf32_pc_emulated(plan, planes))          # [B, V, G]
    out = torch.einsum("bc,cvg->bvg", l_factor, mt)
    return out if signal is None else _add_signal(out, signal)


def test_k1_tf32_arithmetic_matches_jax_rolling_kernel(setup, gen_planes):
    """K1's 3xTF32 strip-GEMM schedule emulated on the CPU (TF32 parts of
    every operand, three products each, the strip over 128-gate blocks) vs
    JAX's interpret-mode rolling kernel with the signal fused, on the
    planes that kernel draws: RMS within 1e-5, every element within 1e-4 of
    the RMS (K1's hold, before the card is used)."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    seed, planes = gen_planes
    sig = tuple(jnp.asarray(f.numpy()) for f in setup["factors"])
    want = noise_rdm_pallas_gen(seed, jplan, l_np, float(np.sqrt(1.5)),
                                interpret=True, mul_dtype=jnp.float32,
                                out_dtype=jnp.float32, rolling=True,
                                signal=sig)
    got = _k1_tf32_emulated(tl.rplan, tl.l_factor, planes, setup["factors"])
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got.permute(1, 2, 0), want)


# ------------------------------- the f32 schedules on K1's 3xTF32 GEMMs


@pytest.fixture(scope="module")
def white_cube(setup):
    """A compact white cube [B, P, s_compact] complex64 from a numpy seed."""
    plan = setup["tl"].rplan
    rng = np.random.default_rng(23)
    shape = (setup["l_np"].shape[0], plan.n_pulses, plan.s_compact)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


@pytest.mark.parametrize("variant", ["resident", "stacked", "allbeams"])
def test_f32_schedule_tf32_arithmetic_matches_jax_planes_kernel(
        setup, white_cube, variant):
    """K10, K7 and K9 at f32 as they run on the card (K1's 3xTF32 strip
    GEMM, the DFT GEMM on the un-mixed PC, the mix after it) emulated on the
    CPU vs JAX's interpret-mode ``noise_rdm_pallas(mul_dtype=float32,
    variant=)`` on the same compact cube: RMS within 1e-5, every element
    within 1e-4 of the RMS."""
    tl = setup["tl"]
    want = noise_rdm_pallas(jnp.asarray(white_cube), setup["jplan"],
                            setup["l_np"], interpret=True,
                            mul_dtype=jnp.float32, variant=variant)
    planes = nr.planes_from_compact(torch.from_numpy(white_cube), tl.rplan)
    got = _schedules_tf32_emulated(tl.rplan, tl.l_factor, planes)
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got.permute(1, 2, 0), want)


def test_f32_draw_mode_tf32_arithmetic_matches_jax_stacked_kernel(
        setup, gen_planes):
    """K7's draw mode at f32 (``stacked=True``) in its card arithmetic
    (K4's drawn PC, which equals K1's, then the DFT GEMM and the mix after
    it, the rank-K signal) emulated on the CPU vs JAX's interpret-mode
    rolling kernel with ``stacked=True`` and the signal fused, on the
    planes that kernel draws: RMS within 1e-5, every element within 1e-4 of
    the RMS."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    seed, planes = gen_planes
    sig = tuple(jnp.asarray(f.numpy()) for f in setup["factors"])
    want = noise_rdm_pallas_gen(seed, jplan, l_np, float(np.sqrt(1.5)),
                                interpret=True, mul_dtype=jnp.float32,
                                out_dtype=jnp.float32, rolling=True,
                                stacked=True, signal=sig)
    got = _schedules_tf32_emulated(tl.rplan, tl.l_factor, planes,
                                   setup["factors"])
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got.permute(1, 2, 0), want)


# --------------------------------------------------- K4's launch table


def test_k4_launch_table_and_blocks(setup):
    """K4's segment table: draw mode passes no planes and each segment's
    xlen as its columns, planes mode the given pointers; every segment its
    strip, gates, pad_front and plan index (the Philox counter's fourth
    word). (Its blocks, a 128-gate tile x 64 pulses x group of
    beams_per_step beams, are counted by the library from this table.)"""
    plan = setup["tl"].rplan
    draw = nr.k4_table(plan)
    fed = nr.k4_table(plan, [(8 * i + 16, 8 * i + 32, 999)
                             for i in range(len(plan.segments))])
    assert len(draw) == len(fed) == 10 * len(plan.segments)
    for si, seg in enumerate(plan.segments):
        d, f = draw[10 * si:10 * si + 10], fed[10 * si:10 * si + 10]
        assert d[:4] == [0, 0, seg.xlen, seg.xlen]
        assert f[:4] == [8 * si + 16, 8 * si + 32, 999, 999]
        assert d[4:] == f[4:] == [seg.strip_tf32.data_ptr(),
                                  seg.strip_tf32.shape[2], seg.j_len, seg.g0,
                                  seg.pad_front, si]
        assert d[5] % nr.TF32_BK == 0 and d[5] >= nr.STRIP_BN + \
            seg.taps.shape[0] - 1
