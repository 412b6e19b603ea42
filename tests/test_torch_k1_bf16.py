"""PyTorch port: kernels K1, K4 and K1's planes mode with bfloat16
operands (the TPU kernel's default ``mul_dtype``, what JAX runs on its
accelerator) and K1c's bfloat16 planes, in their plain versions, held
against the JAX package's Pallas kernels run in interpret mode at
``mul_dtype=jnp.bfloat16`` on the same draws (small_test_config: 5 beams,
32 pulses, 3404 gates).

JAX's rolling kernel draws its own noise, so it is fed through the planes
its exporter writes (``gen_noise_planes_pallas(mul_dtype=bfloat16)``), as
tests/test_torch_noise_rdm.py does at float32. Tolerances, relative to the
reference's RMS: the RMS of the difference within 1e-4 with float32 output
(both sides round the same values at the same points, but the rolling
kernel sums its PC in four accumulators a 128-sample chunk and the port in
one product, so a few intermediates land on the other side of a bf16
rounding boundary, 2^-8 on that element), within 2e-4 with bfloat16 output
(such a flip before the output rounding becomes a whole output ulp); the
pair maps within 1e-4 (they are taken before the output rounding), and
the port's maps of JAX's own f32 map equal JAX's maps at rtol 1e-6
(sqrt(re^2 + im^2) rounded in another order). Within the
port: draw mode equals planes mode on the Philox planes, and K4 equals K1,
bit for bit. The plain beam mix (``mix_plain``, the kernel ``mix``'s plain
version) is held against the TPU kernel's own mix, ``_mix_vals`` with the
signal and the pair maps as its rolling kernel forms them, on the same
numpy inputs at K of 0, 2 and 40 (RMS of the difference within 1e-6 of
the RMS: both sum in f32, in other orders). The kernels themselves run
only on the card (tests marked ``cuda``, in test_torch_cuda.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import (_mix_vals, gen_noise_planes_pallas,
                                      make_rdm_plan as j_rdm_plan,
                                      noise_rdm_pallas_gen,
                                      noise_rdm_pallas_planes,
                                      segment_buffer_len)
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.ops.cfar_kernel import HALO
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
SEED = (3, 5)
A = float(np.sqrt(1.5))
BF = torch.bfloat16
OUT = {"f32": (jnp.float32, torch.float32, 1e-4),
       "bf16": (jnp.bfloat16, torch.bfloat16, 2e-4)}


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(np.asarray(x, np.complex128)) ** 2)))


def _held(got, want, hold: float) -> None:
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and _rms(want) > 0.0
    assert _rms(got - want) <= hold * _rms(want)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread (no hold depends on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    over = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32"}
    jcfg = jparams.small_test_config().replace(**over)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jplan = j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    tl = make_lowrank_stages(tparams.small_test_config().replace(**over),
                             from_numpy(jpre._asdict()), device="cpu")
    factors = tl.signal_factors(TargetBatch.make(*TARGETS))
    seed = jnp.asarray(SEED, jnp.int32)
    xrs, xis = gen_noise_planes_pallas(seed, jplan, l_np.shape[0], A,
                                       interpret=True,
                                       mul_dtype=jnp.bfloat16)
    num_p = tl.rplan.n_pulses
    # JAX's bf16 planes, exactly, as f32 tensors [B, P, buffer]
    planes = [(torch.from_numpy(np.asarray(xr, np.float32)[:, :num_p]),
               torch.from_numpy(np.asarray(xi, np.float32)[:, :num_p]))
              for xr, xi in zip(xrs, xis)]
    return dict(jplan=jplan, l_np=l_np, tl=tl, factors=factors, seed=seed,
                jplanes=(xrs, xis), planes=planes)


@pytest.fixture(scope="module")
def jax_rolling(setup):
    """JAX's rolling kernel with the signal fused and its maps, at bf16
    operands, per output type (one interpret-mode call each)."""
    cache = {}

    def get(out: str):
        if out not in cache:
            sig = tuple(jnp.asarray(f.numpy()) for f in setup["factors"])
            rdm, maps = noise_rdm_pallas_gen(
                setup["seed"], setup["jplan"], setup["l_np"], A,
                interpret=True, mul_dtype=jnp.bfloat16,
                out_dtype=OUT[out][0], rolling=True, signal=sig,
                emit_maps=True)
            cache[out] = (np.array(rdm), np.array(maps))
        return cache[out]
    return get


@pytest.mark.parametrize("emit_maps", [False, True])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_k1_bf16_matches_jax_rolling_kernel(setup, jax_rolling, out,
                                            emit_maps):
    """Plain K1 at bf16 operands with the rank-K signal (f32 or bf16
    output, with and without the pair maps) vs JAX's rolling kernel with
    ``mul_dtype=bfloat16``, fed the planes that kernel draws; its map is
    also 1e-3..1e-2 RMS away from the port's f32 map, which shows the
    rounding happened."""
    tl, (want, want_maps) = setup["tl"], jax_rolling(out)
    _, tout, hold = OUT[out]
    got = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                       planes=setup["planes"], layout="vgb",
                       mul_dtype=BF, out_dtype=tout, emit_maps=emit_maps)
    if emit_maps:
        got, maps = got
        num_v, num_g = tl.rplan.n_dop, tl.rplan.n_gates
        assert maps.shape[0] == want_maps.shape[0] == want.shape[2] - 1
        _held(maps[:, :num_v, HALO:HALO + num_g], want_maps, 1e-4)
        if out == "f32":     # JAX's map is the unrounded one
            own = nr.pair_maps_plain(torch.from_numpy(want).permute(2, 0, 1))
            np.testing.assert_allclose(
                own[:, :num_v, HALO:HALO + num_g].numpy(), want_maps,
                rtol=1e-6)
    assert got.dtype == torch.complex64
    _held(got, want, hold)
    f32 = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                       planes=setup["planes"], layout="vgb").numpy()
    assert 1e-3 * _rms(want) <= _rms(got.numpy() - f32) <= 1e-2 * _rms(want)


@pytest.mark.parametrize("per_step,out", [("one", "f32"), ("all", "bf16")])
def test_k4_bf16_matches_jax_non_rolling_kernel(setup, per_step, out):
    """Plain K4 (``rolling=False``) at bf16 operands vs JAX's non-rolling
    in-kernel draw kernel at ``mul_dtype=bfloat16`` with 1 or B beams a
    grid step, f32 or bf16 output, fed the planes that kernel draws."""
    tl, l_np = setup["tl"], setup["l_np"]
    jout, tout, hold = OUT[out]
    k = 1 if per_step == "one" else l_np.shape[0]
    want = noise_rdm_pallas_gen(setup["seed"], setup["jplan"], l_np, A,
                                interpret=True, mul_dtype=jnp.bfloat16,
                                out_dtype=jout, rolling=False,
                                beams_per_step=k)
    got = nr.noise_rdm(tl.rplan, tl.l_factor, planes=setup["planes"],
                       layout="vgb", rolling=False, beams_per_step=k,
                       mul_dtype=BF, out_dtype=tout)
    _held(got, want, hold)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_planes_mode_bf16_matches_jax_planes_kernel(setup, out):
    """K1's planes mode (``variant="beams"``) at bf16 operands vs JAX's
    ``noise_rdm_pallas_planes(mul_dtype=bfloat16)``, fed the same numpy
    normal planes (rounded to bf16 on both sides), f32 or bf16 output."""
    jplan, l_np, tl = setup["jplan"], setup["l_np"], setup["tl"]
    jout, tout, hold = OUT[out]
    num_b, num_p = l_np.shape[0], tl.rplan.n_pulses
    rng = np.random.default_rng(29)
    xs = []
    for seg in jplan.segments:
        shape = (2, num_b, jplan.p_pad, segment_buffer_len(seg))
        x = (rng.standard_normal(shape) * np.sqrt(0.5)).astype(np.float32)
        x[..., :seg.pad_front] = 0.0
        xs.append(x)
    want = noise_rdm_pallas_planes(
        [jnp.asarray(x[0], jnp.bfloat16) for x in xs],
        [jnp.asarray(x[1], jnp.bfloat16) for x in xs], jplan, l_np,
        interpret=True, mul_dtype=jnp.bfloat16, out_dtype=jout)
    planes = [(torch.from_numpy(x[0, :, :num_p]),
               torch.from_numpy(x[1, :, :num_p])) for x in xs]
    got = nr.noise_rdm(tl.rplan, tl.l_factor, planes=planes, layout="vgb",
                       mul_dtype=BF, out_dtype=tout)
    _held(got, want, hold)
    # bf16 planes given as bf16 tensors: the same map, bit for bit
    planes16 = [(xr.to(BF), xi.to(BF)) for xr, xi in planes]
    assert torch.equal(got, nr.noise_rdm(tl.rplan, tl.l_factor,
                                         planes=planes16, layout="vgb",
                                         mul_dtype=BF, out_dtype=tout))


def test_gen_noise_planes_bf16_is_the_rounded_philox_planes(setup):
    """``gen_noise_planes(dtype=bfloat16)`` (K1c's bf16 mode; its plain
    version on the CPU) equals the f32 Philox planes rounded to nearest
    even, bit for bit, zeros before pad_front; no kernel launches."""
    plan = setup["tl"].rplan
    before = (nr.k1c_launch_count, nr.k1c_bf16_launch_count)
    got = nr.gen_noise_planes(plan, SEED, 5, device="cpu", dtype=BF)
    want = nr.philox_planes(plan, SEED, 5, device="cpu")
    assert (nr.k1c_launch_count, nr.k1c_bf16_launch_count) == before
    for seg, (a, b), (c, d) in zip(plan.segments, got, want):
        assert a.dtype == b.dtype == BF and a.shape == (5, plan.n_pulses,
                                                        seg.xlen)
        assert torch.equal(a, c.to(BF)) and torch.equal(b, d.to(BF))
        assert not a[..., :seg.pad_front].any()
    with pytest.raises(ValueError):
        nr.gen_noise_planes(plan, SEED, 5, device="cpu", dtype=torch.float16)


def test_k1c_bf16_layout_pads_rows_to_16_bytes(setup):
    """K1c's bf16 allocation: each plane [B, P, xlen padded to 8] (16-byte
    rows, the strip GEMM's TMA layout) on its own 256-byte boundary, in
    the segment order with its pad_front and xlen, without overlap; at f32
    the rows stay xlen long."""
    plan = setup["tl"].rplan
    table, spans, n = nr.k1c_layout(plan, 5, BF)
    ends = []
    for si, (seg, (r, i, size, xlen)) in enumerate(zip(plan.segments,
                                                       spans)):
        ld = nr.k1c_row_len(seg.xlen, BF)
        assert ld % 8 == 0 and seg.xlen <= ld < seg.xlen + 8
        assert nr.k1c_row_len(seg.xlen) == seg.xlen
        assert table[4 * si:4 * si + 4] == [seg.pad_front, seg.xlen, r, i]
        assert size == 5 * plan.n_pulses * ld and xlen == seg.xlen
        assert r % 128 == 0 and i % 128 == 0
        ends += [(r, r + size), (i, i + size)]
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] <= n < ends[-1][1] + 128


@pytest.mark.parametrize("with_signal", [False, True])
def test_bf16_draw_mode_is_planes_mode_and_k4_is_k1(setup, with_signal):
    """At bf16 operands: K1's draw mode equals its planes mode on the
    Philox planes (f32, or K1c's bf16 planes), and K4 (any beams a step)
    equals K1, bit for bit, with f32 and bf16 output."""
    tl = setup["tl"]
    plan, lmat = tl.rplan, tl.l_factor
    sig = setup["factors"] if with_signal else None
    for out in (torch.float32, BF):
        kw = dict(layout="bvg", mul_dtype=BF, out_dtype=out)
        k1 = nr.noise_rdm(plan, lmat, sig, seed=SEED, **kw)
        assert float(k1.abs().max()) > 0.0
        for planes in (nr.philox_planes(plan, SEED, 5, device="cpu"),
                       nr.gen_noise_planes(plan, SEED, 5, device="cpu",
                                           dtype=BF)):
            assert torch.equal(k1, nr.noise_rdm(plan, lmat, sig,
                                                planes=planes, **kw))
        for bps in (1, 5):
            assert torch.equal(k1, nr.noise_rdm(plan, lmat, sig, seed=SEED,
                                                rolling=False,
                                                beams_per_step=bps, **kw))


@pytest.mark.parametrize("num_k", [0, 2, 40])
def test_mix_plain_matches_jax_mix_vals(num_k):
    """``mix_plain`` on bf16 planes [5, 8, 64] with a bf16 L and K signal
    terms against radar_tpu/ops/pallas_rdm.py's ``_mix_vals`` (:159-172)
    plus the signal and the pair maps as its rolling kernel adds them
    (:447-478), on the same numpy inputs: map and maps within 1e-6 RMS."""
    num_b, num_v, num_g = 5, 8, 64
    rng = np.random.default_rng(num_k + 7)
    bf16 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(BF).float().numpy()
    cplx = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(
        np.complex64)
    mtr, mti = bf16(num_b, num_v, num_g), bf16(num_b, num_v, num_g)
    lr, li = bf16(num_b, num_b) * 0.5, bf16(num_b, num_b) * 0.5
    dv, pb, st = cplx(num_k, num_v), cplx(num_k, num_g), cplx(num_k, num_b)

    j = lambda x: jnp.asarray(x, jnp.bfloat16)
    yrv, yiv = _mix_vals(j(lr), j(li), j(mtr), j(mti))
    outers = [(dv.real[k][:, None] * pb.real[k][None, :]
               - dv.imag[k][:, None] * pb.imag[k][None, :],
               dv.real[k][:, None] * pb.imag[k][None, :]
               + dv.imag[k][:, None] * pb.real[k][None, :])
              for k in range(num_k)]
    want, mags = [], []
    for b in range(num_b):
        accr, acci = yrv[b], yiv[b]
        for k, (ar, ai) in enumerate(outers):
            sr, si = st.real[k, b], st.imag[k, b]
            accr = accr + (sr * ar - si * ai)
            acci = acci + (sr * ai + si * ar)
        want.append(np.asarray(accr) + 1j * np.asarray(acci))
        mags.append(jnp.sqrt(accr * accr + acci * acci))
    want = np.stack(want)
    want_maps = np.stack([np.asarray(mags[p] + mags[p + 1])
                          for p in range(num_b - 1)])

    signal = None if num_k == 0 else tuple(torch.from_numpy(x)
                                           for x in (dv, pb, st))
    y, maps = nr.mix_plain(
        torch.complex(torch.from_numpy(mtr), torch.from_numpy(mti)),
        torch.complex(torch.from_numpy(lr), torch.from_numpy(li)), signal,
        emit_maps=True)
    inner = maps[:, :num_v, HALO:HALO + num_g].numpy()
    assert _rms(y.numpy() - want) <= 1e-6 * _rms(want)
    assert _rms(inner - want_maps) <= 1e-6 * _rms(want_maps)

