"""PyTorch port: the banded-convolution white-noise PC study
(``radar_tpu_torch/studies/pallas_pc.py``, the plain version of kernel K8)
held against the JAX ``radar_tpu/studies/pallas_pc.py`` run in interpret
mode, and against the port's banded-matmul PC on the compact noise plan.

Tolerances: the plan's integers exact and its filter planes within 1e-7;
at float32 rtol 1e-5, atol 2e-4 (as tests/test_pallas.py: f32 sums of up
to 700 terms in another order); at bfloat16 the RMS of the difference
within 1e-4 of the RMS (same rounded operands, f32 sums in another order,
no intermediate rounding). The plain twin of the bfloat16 kernels' schedule
(staged planes, Toeplitz strips, one product per 128-gate block) is held
the same way, and the strips exactly. The kernel runs only on the card
(tests marked ``cuda``, in test_torch_cuda.py)."""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config.params import small_test_config as j_small
from radar_tpu.studies.pallas_pc import (make_pallas_pc_plan as j_plan,
                                         pulse_compress_noise_pallas)
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.ops.noise_rdm import (STRIP_BK, STRIP_BN, TF32_BK,
                                          round_mul, strip_tf32,
                                          toeplitz_strip)
from radar_tpu_torch.ops.pulse_compression import (compact_noise_plan,
                                                   make_matmul_plan,
                                                   pulse_compress_matmul,
                                                   to_device)
from radar_tpu_torch.studies import pallas_pc as ppc
from radar_tpu_torch.waveform.precompute import from_numpy


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(np.asarray(x, np.complex128)) ** 2)))


@pytest.fixture(scope="module")
def setup():
    jpre = j_precompute(j_small(channels=8, pulses=8))
    tpre = from_numpy(jpre._asdict())
    plan = ppc.make_pallas_pc_plan(tpre, device="cpu")
    rng = np.random.default_rng(0)
    shape = (3, 8, plan.s_compact)
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
         ).astype(np.complex64)
    return dict(jpre=jpre, tpre=tpre, plan=plan, z=z)


@pytest.mark.parametrize("tile", [512, 128])
def test_plan_geometry_matches_jax(setup, tile):
    want = j_plan(setup["jpre"], tile=tile)
    got = ppc.make_pallas_pc_plan(setup["tpre"], tile=tile, device="cpu")
    assert (got.s_compact, got.n_gates) == (want.s_compact, want.n_gates)
    assert len(got.segments) == len(want.segments) == 3
    for g, w in zip(got.segments, want.segments):
        for f in ("c0", "r_len", "pad_front", "pad_tail", "j_len", "tile",
                  "window"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("mr", "mi"):
            np.testing.assert_allclose(getattr(g, f).numpy(), getattr(w, f),
                                       rtol=0, atol=1e-7)
        assert g.window >= g.tile + g.taps - 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_jax_kernel(setup, dtype):
    """``pulse_compress_noise`` (plain on the CPU) vs JAX
    ``pulse_compress_noise_pallas(interpret=True)``, same multiply type."""
    jmd, tmd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    z = setup["z"]
    want = np.asarray(pulse_compress_noise_pallas(
        jnp.asarray(z), j_plan(setup["jpre"]), interpret=True,
        mul_dtype=jmd))
    before = ppc.launch_count
    got = ppc.pulse_compress_noise(torch.from_numpy(z), setup["plan"],
                                   mul_dtype=tmd)
    assert ppc.launch_count == before
    assert got.shape == want.shape and got.dtype == torch.complex64
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)
    else:
        assert _rms(got.numpy() - want) <= 1e-4 * _rms(want)
        f32 = ppc.pulse_compress_noise(torch.from_numpy(z), setup["plan"],
                                       mul_dtype=torch.float32).numpy()
        assert 1e-3 * _rms(want) <= _rms(got.numpy() - f32)


def test_matches_banded_matmul_plan(setup):
    """At float32 the study equals the port's banded-matmul PC on the
    compact noise plan (same compact sample layout)."""
    nplan, nlen = compact_noise_plan(make_matmul_plan(setup["tpre"]))
    assert nlen == setup["plan"].s_compact
    z = torch.from_numpy(setup["z"])
    want = pulse_compress_matmul(z.permute(1, 2, 0),
                                 to_device(nplan, "cpu")).permute(2, 0, 1)
    got = ppc.pulse_compress_noise(z, setup["plan"], mul_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=2e-4)


def test_arguments_are_checked(setup):
    z = torch.from_numpy(setup["z"])
    with pytest.raises(ValueError):
        ppc.pulse_compress_noise(z[..., 1:], setup["plan"])
    with pytest.raises(ValueError):
        ppc.pulse_compress_noise(z, setup["plan"], mul_dtype=torch.float16)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("tile", [512, 128])
def test_strip_reproduces_every_column_block(setup, tile, bn):
    """The plan's banded matrices are Toeplitz (zero off the band), so the
    strip S = M[:bn+lh-1, :bn] built from M's first column gives every
    bn-gate column block of M: M[n0 + k, n0 + n] = S[k, n]; S is zero in
    its padding rows."""
    plan = ppc.make_pallas_pc_plan(setup["tpre"], tile=tile, device="cpu")
    for seg in plan.segments:
        lh = seg.taps
        m = torch.complex(seg.mr, seg.mi)
        k, n = torch.meshgrid(torch.arange(m.shape[0]),
                              torch.arange(m.shape[1]), indexing="ij")
        band = (k >= n) & (k < n + lh)
        assert not bool(m[~band].abs().any())
        assert torch.equal(m[band], m[:lh, 0][(k - n)[band]])
        s = torch.complex(toeplitz_strip(seg.mr[:lh, 0], bn),
                          toeplitz_strip(seg.mi[:lh, 0], bn))
        assert s.shape[0] % STRIP_BK == 0 and s.shape[0] >= bn + lh - 1
        assert not bool(s[bn + lh - 1:].abs().any())
        for n0 in range(0, seg.tile, bn):
            assert torch.equal(m[n0:n0 + bn + lh - 1, n0:n0 + bn],
                               s[:bn + lh - 1])


@pytest.mark.parametrize("tile", [512, 128])
def test_cached_strip_is_the_rounded_f32_strip(setup, tile):
    """``SegSpec.strip`` (bfloat16, k contiguous) equals ``round_mul`` of
    the float32 strip M[:STRIP_BN+lh-1, :STRIP_BN] bit for bit."""
    plan = ppc.make_pallas_pc_plan(setup["tpre"], tile=tile, device="cpu")
    for seg in plan.segments:
        band = STRIP_BN + seg.taps - 1
        assert seg.strip.dtype == torch.bfloat16 and seg.strip.is_contiguous()
        assert seg.strip.shape[:2] == (2, STRIP_BN)
        for plane, m in zip(seg.strip, (seg.mr, seg.mi)):
            got = plane.T.float()
            assert torch.equal(got[:band], round_mul(m[:band, :STRIP_BN],
                                                     torch.bfloat16))
            assert not bool(got[band:].any())


def test_stage_layout_and_planes(setup):
    """K8's staged planes: each segment's buffer (zero history, its compact
    samples rounded once, zeros) at an 8-aligned column offset, widths
    multiples of 8 covering the row."""
    plan, z = setup["plan"], torch.from_numpy(setup["z"])
    cols, ld = plan.stage
    assert plan.stage == ppc.stage_layout(plan.segments)
    assert ld == sum(w for _, w in cols) and ld % 8 == 0
    xr, xi = ppc.stage_planes_plain(z, plan)
    assert xr.shape == (z.shape[0] * z.shape[1], ld)
    assert xr.dtype == torch.bfloat16
    zf = z.reshape(xr.shape[0], -1)
    for seg, (off, width) in zip(plan.segments, cols):
        assert off % 8 == 0 and width % 8 == 0
        assert width - 8 < seg.pad_front + seg.r_len <= width
        a = off + seg.pad_front
        want = zf[:, seg.c0:seg.c0 + seg.r_len]
        assert torch.equal(xi[:, a:a + seg.r_len], want.imag.to(xi.dtype))
        assert torch.equal(xr[:, a:a + seg.r_len], want.real.to(xr.dtype))
        assert not bool(xr[:, off:a].float().any())
        assert not bool(xr[:, a + seg.r_len:off + width].float().any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_strip_schedule_matches_jax_kernel(setup, dtype):
    """The plain twin of the bf16 kernels' schedule (stage, then strips per
    128-gate block) vs JAX ``pulse_compress_noise_pallas(interpret=True)``,
    as ``test_matches_jax_kernel``."""
    jmd, tmd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    z = setup["z"]
    want = np.asarray(pulse_compress_noise_pallas(
        jnp.asarray(z), j_plan(setup["jpre"]), interpret=True,
        mul_dtype=jmd))
    got = ppc.pulse_compress_noise_strips(torch.from_numpy(z), setup["plan"],
                                          mul_dtype=tmd)
    assert got.shape == want.shape and got.dtype == torch.complex64
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)
    else:
        assert _rms(got.numpy() - want) <= 1e-4 * _rms(want)


def _ragged_precomp(lh, gates, seed=1, unit=False):
    """A stand-in for ``precompute``'s output with chosen filter lengths and
    segment gates (what ``make_pallas_pc_plan`` reads); random complex taps,
    or all ones with ``unit``."""
    rng = np.random.default_rng(seed)
    taps = [np.ones(n, np.complex128) if unit else
            rng.normal(size=n) + 1j * rng.normal(size=n) for n in lh]
    g1, g2, g3 = gates
    return SimpleNamespace(gate_splits=(g1, g2, g3), n_total_gate=g1 + g2 + g3,
                           fir_delay=lh[0] // 2, mf_narrow=taps[0],
                           mf_medium_win=taps[1], mf_long_win=taps[2])


@pytest.mark.parametrize("bn", [64, 128])
def test_strip_schedule_on_ragged_edges(bn):
    """The twin equals the plain version (f32) where every edge is ragged:
    rows not a multiple of 128, gates not a multiple of the block, filters
    shorter and longer than it, a segment narrower than one block."""
    pre = _ragged_precomp((5, 90, 300), (37, 300, 700))
    plan = ppc.make_pallas_pc_plan(pre, tile=128, device="cpu")
    rng = np.random.default_rng(4)
    shape = (3, 45, plan.s_compact)
    z = torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape)
                          ).astype(np.complex64))
    want = ppc.pulse_compress_noise_plain(z, plan, torch.float32)
    got = ppc.pulse_compress_noise_strips(z, plan, torch.float32, bn=bn)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("tile", [512, 128])
def test_plan_carries_the_split_strip(setup, tile):
    """``SegSpec.strip_tf32`` (the f32 kernels' strip: re_hi, re_lo, im_hi,
    im_lo, k contiguous) equals ``noise_rdm.strip_tf32`` of the segment's
    filter planes bit for bit; its hi + lo parts give the f32 strip within
    2^-21 of each value, and its hi parts are TF32 values."""
    plan = ppc.make_pallas_pc_plan(setup["tpre"], tile=tile, device="cpu")
    for seg in plan.segments:
        st = seg.strip_tf32
        assert st.dtype == torch.float32 and st.is_contiguous()
        assert st.shape[:2] == (4, STRIP_BN) and st.shape[2] % TF32_BK == 0
        assert torch.equal(st, strip_tf32(seg.mr, seg.mi, seg.taps))
        for hi, lo, m in ((st[0], st[1], seg.mr), (st[2], st[3], seg.mi)):
            want = toeplitz_strip(m[:seg.taps, 0], bk=TF32_BK).T
            assert float((hi + lo - want).abs().max()) <= 2.0 ** -21 * float(
                want.abs().max())
            assert not bool((hi.view(torch.int32) & 0x1FFF).any())


def test_stage_planes_f32(setup):
    """K8's staged planes at f32 (the 3xTF32 GEMM's input): the same layout
    as at bf16 (8-column widths keep rows 16-byte aligned), each segment's
    compact samples exactly, zeros before and after them."""
    plan, z = setup["plan"], torch.from_numpy(setup["z"])
    cols, ld = plan.stage
    xr, xi = ppc.stage_planes_plain(z, plan, dtype=torch.float32)
    assert xr.dtype == torch.float32 and xr.shape == (z.shape[0] * z.shape[1],
                                                       ld)
    assert ld % 4 == 0 and all(off % 4 == 0 for off, _ in cols)
    zf = z.reshape(xr.shape[0], -1)
    for seg, (off, width) in zip(plan.segments, cols):
        a = off + seg.pad_front
        want = zf[:, seg.c0:seg.c0 + seg.r_len]
        assert torch.equal(xr[:, a:a + seg.r_len], want.real)
        assert torch.equal(xi[:, a:a + seg.r_len], want.imag)
        assert not bool(xr[:, off:a].any() or xi[:, off:a].any())
        assert not bool(xr[:, a + seg.r_len:off + width].any())
        assert not bool(xi[:, a + seg.r_len:off + width].any())


def test_tf32_schedule_matches_jax_kernel(setup):
    """The plain twin of K8's f32 kernels (staged f32 planes, 3xTF32 on the
    strips: hi*hi + (hi*lo + lo*hi)) vs JAX
    ``pulse_compress_noise_pallas(interpret=True, mul_dtype=f32)``: RMS of
    the difference within 1e-5 of the RMS (the TF32 splits leave ~2^-21 a
    product; f32 sums in another order), and against the port's plain
    version the same."""
    z = setup["z"]
    want = np.asarray(pulse_compress_noise_pallas(
        jnp.asarray(z), j_plan(setup["jpre"]), interpret=True,
        mul_dtype=jnp.float32))
    got = ppc.pulse_compress_noise_tf32(torch.from_numpy(z), setup["plan"])
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert _rms(got.numpy() - want) <= 1e-5 * _rms(want)
    plain = ppc.pulse_compress_noise_plain(torch.from_numpy(z),
                                           setup["plan"], torch.float32)
    assert _rms(got.numpy() - plain.numpy()) <= 1e-5 * _rms(want)


def test_tf32_schedule_on_ragged_edges():
    """The 3xTF32 twin equals the plain version (f32, 1e-5 RMS) where every
    edge is ragged, and exactly on inputs whose every sum is exact: unit
    filters and integers plus odd multiples of 2^-12 (so each value's TF32
    lo part is nonzero and the correction pass carries it)."""
    pre = _ragged_precomp((5, 90, 300), (37, 300, 700))
    plan = ppc.make_pallas_pc_plan(pre, tile=128, device="cpu")
    rng = np.random.default_rng(5)
    shape = (3, 45, plan.s_compact)
    z = torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(size=shape)
                          ).astype(np.complex64))
    want = ppc.pulse_compress_noise_plain(z, plan, torch.float32)
    got = ppc.pulse_compress_noise_tf32(z, plan)
    assert _rms((got - want).numpy()) <= 1e-5 * _rms(want.numpy())

    ones = ppc.make_pallas_pc_plan(_ragged_precomp((5, 90, 300),
                                                   (37, 300, 700), unit=True),
                                   tile=128, device="cpu")
    ints = lambda: (rng.integers(-3, 4, size=shape)
                    + (2 * rng.integers(-3, 4, size=shape) + 1) * 2.0 ** -12)
    z = torch.from_numpy((ints() + 1j * ints()).astype(np.complex64))
    want = ppc.pulse_compress_noise_plain(z, ones, torch.float32)
    got = ppc.pulse_compress_noise_tf32(z, ones)
    assert float(want.abs().max()) > 0.0 and torch.equal(got, want)
