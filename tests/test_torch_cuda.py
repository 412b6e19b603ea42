"""PyTorch port on the card: kernels K1, K1c, K2, K3, K4, K5, K6, K7, K8,
K9 and K10 against their plain PyTorch versions (K6 on a ring of two ranks
sharing the card, through ``run_ranks``; K8 at bf16, the staging kernel
and the strip GEMM, and at f32, the staging kernel and the 3xTF32 strip
GEMM, also at ragged shapes and with probe inputs; K7's bf16 draw mode,
the strip GEMM with drawing producers, against its planes mode; K1, K2,
K4, K10, K7 and K9 also at a zero-padded Doppler FFT, ``mtd_fft_len`` 40
and 64 on 32 pulses), the
perf-config frame (each noise-RDM route) and the reference-stream frame
through the kernels against the plain path on the CPU, a small SNR
sweep, and the connected-labels kernel and the frame tail's CUDA graph
against their eager versions. Marked ``cuda``; each test skips without
an NVIDIA GPU.

This file imports neither JAX nor ``radar_tpu``, so it also runs where
JAX is not installed (the suite's conftest.py needs JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radar_tpu_torch.config.params import (CfarParams, PERF_OVERRIDES,
                                           small_test_config)
from radar_tpu_torch.ops import awgn as k5
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import precompute

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
CFG = small_test_config().replace(**{**PERF_OVERRIDES,
                                     "matmul_precision": "f32"})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    return torch.device("cuda")


def _rows(res):
    t = res.targets
    ok = t.valid.cpu().numpy()
    return np.stack([getattr(t, f).cpu().numpy()[ok] for f in
                     ("range_m", "velocity_ms", "angle_deg", "power")], 1)


def _assert_same_rows(a, b, rtol):
    """Rows of ``a`` paired with the nearest row of ``b`` in (range,
    velocity) (split targets can share a range), then compared."""
    assert a.shape == b.shape
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    assert len(set(pair.tolist())) == len(pair)
    np.testing.assert_allclose(a, b[pair], rtol=rtol)


@pytest.mark.cuda
def test_k1_matches_plain_on_card(cuda_device):
    """K1 in draw mode equals K1 in planes mode fed the plain Philox
    planes bit for bit, and the plain version to f32 reassociation (RMS of
    the difference within 1e-5 of the RMS)."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    factors = lr.signal_factors(TargetBatch.make(*TARGETS))
    seed = (3, 5)
    planes = nr.philox_planes(lr.rplan, seed, 5, device=cuda_device)
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, factors)
    drawn = nr.noise_rdm(lr.rplan, lr.l_factor, factors, seed=seed,
                         layout="bvg")
    fed = nr.noise_rdm(lr.rplan, lr.l_factor, factors, planes=planes,
                       layout="bvg")
    torch.cuda.synchronize()
    assert torch.equal(drawn, fed)
    rms = lambda x: float(x.abs().pow(2).mean().sqrt())
    assert rms(drawn - ref) <= 1e-5 * rms(ref)


@pytest.mark.cuda
def test_k2_matches_plain_on_card(cuda_device):
    """K2 vs its plain version: mask and row counts identical."""
    rng = np.random.default_rng(4)
    maps = rng.exponential(size=(5, 100, 1500)).astype(np.float32)
    maps[rng.integers(0, 5, 40), rng.integers(20, 80, 40),
         rng.integers(20, 1480, 40)] += 60.0
    tp = ck.pad_maps_qvg(torch.from_numpy(maps).to(cuda_device))
    for method in ("GOCA", "SOCA", "CA"):
        params = CfarParams(method=method)
        mask, rc = ck.goca_cfar_qvg(tp, params, 1500, 100)
        mask_p, rc_p = ck.goca_cfar_qvg_plain(tp, params, 1500, 100)
        torch.cuda.synchronize()
        assert torch.equal(mask, mask_p) and torch.equal(rc, rc_p)
        assert int(mask.sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("accelerator", [False, True])
def test_frame_on_card_matches_cpu(cuda_device, accelerator):
    """Same seed through K1 and K2 on the card and through the plain
    versions on the CPU, both at interpret mode's dtypes (K1's f32
    kernels) or both at the accelerator's (K1 at bf16 operands): same
    final targets within rtol 1e-4 (1e-3 at bf16: the noise's bf16
    roundings come after sums taken in other orders)."""
    tb = TargetBatch.make(*TARGETS)
    kw = dict(accelerator_dtypes=accelerator)
    a = make_frame_processor(CFG, device=cuda_device, **kw)(5, tb)
    b = make_frame_processor(CFG, device="cpu", **kw)(5, tb)
    assert int(a.num_final) == int(b.num_final) >= 2
    _assert_same_rows(_rows(a), _rows(b), rtol=1e-3 if accelerator else 1e-4)


@pytest.mark.cuda
def test_k3_matches_plain_on_card(cuda_device):
    """K3 vs its plain version: mask and threshold identical, G not a
    multiple of the 128-gate tile."""
    rng = np.random.default_rng(6)
    mag = rng.exponential(size=(5, 100, 1500)).astype(np.float32)
    mag[rng.integers(0, 5, 40), rng.integers(20, 80, 40),
        rng.integers(20, 1480, 40)] += 60.0
    t = torch.from_numpy(mag).to(cuda_device)
    for method in ("GOCA", "SOCA", "CA"):
        params = CfarParams(method=method)
        mask, thr = ck.goca_cfar_2d_fused(t, params)
        mask_p, thr_p = ck.goca_cfar_2d_fused_plain(t, params)
        torch.cuda.synchronize()
        assert torch.equal(mask, mask_p) and torch.equal(thr, thr_p)
        assert int(mask.sum()) >= 10


@pytest.mark.cuda
def test_k5_matches_plain_on_card(cuda_device):
    """K5 vs its plain version (same Philox uniforms; log/sin/cos to a few
    ulps: max abs error 1e-5), its rail statistics over 6.2e6 samples, an
    odd sample count and signal pass-through."""
    x = torch.zeros((64, 5819, 16), dtype=torch.complex64,
                    device=cuda_device)
    y = k5.awgn(x, (5, 9))
    y_p = k5.awgn_plain(x, (5, 9))
    torch.cuda.synchronize()
    assert float((y - y_p).abs().max()) <= 1e-5
    re, im = y.real.double().reshape(-1), y.imag.double().reshape(-1)
    for rail in (re, im):
        var = float(rail.var())
        assert abs(float(rail.mean())) < 5e-3 and abs(var - 0.5) < 5e-3
        c = rail - rail.mean()
        assert abs(float((c**4).mean()) / var**2 - 3.0) < 5e-2
        assert abs(float((c[1:] * c[:-1]).mean()) / var) < 5e-3
    assert abs(float((re * im).mean())) < 5e-3
    odd = torch.zeros(7, dtype=torch.complex64, device=cuda_device)
    assert float((k5.awgn(odd, (5, 9)) - y.reshape(-1)[:7]).abs().max()) \
        <= 1e-5
    sig = torch.full_like(x, 3.0 - 2.0j)
    assert float((k5.awgn(sig, (5, 9)) - y - sig).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_reference_frame_on_card_matches_cpu(cuda_device):
    """The reference stream through K5 and K3 on the card and through the
    plain versions on the CPU, same seed: same final targets within rtol
    1e-4."""
    cfg = small_test_config().replace(noise_impl="pallas")
    tb = TargetBatch.make(*TARGETS)
    k3_before, k5_before = ck.k3_launch_count, k5.launch_count
    a = make_frame_processor(cfg, device=cuda_device)(5, tb)
    assert ck.k3_launch_count > k3_before and k5.launch_count > k5_before
    b = make_frame_processor(cfg, device="cpu")(5, tb)
    assert int(a.num_final) == int(b.num_final) >= 2
    _assert_same_rows(_rows(a), _rows(b), rtol=1e-4)


@pytest.mark.cuda
def test_k1c_matches_philox_planes_on_card(cuda_device):
    """K1c writes the planes draw mode draws, bit for bit equal to the
    plain Philox planes; planes mode on them equals draw mode."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    seed = (7, 11)
    before = nr.k1c_launch_count
    got = nr.gen_noise_planes(lr.rplan, seed, 5, device=cuda_device)
    want = nr.philox_planes(lr.rplan, seed, 5, device=cuda_device)
    torch.cuda.synchronize()
    assert nr.k1c_launch_count == before + 1
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)
    fed = nr.noise_rdm(lr.rplan, lr.l_factor, planes=got, layout="bvg")
    drawn = nr.noise_rdm(lr.rplan, lr.l_factor, seed=seed, layout="bvg")
    torch.cuda.synchronize()
    assert torch.equal(fed, drawn)


@pytest.mark.cuda
def test_k1c_one_launch_at_ragged_shapes_on_card(cuda_device):
    """K1c at ragged plane sizes (xlen not a multiple of 4, an odd number
    of pulse rows, pad_front moved off its tile) writes every segment in
    one launch into one allocation, bit for bit equal to the plain Philox
    planes segment by segment."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    segs = tuple(sg._replace(window=sg.window + 1 + 2 * i,
                             pad_front=sg.pad_front + 5 + i)
                 for i, sg in enumerate(lr.rplan.segments))
    plan = lr.rplan._replace(segments=segs, n_pulses=7)
    assert all(sg.xlen % 4 for sg in segs)
    for seed in ((7, 11), (0xFFFFFFFF, 3)):
        before = nr.k1c_launch_count
        got = nr.gen_noise_planes(plan, seed, 3, device=cuda_device)
        want = nr.philox_planes(plan, seed, 3, device=cuda_device)
        torch.cuda.synchronize()
        assert nr.k1c_launch_count == before + 1
        base = got[0][0].untyped_storage().data_ptr()
        for (a, b), (c, d), sg in zip(got, want, segs):
            assert a.shape == (3, 7, sg.xlen) and a.is_contiguous()
            assert a.untyped_storage().data_ptr() == base
            assert torch.equal(a, c) and torch.equal(b, d)
            assert not a[..., :sg.pad_front].any()
            assert a[..., sg.pad_front:].abs().min() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("beams_per_step", [1, 2, 5])
def test_k4_matches_plain_on_card(cuda_device, beams_per_step):
    """K4 (K1's 3xTF32 GEMMs, the PC's data drawn in the block, 1, 2 and
    all 5 beams walked a block) vs its plain version (RMS of the difference
    within 1e-5 of the RMS) and within 2^-7 of the largest value of K1 on
    the same seed; one K4 call and one K4 PC launch."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    factors = lr.signal_factors(TargetBatch.make(*TARGETS))
    seed = (3, 5)
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor,
                             nr.philox_planes(lr.rplan, seed, 5,
                                              device=cuda_device), factors)
    before = (nr.k4_launch_count, nr.k4_pc_launch_count)
    got = nr.noise_rdm(lr.rplan, lr.l_factor, factors, seed=seed,
                       layout="bvg", rolling=False,
                       beams_per_step=beams_per_step)
    k1 = nr.noise_rdm(lr.rplan, lr.l_factor, factors, seed=seed,
                      layout="bvg")
    torch.cuda.synchronize()
    assert (nr.k4_launch_count, nr.k4_pc_launch_count) == (before[0] + 1,
                                                           before[1] + 1)
    rms = lambda x: float(x.abs().pow(2).mean().sqrt())
    assert rms(got - ref) <= 1e-5 * rms(ref)
    assert float((got - k1).abs().max()) <= 2.0 ** -7 * float(k1.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("impl,dist", [("xla", "normal"),
                                       ("pallas", "uniform")])
def test_lowrank_route_on_card_matches_cpu(cuda_device, impl, dist):
    """The xla and pallas routes on the card and on the CPU, fed the same
    injected noise, at interpret mode's dtypes (f32 kernels): same final
    targets within rtol 1e-4."""
    cfg = CFG.replace(noise_rdm_impl=impl, noise_dist=dist)
    tb = TargetBatch.make(*TARGETS)
    cpu = make_frame_processor(cfg, device="cpu")
    card = make_frame_processor(cfg, device=cuda_device,
                                accelerator_dtypes=False)
    if impl == "xla":
        z = cpu.stages.gen_noise(5)
        a, b = card(0, tb, noise=z.to(cuda_device)), cpu(0, tb, noise=z)
    else:
        planes = cpu.stages.noise_planes(5)
        on_card = [(x.to(cuda_device), y.to(cuda_device)) for x, y in planes]
        a, b = card(0, tb, noise_planes=on_card), cpu(0, tb,
                                                      noise_planes=planes)
    assert int(a.num_final) == int(b.num_final) >= 2
    _assert_same_rows(_rows(a), _rows(b), rtol=1e-4)


@pytest.mark.cuda
def test_snr_sweep_on_card(cuda_device):
    """A small perf-config sweep through K1 on the card: Pd rises."""
    from radar_tpu_torch.pipeline.montecarlo import snr_sweep

    cfg = small_test_config(channels=8, pulses=32).replace(**PERF_OVERRIDES)
    before = nr.launch_count
    res = snr_sweep(cfg, snr_db_vector=[-42.0, 25.0], num_trials=6,
                    truth=TargetBatch.make([3000.0], [10.0], [10.0], [0.0]),
                    device=cuda_device)
    assert nr.launch_count >= before + 12
    assert res.detection_probability[0] <= 0.3
    assert res.detection_probability[-1] >= 0.9


_MUL = {"f32": torch.float32, "bf16": torch.bfloat16}
_COUNTER = {"resident": "k10_launch_count", "stacked": "k7_launch_count",
            "allbeams": "k9_launch_count"}


def _rms(x) -> float:
    return float(x.abs().pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["resident", "stacked", "allbeams"])
def test_rdm_variants_match_plain_on_card(cuda_device, variant, dtype):
    """K10, K7 and K9 (the planes kernel's schedules) vs the plain version
    at the same multiply type: RMS of the difference within 1e-5 of the RMS
    at f32; at bf16 within 3e-4: f32 sums in another order (on the tensor
    cores, not even IEEE-sequential) move a few intermediates across a bf16
    rounding boundary, 2^-8 on that element, while a missing rounding point
    would cost >= 1e-3. At f32 also vs K1 planes mode."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    md = _MUL[dtype]
    planes = nr.philox_planes(lr.rplan, (3, 5), 5, device=cuda_device)
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, mul_dtype=md)
    before = getattr(nr, _COUNTER[variant])
    got = nr.noise_rdm(lr.rplan, lr.l_factor, planes=planes, variant=variant,
                       mul_dtype=md, layout="bvg")
    torch.cuda.synchronize()
    assert getattr(nr, _COUNTER[variant]) == before + 1
    assert _rms(got - ref) <= (1e-5 if dtype == "f32" else 3e-4) * _rms(ref)
    if dtype == "f32":
        k1 = nr.noise_rdm(lr.rplan, lr.l_factor, planes=planes, layout="bvg")
        assert _rms(got - k1) <= 1e-5 * _rms(k1)


@pytest.mark.cuda
def test_k7_draw_mode_and_k10_bf16_out_on_card(cuda_device):
    """K7 on its own Philox draws with the rank-K signal equals K7 on the
    plain Philox planes bit for bit and the plain version to 1e-5 RMS; K10
    with bf16 output planes within 6e-4 RMS of its plain version (twice
    the bf16 bound: the output rounding turns a flip into an output
    ulp)."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    factors = lr.signal_factors(TargetBatch.make(*TARGETS))
    planes = nr.philox_planes(lr.rplan, (3, 5), 5, device=cuda_device)
    drawn = nr.noise_rdm(lr.rplan, lr.l_factor, factors, seed=(3, 5),
                         stacked=True, layout="bvg")
    fed = nr.noise_rdm(lr.rplan, lr.l_factor, factors, planes=planes,
                       variant="stacked", layout="bvg")
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, factors)
    bf = torch.bfloat16
    k10 = nr.noise_rdm(lr.rplan, lr.l_factor, planes=planes,
                       variant="resident", mul_dtype=bf, out_dtype=bf,
                       layout="bvg")
    ref16 = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, mul_dtype=bf,
                               out_dtype=bf)
    torch.cuda.synchronize()
    assert torch.equal(drawn, fed)
    assert _rms(drawn - ref) <= 1e-5 * _rms(ref)
    assert torch.equal(k10, nr.round_mul(k10, bf))
    assert _rms(k10 - ref16) <= 6e-4 * _rms(ref16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_matches_plain_on_card(cuda_device, dtype):
    """K8 (banded PC of the compact cube) vs its plain version (RMS within
    1e-5 of the RMS at f32, 1e-4 at bf16) and, at f32, vs the banded-matmul
    PC on the compact noise plan (rtol 1e-5, atol 2e-4)."""
    from radar_tpu_torch.ops.pulse_compression import (
        compact_noise_plan, make_matmul_plan, pulse_compress_matmul,
        to_device)
    from radar_tpu_torch.studies import pallas_pc as ppc

    cfg = small_test_config(channels=8, pulses=8)
    pre = precompute(cfg)
    plan = ppc.make_pallas_pc_plan(pre, device=cuda_device)
    rng = np.random.default_rng(0)
    shape = (3, 8, plan.s_compact)
    z = torch.from_numpy((rng.normal(size=shape)
                          + 1j * rng.normal(size=shape)).astype(np.complex64))
    md = _MUL[dtype]
    before = ppc.launch_count
    got = ppc.pulse_compress_noise(z.to(cuda_device), plan, mul_dtype=md)
    ref = ppc.pulse_compress_noise_plain(z.to(cuda_device), plan,
                                         mul_dtype=md)
    torch.cuda.synchronize()
    assert ppc.launch_count == before + 1
    assert _rms(got - ref) <= (1e-5 if dtype == "f32" else 1e-4) * _rms(ref)
    if dtype == "f32":
        nplan, _ = compact_noise_plan(make_matmul_plan(pre))
        want = pulse_compress_matmul(z.permute(1, 2, 0),
                                     to_device(nplan, "cpu")).permute(2, 0, 1)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=2e-4)


def _ragged_plan(lh, gates, device, seed=1, unit=False):
    """A K8 plan with chosen filter lengths and segment gates (random
    complex taps, or all ones with ``unit``), from a stand-in for
    ``precompute``'s output (what ``make_pallas_pc_plan`` reads)."""
    from types import SimpleNamespace

    from radar_tpu_torch.studies import pallas_pc as ppc

    rng = np.random.default_rng(seed)
    taps = [np.ones(n, np.complex128) if unit else
            rng.normal(size=n) + 1j * rng.normal(size=n) for n in lh]
    g1, g2, g3 = gates
    pre = SimpleNamespace(gate_splits=(g1, g2, g3), n_total_gate=g1 + g2 + g3,
                          fir_delay=lh[0] // 2, mf_narrow=taps[0],
                          mf_medium_win=taps[1], mf_long_win=taps[2])
    return ppc.make_pallas_pc_plan(pre, tile=128, device=device)


def _cube(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).astype(np.complex64)).to(device)


# every ragged edge of the strip GEMM: 135 rows (not a multiple of 128),
# gates 37 (fewer than a 128-gate block), 300 and 700 (not multiples of
# 128), filters of 5 taps and of 90 and 300 (shorter and longer than a
# block), segments starting at odd gates (37, 337)
RAGGED = ((5, 90, 300), (37, 300, 700), (3, 45))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "ragged"])
def test_k8_strip_gemm_matches_plain_on_card(cuda_device, shape):
    """K8 at bf16 (staging kernel + strip GEMM) vs its plain version and the
    plain twin of its schedule: RMS of the difference within 1e-4 of the
    RMS (the same rounded operands, f32 sums in another order); each of its
    launch counters moves once."""
    from radar_tpu_torch.studies import pallas_pc as ppc

    if shape == "small":
        plan = ppc.make_pallas_pc_plan(
            precompute(small_test_config(channels=8, pulses=8)),
            device=cuda_device)
        bp = (3, 8)
    else:
        plan = _ragged_plan(*RAGGED[:2], cuda_device)
        bp = RAGGED[2]
    z = _cube(bp + (plan.s_compact,), 0, cuda_device)
    before = (ppc.launch_count, ppc.stage_launch_count,
              nr.strip_pc_launch_count)
    got = ppc.pulse_compress_noise(z, plan)
    torch.cuda.synchronize()
    assert (ppc.launch_count, ppc.stage_launch_count,
            nr.strip_pc_launch_count) == tuple(n + 1 for n in before)
    ref = ppc.pulse_compress_noise_plain(z, plan)
    twin = ppc.pulse_compress_noise_strips(z, plan)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rms(got - ref) <= 1e-4 * _rms(ref)
    assert _rms(got - twin) <= 1e-4 * _rms(ref)


@pytest.mark.cuda
def test_k8_delta_and_one_tap_probes_on_card(cuda_device):
    """Inputs that locate layout faults, held exactly (every output is one
    bf16 product with 1, the other terms 0): a unit delta in every row
    recovers the rounded filter at its place, and one-tap unit filters
    recover the rounded input."""
    from radar_tpu_torch.studies import pallas_pc as ppc

    plan = _ragged_plan(*RAGGED[:2], cuda_device)
    num_b, num_p = RAGGED[2]
    z = torch.zeros((num_b, num_p, plan.s_compact), dtype=torch.complex64,
                    device=cuda_device)
    pos = torch.arange(num_b * num_p, device=cuda_device) * 7 % plan.s_compact
    z.view(-1, plan.s_compact)[torch.arange(num_b * num_p), pos] = 1.0
    got = ppc.pulse_compress_noise(z, plan)
    ref = ppc.pulse_compress_noise_plain(z, plan)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0.0 and torch.equal(got, ref)

    one = _ragged_plan((1, 1, 1), RAGGED[1], cuda_device, unit=True)
    z = _cube((num_b, num_p, one.s_compact), 3, cuda_device)
    got = ppc.pulse_compress_noise(z, one)
    ref = ppc.pulse_compress_noise_plain(z, one)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["stacked", "allbeams"])
def test_k7_k9_planes_pc_runs_the_strip_gemm_on_card(cuda_device, variant):
    """At bf16 the planes-mode PC of K7 and K9 is one strip-GEMM launch and
    the map holds 3e-4 RMS against the plain version; f32 runs K1's GEMMs
    and K7's draw mode the strip GEMM's draw mode, counted apart (the
    planes-mode strip counter stays)."""
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    planes = nr.philox_planes(lr.rplan, (3, 5), 5, device=cuda_device)
    bf = torch.bfloat16
    before = nr.strip_pc_launch_count
    got = nr.noise_rdm(lr.rplan, lr.l_factor, planes=planes, variant=variant,
                       mul_dtype=bf, layout="bvg")
    torch.cuda.synchronize()
    assert nr.strip_pc_launch_count == before + 1
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, mul_dtype=bf)
    assert _rms(got - ref) <= 3e-4 * _rms(ref)
    drawn = nr.strip_pc_draw_launch_count
    nr.noise_rdm(lr.rplan, lr.l_factor, planes=planes, variant=variant,
                 layout="bvg")
    nr.noise_rdm(lr.rplan, lr.l_factor, seed=(3, 5), stacked=True,
                 mul_dtype=bf, layout="bvg")
    torch.cuda.synchronize()
    assert nr.strip_pc_launch_count == before + 1
    assert nr.strip_pc_draw_launch_count == drawn + 1


@pytest.mark.cuda
def test_k6_matches_plain_on_card(cuda_device):
    """K6 on a ring of two ranks on the card against its plain versions
    (the batch_isend_irecv ring, and its ``cat`` + zero pad for the
    overlap-save route), bit for bit: complex64 rows whose 16-byte
    alignment alternates, float32 with aligned rows, float32 whose source
    and destination rows differ in alignment (4-byte copies), and complex64
    at a full frame's row width (13 x 332 rows, 1455 samples a shard, halo
    699, nfft 4096); six rounds of fresh data each, each an exchange through
    the [rows, halo] contract and one through the overlap-save route (both
    receive slots, six times each), one push and one fill launch per
    exchange."""
    from radar_tpu_torch.parallel import dryrun
    from radar_tpu_torch.parallel.multihost import run_ranks

    cases = [(37, 101, 33, torch.complex64, 160),
             (64, 256, 16, torch.float32, 288),
             (5, 19, 6, torch.float32, 27),
             (4316, 1455, 699, torch.complex64, 4096)]
    for out in run_ranks(dryrun.k6_check, 2, cases, device="cuda",
                         timeout=300):
        assert all(out["equal"]) and len(out["equal"]) == 6 * len(cases)
        assert all(out["os_equal"]) and len(out["os_equal"]) == 24
        assert out["launches"] == out["fills"] == [12] * len(cases)


@pytest.mark.cuda
def test_k6_refuses_another_stream_and_slot_writes(cuda_device):
    """A one-rank exchange on the card (its halo the causal edge's zeros):
    the overlap-save input is [zeros | x | zeros]; a call under a stream
    other than the one current when the exchange was built raises, as does
    a fill of a tensor of another shape, and a call after a write into the
    returned view of the receive slot (which would corrupt its zero
    columns for every later call)."""
    from radar_tpu_torch.parallel.mesh import make_mesh
    from radar_tpu_torch.parallel.pallas_ring import halo_right_permute

    mesh = make_mesh(device="cuda")
    x = torch.randn((6, 20), dtype=torch.complex64, device=cuda_device)
    with halo_right_permute(mesh, 6, 20, 5, dtype=torch.complex64,
                            nfft=32) as ex:
        want = torch.nn.functional.pad(x, (5, 7))
        assert torch.equal(ex.overlap_save_input(x), want)
        with torch.cuda.stream(torch.cuda.Stream()):
            with pytest.raises(RuntimeError, match="stream"):
                ex.overlap_save_input(x)
        ex.push(x)
        with pytest.raises(ValueError, match="the exchange takes"):
            ex.fill(x[:, :19])
        assert torch.equal(ex.fill(x), want)
        assert torch.equal(ex(x), torch.zeros_like(x[:, :5]))
        ex.overlap_save_input(x)[:, 0] = 1
        with pytest.raises(RuntimeError, match="read-only"):
            ex.overlap_save_input(x)
        ex.check()


@pytest.mark.cuda
def test_k6_timeout_raises_instead_of_hanging(cuda_device):
    """A rank whose neighbour never exchanges raises after K6's bounded
    wait, naming the rank and the call."""
    import time

    from radar_tpu_torch.parallel import dryrun
    from radar_tpu_torch.parallel.multihost import run_ranks

    t0 = time.monotonic()
    msg = run_ranks(dryrun.k6_timeout, 2, 1.0, device="cuda",
                    timeout=300)[0]
    assert "timed out" in msg and "rank 0" in msg and "sequence 1" in msg
    assert time.monotonic() - t0 < 120


# K1 at ragged shapes: 5 beams x 37 pulses (rows and pulses not multiples
# of the GEMMs' 128 and 4), gates 37/300/700 (not multiples of 128), taps
# 5/90/300, 41 Doppler bins
K1_RAGGED = ((5, 90, 300), (37, 300, 700), 5, 37, 41)


def _k1_plan(device, num_v=None, lh=K1_RAGGED[0], unit=False,
             tf32_taps=False, seed=2, lane=128, num_p=K1_RAGGED[3]):
    """A noise-RDM plan at K1_RAGGED's gates and ``num_p`` pulses (K1_RAGGED's
    by default) from a stand-in for
    ``precompute``'s output: random complex taps of lengths ``lh`` (all ones
    with ``unit``; rounded to TF32 with ``tf32_taps``), a random MTD
    matrix [num_v, P] (the identity when ``num_v`` is None) and gate tiles
    a multiple of ``lane``."""
    from types import SimpleNamespace

    gates = K1_RAGGED[1]
    rng = np.random.default_rng(seed)
    taps = []
    for n in lh:
        t = (np.ones(n, np.complex64) if unit else
             (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
                 np.complex64))
        if tf32_taps:
            t = (nr._round_tf32(torch.from_numpy(t.real.copy())).numpy()
                 + 1j * nr._round_tf32(torch.from_numpy(t.imag.copy())
                                       ).numpy())
        taps.append(t)
    pre = SimpleNamespace(gate_splits=gates, n_total_gate=sum(gates),
                          fir_delay=lh[0] // 2, mf_narrow=taps[0],
                          mf_medium_win=taps[1], mf_long_win=taps[2])
    mtd = (np.eye(num_p) if num_v is None else
           (rng.normal(size=(num_v, num_p))
            + 1j * rng.normal(size=(num_v, num_p))) / np.sqrt(num_p))
    return nr.make_rdm_plan(pre, mtd.astype(np.complex64), num_p,
                            lane=lane, device=device)


@pytest.mark.cuda
def test_k1_matches_plain_at_ragged_shapes_on_card(cuda_device):
    """K1 (3xTF32 strip-GEMM PC, mix, DFT GEMM) at K1_RAGGED's shapes vs
    its plain version: RMS of the difference within 1e-5 of the RMS, every
    element within 1e-4 of it; draw mode equal to planes mode on the plain
    Philox planes bit for bit; one K1 count a call, no K1c count."""
    num_b, num_p, num_v = K1_RAGGED[2:]
    plan = _k1_plan(cuda_device, num_v=num_v)
    rng = np.random.default_rng(3)
    c = lambda *s: torch.from_numpy((rng.normal(size=s) + 1j * rng.normal(
        size=s)).astype(np.complex64)).to(cuda_device)
    lmat = c(num_b, num_b) * 0.5
    signal = (c(2, num_v), c(2, plan.n_gates), c(2, num_b))
    seed = (7, 9)
    planes = nr.philox_planes(plan, seed, num_b, device=cuda_device)
    before = (nr.launch_count, nr.k1c_launch_count)
    drawn = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg")
    fed = nr.noise_rdm(plan, lmat, signal, planes=planes, layout="bvg")
    torch.cuda.synchronize()
    assert (nr.launch_count, nr.k1c_launch_count) == (before[0] + 2,
                                                      before[1])
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    assert drawn.shape == (num_b, num_v, plan.n_gates)
    assert torch.equal(drawn, fed)
    err, rms = (fed - ref).abs(), _rms(ref)
    assert _rms(err) <= 1e-5 * rms and float(err.max()) <= 1e-4 * rms


@pytest.mark.cuda
def test_k1_draw_mode_at_unaligned_plane_widths_on_card(cuda_device):
    """Draw mode reads K1c's planes in place only where their rows are
    16-byte strides; with gate tiles of 129 (lane 3) two segments' planes
    are 514 and 1157 samples wide, so K1 pads copies of them: still equal
    to planes mode bit for bit and within K1's hold of plain."""
    num_b, num_p, num_v = K1_RAGGED[2:]
    plan = _k1_plan(cuda_device, num_v=num_v, lane=3)
    assert [seg.xlen % 4 for seg in plan.segments] == [0, 2, 1]
    lmat = torch.eye(num_b, dtype=torch.complex64, device=cuda_device)
    seed = (11, 13)
    planes = nr.philox_planes(plan, seed, num_b, device=cuda_device)
    drawn = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg")
    fed = nr.noise_rdm(plan, lmat, planes=planes, layout="bvg")
    ref = nr.noise_rdm_plain(plan, lmat, planes)
    torch.cuda.synchronize()
    assert torch.equal(drawn, fed)
    err, rms = (fed - ref).abs(), _rms(ref)
    assert _rms(err) <= 1e-5 * rms and float(err.max()) <= 1e-4 * rms


@pytest.mark.cuda
def test_k1_delta_and_one_tap_probes_on_card(cuda_device):
    """Inputs that locate layout faults, held exactly with D and L the
    identity and no signal (every output one product with 1, every value
    TF32-exact, so the splits' low parts are zero): a unit delta in every
    (beam, pulse) row recovers the TF32-rounded filter at its place, and
    one-tap unit filters recover TF32-exact random planes."""
    num_b, num_p = K1_RAGGED[2:4]
    eye = torch.eye(num_b, dtype=torch.complex64, device=cuda_device)
    plan = _k1_plan(cuda_device, tf32_taps=True)
    planes = []
    for si, seg in enumerate(plan.segments):
        x = torch.zeros((num_b, num_p, seg.xlen), device=cuda_device)
        n = seg.pad_front + (torch.arange(num_b * num_p, device=cuda_device)
                             * (7 + si) % seg.r_len)
        x.view(-1, seg.xlen)[torch.arange(num_b * num_p), n] = 1.0
        planes.append((x, torch.zeros_like(x)))
    got = nr.noise_rdm(plan, eye, planes=planes, layout="bvg")
    ref = nr.noise_rdm_plain(plan, eye, planes)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0.0 and torch.equal(got, ref)

    one = _k1_plan(cuda_device, lh=(1, 1, 1), unit=True)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    planes = [tuple(nr._round_tf32(torch.randn(
        (num_b, num_p, seg.xlen), generator=g, device=cuda_device))
        for _ in range(2)) for seg in one.segments]
    got = nr.noise_rdm(one, eye, planes=planes, layout="bvg")
    ref = nr.noise_rdm_plain(one, eye, planes)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["full", "small", "generic", "widest"])
def test_k2_windows_match_plain_on_card(cuda_device, window):
    """K2 at its two compiled-in windows and through its generic
    instantiation (a narrow window, and the widest the halo takes, staged
    in several TMA boxes), each method: mask and row counts identical to
    the plain version's."""
    params = {"full": CfarParams(),
              "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2),
              "widest": CfarParams(guard_cells_r=100, ref_cells_r=28,
                                   guard_cells_v=100, ref_cells_v=28,
                                   threshold_factor=3.0)}[window]
    rng = np.random.default_rng(5)
    maps = rng.exponential(size=(3, 300, 1500)).astype(np.float32)
    maps[rng.integers(0, 3, 60), rng.integers(130, 170, 60),
         rng.integers(130, 1370, 60)] += 60.0
    tp = ck.pad_maps_qvg(torch.from_numpy(maps).to(cuda_device))
    for method in ("GOCA", "SOCA", "CA"):
        p = CfarParams(**{**params.__dict__, "method": method})
        mask, rc = ck.goca_cfar_qvg(tp, p, 1500, 300)
        mask_p, rc_p = ck.goca_cfar_qvg_plain(tp, p, 1500, 300)
        torch.cuda.synchronize()
        assert torch.equal(mask, mask_p) and torch.equal(rc, rc_p)
        assert int(mask.sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["full", "small", "generic", "widest",
                                    "unaligned"])
def test_k3_windows_match_plain_on_card(cuda_device, window):
    """K3 (the beam walk through TMA-staged slots) at its two compiled-in
    windows and through its generic instantiation (a narrow window, and the
    widest the halo takes, staged in several TMA boxes), and at a gate count
    that is not a multiple of 4 (a padded copy for TMA, per-cell stores),
    each method: mask and threshold identical to the plain version's, one
    K3 count a call."""
    params = {"full": CfarParams(), "unaligned": CfarParams(),
              "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2),
              "widest": CfarParams(guard_cells_r=100, ref_cells_r=28,
                                   guard_cells_v=100, ref_cells_v=28,
                                   threshold_factor=3.0)}[window]
    num_g = 1501 if window == "unaligned" else 1500
    rng = np.random.default_rng(8)
    mag = rng.exponential(size=(5, 300, num_g)).astype(np.float32)
    mag[rng.integers(0, 5, 60), rng.integers(130, 170, 60),
        rng.integers(130, num_g - 130, 60)] += 60.0
    t = torch.from_numpy(mag).to(cuda_device)
    for method in ("GOCA", "SOCA", "CA"):
        p = CfarParams(**{**params.__dict__, "method": method})
        before = ck.k3_launch_count
        mask, thr = ck.goca_cfar_2d_fused(t, p)
        mask_p, thr_p = ck.goca_cfar_2d_fused_plain(t, p)
        torch.cuda.synchronize()
        assert ck.k3_launch_count == before + 1
        assert torch.equal(mask, mask_p) and torch.equal(thr, thr_p)
        assert int(mask.sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("num_b", [2, 3])
@pytest.mark.parametrize("window", ["full", "small", "generic"])
def test_k3_few_beams_match_plain_on_card(cuda_device, window, num_b):
    """K3 with one pair (2 beams, as small_test_config's) and with an odd
    pair count (3 beams), at both compiled-in windows (which walk their
    pairs in up to 2 groups) and through the generic instantiation: mask
    and threshold identical to the plain version's, each method."""
    params = {"full": CfarParams(), "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2)}[window]
    rng = np.random.default_rng(9)
    mag = rng.exponential(size=(num_b, 300, 1500)).astype(np.float32)
    mag[rng.integers(0, num_b, 60), rng.integers(130, 170, 60),
        rng.integers(130, 1370, 60)] += 60.0
    t = torch.from_numpy(mag).to(cuda_device)
    for method in ("GOCA", "SOCA", "CA"):
        p = CfarParams(**{**params.__dict__, "method": method})
        mask, thr = ck.goca_cfar_2d_fused(t, p)
        mask_p, thr_p = ck.goca_cfar_2d_fused_plain(t, p)
        torch.cuda.synchronize()
        assert mask.shape == (300, 1500, num_b - 1)
        assert torch.equal(mask, mask_p) and torch.equal(thr, thr_p)
        assert int(mask.sum()) >= 10


def _bf16_planes(plan, num_b, num_p, seed, device):
    """Random per-segment planes [B, P, xlen] holding bfloat16 values."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [tuple(torch.randn((num_b, num_p, seg.xlen), generator=g,
                              device=device).to(torch.bfloat16).float()
                  for _ in range(2)) for seg in plan.segments]


@pytest.mark.cuda
def test_k10_bf16_delta_and_one_tap_probes_on_card(cuda_device):
    """Inputs that locate layout faults in K10's bf16 PC (the strip GEMM)
    and the bf16 DFT GEMM, held exactly with D and L the identity (every
    output one bf16 product with 1): a unit delta in every (beam, pulse) row
    recovers the rounded filter at its place, and one-tap unit filters
    recover the rounded planes; one strip-GEMM and one DFT launch a call."""
    num_b, num_p = K1_RAGGED[2:4]
    bf = torch.bfloat16
    eye = torch.eye(num_b, dtype=torch.complex64, device=cuda_device)
    plan = _k1_plan(cuda_device)
    planes = []
    for si, seg in enumerate(plan.segments):
        x = torch.zeros((num_b, num_p, seg.xlen), device=cuda_device)
        n = seg.pad_front + (torch.arange(num_b * num_p, device=cuda_device)
                             * (7 + si) % seg.r_len)
        x.view(-1, seg.xlen)[torch.arange(num_b * num_p), n] = 1.0
        planes.append((x, torch.zeros_like(x)))
    before = (nr.strip_pc_launch_count, nr.dft_launch_count)
    got = nr.noise_rdm(plan, eye, planes=planes, variant="resident",
                       mul_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(plan, eye, planes, mul_dtype=bf)
    torch.cuda.synchronize()
    assert (nr.strip_pc_launch_count, nr.dft_launch_count) == (
        before[0] + 1, before[1] + 1)
    assert float(ref.abs().max()) > 0.0 and torch.equal(got, ref)

    one = _k1_plan(cuda_device, lh=(1, 1, 1), unit=True)
    planes = _bf16_planes(one, num_b, num_p, 4, cuda_device)
    got = nr.noise_rdm(one, eye, planes=planes, variant="resident",
                       mul_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(one, eye, planes, mul_dtype=bf)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_bf16_dft_gemm_probe_and_random_on_card(cuda_device):
    """The bf16 DFT GEMM alone: with D = P1 + i P2 (two permutations) every
    output is one f32 sum of two bf16 values, held exactly against the plain
    product rounded to bf16; with a random D (41 x 37) and random planes
    [5, 37, 1000] within 3e-4 RMS of the plain product."""
    from types import SimpleNamespace

    num_b, num_p, num_g = 5, 37, 1000
    bf = torch.bfloat16
    ld = -(-num_g // 8) * 8
    g = torch.Generator(device=cuda_device).manual_seed(6)
    pcr = torch.randn((num_b, num_p, ld), generator=g,
                      device=cuda_device).to(bf)
    pci = torch.randn((num_b, num_p, ld), generator=g,
                      device=cuda_device).to(bf)
    eye = torch.eye(num_p, device=cuda_device)
    perm = torch.randperm(num_p, generator=g, device=cuda_device)
    rng = np.random.default_rng(1)
    for d in (torch.complex(eye, eye[perm]),
              torch.from_numpy((rng.normal(size=(41, num_p)) + 1j
                                * rng.normal(size=(41, num_p))).astype(
                  np.complex64)).to(cuda_device)):
        plan = SimpleNamespace(d_bf16=nr.d_bf16(d), n_dop=d.shape[0],
                               n_pulses=num_p)
        mtr = torch.empty((num_b, d.shape[0], num_g), dtype=bf,
                          device=cuda_device)
        mti = torch.empty_like(mtr)
        before = nr.dft_launch_count
        nr.dft(plan, pcr, pci, num_g, mtr, mti)
        pc = torch.complex(pcr[..., :num_g].float(), pci[..., :num_g].float())
        want = nr.round_mul(torch.matmul(nr.round_mul(d, bf), pc), bf)
        got = torch.complex(mtr.float(), mti.float())
        torch.cuda.synchronize()
        assert nr.dft_launch_count == before + 1
        if d.shape[0] == num_p:
            assert torch.equal(got, want)
        else:
            assert _rms(got - want) <= 3e-4 * _rms(want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["resident", "stacked"])
def test_k10_k7_bf16_at_ragged_shapes_on_card(cuda_device, variant):
    """K10 and K7 at bf16 (the strip-GEMM PC) through the bf16 DFT GEMM at
    K1_RAGGED's shapes (135 rows, gates 37/300/700 at odd offsets, taps
    5/90/300, 41 Doppler bins), with the rank-K signal and a random L:
    within 3e-4 RMS of the plain version; one strip-GEMM and one DFT launch
    for each."""
    num_b, num_p, num_v = K1_RAGGED[2:]
    plan = _k1_plan(cuda_device, num_v=num_v)
    rng = np.random.default_rng(3)
    c = lambda *s: torch.from_numpy((rng.normal(size=s) + 1j * rng.normal(
        size=s)).astype(np.complex64)).to(cuda_device)
    lmat = c(num_b, num_b) * 0.5
    signal = (c(2, num_v), c(2, plan.n_gates), c(2, num_b))
    planes = _bf16_planes(plan, num_b, num_p, 9, cuda_device)
    bf = torch.bfloat16
    before = (nr.strip_pc_launch_count, nr.dft_launch_count)
    got = nr.noise_rdm(plan, lmat, signal, planes=planes, variant=variant,
                       mul_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal, mul_dtype=bf)
    torch.cuda.synchronize()
    assert (nr.strip_pc_launch_count, nr.dft_launch_count) == (
        before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rms(got - ref) <= 3e-4 * _rms(ref)


def _ragged_inputs(device, num_b, num_v=K1_RAGGED[4], seed=3,
                   num_p=K1_RAGGED[3]):
    """K1_RAGGED's plan with ``num_v`` Doppler bins and ``num_p`` pulses, a
    random L [B, B] and rank-2 signal factors for ``num_b`` beams."""
    plan = _k1_plan(device, num_v=num_v, num_p=num_p)
    rng = np.random.default_rng(seed)
    c = lambda *s: torch.from_numpy((rng.normal(size=s) + 1j * rng.normal(
        size=s)).astype(np.complex64)).to(device)
    return plan, c(num_b, num_b) * 0.5, (c(2, num_v), c(2, plan.n_gates),
                                        c(2, num_b))


@pytest.mark.cuda
@pytest.mark.parametrize("beams_per_step", [1, 2, 5, 13])
def test_k4_beams_per_step_and_planes_mode_on_card(cuda_device,
                                                   beams_per_step):
    """K4 at 13 beams on K1_RAGGED's plan (37 pulses, gates 37/300/700 at
    odd offsets, 41 Doppler bins), with the signal: every beams_per_step
    gives the same map bit for bit (a row's sums do not depend on the block
    that walks it), draw mode equals planes mode on K1c's planes bit for bit
    (the producers' swizzled stage holds what TMA loads), both within 1e-5
    RMS of the plain version and 2^-7 of K1's largest value."""
    num_b = 13
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b)
    seed = (21, 4)
    planes = nr.gen_noise_planes(plan, seed, num_b, device=cuda_device)
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    call = lambda k, **kw: nr.noise_rdm(plan, lmat, signal, layout="bvg",
                                        rolling=False, beams_per_step=k, **kw)
    before = nr.k4_pc_launch_count
    drawn = call(beams_per_step, seed=seed)
    fed = call(beams_per_step, planes=planes)
    one = call(1, seed=seed)
    k1 = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg")
    torch.cuda.synchronize()
    assert nr.k4_pc_launch_count == before + 3
    assert torch.equal(drawn, fed) and torch.equal(drawn, one)
    assert _rms(drawn - ref) <= 1e-5 * _rms(ref)
    assert float((drawn - k1).abs().max()) <= 2.0 ** -7 * float(
        k1.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("num_p", [K1_RAGGED[3], 512])
@pytest.mark.parametrize("with_signal", [False, True])
@pytest.mark.parametrize("num_b", [2, 3, 13])
def test_k9_bf16_tail_matches_plain_on_card(cuda_device, num_b, with_signal,
                                            num_p):
    """K9 at bf16 (strip-GEMM PC, then the wgmma DFT GEMM and the mix) at
    2, 3 and 13 beams, on K1_RAGGED's plan with 70 Doppler bins and 1037
    gates (ragged tiles), at 37 and 512 pulses, with and without the rank-K
    signal: within 3e-4 RMS of the plain version (bf16: the tensor cores'
    f32 sums flip a few bf16 roundings); one strip-GEMM and one DFT launch
    a call."""
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b, num_v=70,
                                        num_p=num_p)
    signal = signal if with_signal else None
    planes = _bf16_planes(plan, num_b, num_p, 5, cuda_device)
    bf = torch.bfloat16
    before = (nr.strip_pc_launch_count, nr.dft_launch_count,
              nr.k9_launch_count)
    got = nr.noise_rdm(plan, lmat, signal, planes=planes, variant="allbeams",
                       mul_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal, mul_dtype=bf)
    torch.cuda.synchronize()
    assert (nr.strip_pc_launch_count, nr.dft_launch_count,
            nr.k9_launch_count) == tuple(b + 1 for b in before)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rms(got - ref) <= 3e-4 * _rms(ref)




# ------------------------- the f32 schedules on K1's 3xTF32 tensor-core GEMMs

F32_SCHEDULES = ("resident", "stacked", "allbeams")


def _f32_schedules_alike(plan, lmat, signal, planes):
    """K10, K7 and K9 at f32 on ``planes``: asserts one 3xTF32 PC and one
    DFT launch a call and the three maps equal bit for bit (one sequence
    of launches); returns the map."""
    before = (nr.tf32_pc_launch_count, nr.tf32_dft_launch_count)
    got = [nr.noise_rdm(plan, lmat, signal, planes=planes, variant=v,
                        layout="bvg") for v in F32_SCHEDULES]
    torch.cuda.synchronize()
    assert (nr.tf32_pc_launch_count, nr.tf32_dft_launch_count) == (
        before[0] + 3, before[1] + 3)
    assert all(torch.equal(got[0], y) for y in got[1:])
    assert bool(torch.isfinite(torch.view_as_real(got[0])).all())
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("with_signal", [False, True])
@pytest.mark.parametrize("num_b", [1, 2, 13])
def test_f32_schedules_alike_at_ragged_shapes_on_card(cuda_device, num_b,
                                                      with_signal):
    """K10, K7 and K9 at f32 (K1's 3xTF32 PC, the join, K1's DFT GEMM, the
    mix after it) at K1_RAGGED's shapes (37 pulses, gates 37/300/700, 41
    Doppler bins) with 1, 2 and 13 beams, with and without the rank-K
    signal: bit for bit alike, within 1e-5 RMS of the plain version and of
    K1 (which mixes before the DFT; both ~4e-6 from plain)."""
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b)
    signal = signal if with_signal else None
    planes = nr.philox_planes(plan, (5, 6), num_b, device=cuda_device)
    got = _f32_schedules_alike(plan, lmat, signal, planes)
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    k1 = nr.noise_rdm(plan, lmat, signal, planes=planes, layout="bvg")
    torch.cuda.synchronize()
    assert _rms(got - ref) <= 1e-5 * _rms(ref)
    assert _rms(got - k1) <= 1e-5 * _rms(k1)


@pytest.mark.cuda
@pytest.mark.parametrize("with_signal", [False, True])
def test_f32_schedules_alike_at_full_size_on_card(cuda_device, with_signal):
    """The same at the perf config's full shape (13 beams, 332 pulses, 3404
    gates, 332 Doppler bins) on K1c's planes, with and without the signal of
    the benchmark's two targets."""
    from radar_tpu_torch.config.params import perf_config

    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device=cuda_device)
    plan, lmat = lr.rplan, lr.l_factor
    signal = lr.signal_factors(TargetBatch.make(
        [3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0], [10.0, 15.0])) \
        if with_signal else None
    planes = nr.gen_noise_planes(plan, (8, 9), lmat.shape[0],
                                 device=cuda_device)
    got = _f32_schedules_alike(plan, lmat, signal, planes)
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    k1 = nr.noise_rdm(plan, lmat, signal, planes=planes, layout="bvg")
    torch.cuda.synchronize()
    assert _rms(got - ref) <= 1e-5 * _rms(ref)
    assert _rms(got - k1) <= 1e-5 * _rms(k1)


@pytest.mark.cuda
@pytest.mark.parametrize("num_b", [2, 13])
def test_f32_draw_mode_equals_planes_mode_on_card(cuda_device, num_b):
    """K7's draw mode at f32 (``stacked=True``: K4's PC, its stages drawn
    in the block at one beam a block) equals K7 at f32 on K1c's planes bit
    for bit at K1_RAGGED's shapes with the signal (K4's PC is K1's, bit for
    bit); with bf16 output it is that map rounded, exactly; one drawing PC
    launch, no planes-mode PC launch."""
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b)
    seed = (12, 34)
    planes = nr.gen_noise_planes(plan, seed, num_b, device=cuda_device)
    before = (nr.k4_pc_launch_count, nr.tf32_pc_launch_count)
    drawn = nr.noise_rdm(plan, lmat, signal, seed=seed, stacked=True,
                         layout="bvg")
    torch.cuda.synchronize()
    assert (nr.k4_pc_launch_count, nr.tf32_pc_launch_count) == (
        before[0] + 1, before[1])
    fed = nr.noise_rdm(plan, lmat, signal, planes=planes, variant="stacked",
                       layout="bvg")
    bf = torch.bfloat16
    drawn16 = nr.noise_rdm(plan, lmat, signal, seed=seed, stacked=True,
                           out_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    torch.cuda.synchronize()
    assert torch.equal(drawn, fed)
    assert torch.equal(drawn16, nr.round_mul(drawn, bf))
    assert _rms(drawn - ref) <= 1e-5 * _rms(ref)


@pytest.mark.cuda
def test_k1_equals_k4_planes_mode_on_card(cuda_device):
    """K1's map (mix before the DFT, then the add of the DFT's passes and
    the signal) is K4's in planes mode bit for bit, with the signal, at
    K1_RAGGED's shapes: the tail both share with the f32 schedules' route
    keeps its mode (the join and the mix after the DFT run only for
    them)."""
    num_b = 13
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b, seed=7)
    planes = nr.gen_noise_planes(plan, (3, 3), num_b, device=cuda_device)
    k1 = nr.noise_rdm(plan, lmat, signal, planes=planes, layout="bvg")
    k4 = nr.noise_rdm(plan, lmat, signal, planes=planes, layout="bvg",
                      rolling=False, beams_per_step=1)
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    torch.cuda.synchronize()
    assert torch.equal(k1, k4)
    assert _rms(k1 - ref) <= 1e-5 * _rms(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("num_b", [2, 13])
def test_f32_join_and_mix_after_exact_probe_on_card(cuda_device, num_b):
    """Inputs whose every sum is exact in f32: one-tap unit filters, D the
    identity, L, the signal factors and the planes integers, the planes
    plus odd multiples of 2^-12 (so each value's TF32 lo part is nonzero
    and the correction passes carry it: a missing or misplaced join or a
    dropped DFT correction shows). The f32 schedules equal the plain
    version exactly, and with bf16 output its rounding exactly."""
    num_p = K1_RAGGED[3]
    plan = _k1_plan(cuda_device, lh=(1, 1, 1), unit=True)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    ints = lambda *s: torch.randint(-3, 4, s, generator=g,
                                    device=cuda_device).float()
    cint = lambda *s: torch.complex(ints(*s), ints(*s))
    planes = [tuple(ints(num_b, num_p, seg.xlen)
                    + (2 * ints(num_b, num_p, seg.xlen) + 1) * 2.0 ** -12
                    for _ in range(2)) for seg in plan.segments]
    lmat = cint(num_b, num_b)
    signal = (cint(2, plan.n_dop), cint(2, plan.n_gates), cint(2, num_b))
    got = _f32_schedules_alike(plan, lmat, signal, planes)
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    bf = torch.bfloat16
    got16 = nr.noise_rdm(plan, lmat, signal, planes=planes,
                         variant="resident", out_dtype=bf, layout="bvg")
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0.0
    assert torch.equal(got, ref)
    assert torch.equal(got16, nr.round_mul(ref, bf))


# ------------- K7's bf16 draw mode (drawing producers) and K8 at f32 (3xTF32)

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "ragged"])
def test_k7_bf16_draw_mode_equals_planes_mode_on_card(cuda_device, shape):
    """K7's bf16 draw mode (``stacked=True``: the strip GEMM whose producers
    draw the data's stages) equals K7's bf16 planes mode on K1c's planes bit
    for bit (the same consumers on the same bf16 values), with the rank-K
    signal, at the small config (5 beams x 32 pulses) and at 3 beams x 45
    pulses (135 rows, not a multiple of 128) on K1_RAGGED's gates (37/300/
    700, segments starting at odd gates) and taps; within 3e-4 RMS of the
    plain version; one drawing strip-GEMM launch, no planes-mode one."""
    bf = torch.bfloat16
    if shape == "small":
        lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
        plan, lmat = lr.rplan, lr.l_factor
        signal = lr.signal_factors(TargetBatch.make(*TARGETS))
    else:
        plan, lmat, signal = _ragged_inputs(cuda_device, 3, num_p=45)
    num_b = lmat.shape[0]
    seed = (17, 29)
    planes = nr.gen_noise_planes(plan, seed, num_b, device=cuda_device)
    before = (nr.strip_pc_draw_launch_count, nr.strip_pc_launch_count,
              nr.k7_launch_count)
    drawn = nr.noise_rdm(plan, lmat, signal, seed=seed, stacked=True,
                         mul_dtype=bf, layout="bvg")
    torch.cuda.synchronize()
    assert (nr.strip_pc_draw_launch_count, nr.strip_pc_launch_count,
            nr.k7_launch_count) == (before[0] + 1, before[1], before[2] + 1)
    fed = nr.noise_rdm(plan, lmat, signal, planes=planes, variant="stacked",
                       mul_dtype=bf, layout="bvg")
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal, mul_dtype=bf)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(drawn)).all())
    assert torch.equal(drawn, fed)
    assert _rms(drawn - ref) <= 3e-4 * _rms(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "ragged"])
def test_k8_f32_matches_plain_and_twin_on_card(cuda_device, shape):
    """K8 at f32 (the staging kernel's f32 planes, then K1's 3xTF32 strip
    GEMM with both passes in one launch) vs its plain version and the plain
    twin of its arithmetic (``pulse_compress_noise_tf32``): RMS of the
    difference within 1e-5 of the RMS, at the small config and where every
    edge is ragged (135 rows, gates 37/300/700 at odd offsets, taps
    5/90/300); one staging and one strip-GEMM launch a call."""
    from radar_tpu_torch.studies import pallas_pc as ppc

    if shape == "small":
        plan = ppc.make_pallas_pc_plan(
            precompute(small_test_config(channels=8, pulses=8)),
            device=cuda_device)
        bp = (3, 8)
    else:
        plan = _ragged_plan(*RAGGED[:2], cuda_device)
        bp = RAGGED[2]
    z = _cube(bp + (plan.s_compact,), 0, cuda_device)
    before = (ppc.launch_count, ppc.stage_launch_count,
              ppc.tf32_pc_launch_count)
    got = ppc.pulse_compress_noise(z, plan, mul_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (ppc.launch_count, ppc.stage_launch_count,
            ppc.tf32_pc_launch_count) == tuple(n + 1 for n in before)
    ref = ppc.pulse_compress_noise_plain(z, plan, torch.float32)
    twin = ppc.pulse_compress_noise_tf32(z, plan)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rms(got - ref) <= 1e-5 * _rms(ref)
    assert _rms(got - twin) <= 1e-5 * _rms(ref)


@pytest.mark.cuda
def test_k8_f32_exact_probe_on_card(cuda_device):
    """Inputs whose every sum is exact in f32: unit filters (5/90/300 taps)
    and integers plus odd multiples of 2^-12 (so each value's TF32 lo part
    is nonzero and the correction pass carries it: a dropped, doubled or
    misplaced correction or a swizzle or descriptor fault shows), at
    RAGGED's shapes. K8 at f32 equals the plain version exactly."""
    from radar_tpu_torch.studies import pallas_pc as ppc

    plan = _ragged_plan(RAGGED[0], RAGGED[1], cuda_device, unit=True)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    shape = RAGGED[2] + (plan.s_compact,)
    ints = lambda: (torch.randint(-3, 4, shape, generator=g,
                                  device=cuda_device).float()
                    + (2 * torch.randint(-3, 4, shape, generator=g,
                                         device=cuda_device).float() + 1)
                    * 2.0 ** -12)
    z = torch.complex(ints(), ints())
    got = ppc.pulse_compress_noise(z, plan, mul_dtype=torch.float32)
    ref = ppc.pulse_compress_noise_plain(z, plan, torch.float32)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0.0 and torch.equal(got, ref)


def _perf_k1_inputs(device, num_b=None):
    """The perf config's plan, L and the signal of the benchmark's two
    targets, on its first ``num_b`` beams (all 13 by default)."""
    from radar_tpu_torch.config.params import perf_config

    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device=device)
    dv, pb, st = lr.signal_factors(TargetBatch.make(
        [3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0], [10.0, 15.0]))
    num_b = num_b or lr.l_factor.shape[0]
    return (lr.rplan, lr.l_factor[:num_b, :num_b].contiguous(),
            (dv, pb, st[:, :num_b].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_b", [2, 3, 13])
def test_k1_emit_maps_matches_plain_on_card(cuda_device, num_b, out_dtype):
    """K1's maps epilogue (``add_maps_kernel``) at the perf config's full
    shape on 2, 3 and 13 beams: the map equals K1's map without the maps
    rounded to ``out_dtype`` bit for bit, and the maps equal the plain
    epilogue (``pair_maps_plain``) of that unrounded map bit for bit, halo
    and padding zero; one epilogue launch; the maps within K1's hold of
    the plain version's maps."""
    plan, lmat, signal = _perf_k1_inputs(cuda_device, num_b)
    seed = (3, 5)
    base = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg")
    before = nr.maps_launch_count
    rdm, maps = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg",
                             emit_maps=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert nr.maps_launch_count == before + 1
    assert torch.equal(rdm, nr.round_mul(base, out_dtype))
    want = nr.pair_maps_plain(base)
    assert maps.shape == want.shape == (
        num_b - 1, -(-plan.n_dop // 8) * 8,
        -(-plan.n_gates // ck.GATE_TILE) * ck.GATE_TILE + 2 * ck.HALO)
    assert torch.equal(maps, want)
    ref = nr.pair_maps_plain(nr.noise_rdm_plain(
        plan, lmat, nr.philox_planes(plan, seed, num_b, device=cuda_device),
        signal))
    assert _rms(maps - ref) <= 1e-5 * _rms(ref)


@pytest.mark.cuda
def test_k1_emit_maps_at_ragged_shapes_on_card(cuda_device):
    """The same relations at K1_RAGGED's shapes (41 Doppler rows, not a
    multiple of 8: the padded rows read zero) on 5 beams."""
    plan, lmat, signal = _ragged_inputs(cuda_device, 5)
    seed = (7, 9)
    base = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg")
    for out_dtype in (torch.float32, torch.bfloat16):
        rdm, maps = nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg",
                                 emit_maps=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(rdm, nr.round_mul(base, out_dtype))
        assert torch.equal(maps, nr.pair_maps_plain(base))


# K1 without the maps on the perf config's full shape (draw mode, seed
# (3, 5), the signal of the benchmark's two targets, f32 output): SHA-256
# of the map's bytes on an NVIDIA H100 80GB HBM3, planes mode the same, on
# the draws keyed two samples a Philox block (the digest of the stream
# before, one block a sample, was 3a59303f...)
K1_BITS_SHA256 = ("d3417cd0328540c6438a55ce20034016addb9cc4b05c470bb4f4801059"
                  "5ca68a")


@pytest.mark.cuda
def test_k1_without_maps_keeps_its_bits_on_card(cuda_device):
    """K1 without emit_maps launches what it launched before the maps
    epilogue (``add_kernel``) and writes the same map bit for bit."""
    import hashlib

    plan, lmat, signal = _perf_k1_inputs(cuda_device)
    before = nr.maps_launch_count
    rdm = nr.noise_rdm(plan, lmat, signal, seed=(3, 5), layout="bvg")
    torch.cuda.synchronize()
    assert nr.maps_launch_count == before
    digest = hashlib.sha256(rdm.cpu().numpy().tobytes()).hexdigest()
    assert digest == K1_BITS_SHA256, digest


# ------------------------------------------- K1, K4 and K1c at bf16 operands


BF16_HOLD = 3e-4      # chip_smoke.py's: bf16 roundings after sums in
BF16_OUT_HOLD = 6e-4  # other orders; a flip before the output rounding
                      # costs a whole output ulp


@pytest.mark.cuda
def test_k1_bf16_matches_plain_on_card(cuda_device):
    """K1 at bf16 operands (K1c's bf16 rows, the strip GEMM, the wgmma DFT,
    the mix) with the signal vs its plain version: the map within
    BF16_HOLD, bf16 output within BF16_OUT_HOLD and equal to the f32-output
    map rounded, the pair maps those of the map bit for bit (and of the
    plain map within BF16_HOLD); one launch of each part."""
    bf = torch.bfloat16
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    plan, lmat = lr.rplan, lr.l_factor
    assert lr.dtypes.mul == bf
    factors = lr.signal_factors(TargetBatch.make(*TARGETS))
    seed = (3, 5)
    ref, ref_maps = nr.noise_rdm_plain(
        plan, lmat, nr.philox_planes(plan, seed, 5, device=cuda_device),
        factors, mul_dtype=bf, emit_maps=True)
    counts = (nr.k1_bf16_launch_count, nr.strip_pc_launch_count,
              nr.dft_launch_count, nr.k1c_bf16_launch_count,
              nr.tf32_pc_launch_count, nr.mix_launch_count)
    y, maps = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg",
                           mul_dtype=bf, emit_maps=True)
    y16 = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg",
                       mul_dtype=bf, out_dtype=bf)
    torch.cuda.synchronize()
    assert (nr.k1_bf16_launch_count, nr.strip_pc_launch_count,
            nr.dft_launch_count, nr.k1c_bf16_launch_count,
            nr.tf32_pc_launch_count, nr.mix_launch_count) == (
                counts[0] + 2, counts[1] + 2, counts[2] + 2, counts[3] + 2,
                counts[4], counts[5] + 2)
    assert _rms(y - ref) <= BF16_HOLD * _rms(ref)
    assert _rms(y16 - nr.round_mul(ref, bf)) <= BF16_OUT_HOLD * _rms(ref)
    assert torch.equal(y16, nr.round_mul(y, bf))
    assert torch.equal(maps, nr.pair_maps_plain(y))
    assert _rms(maps - ref_maps) <= BF16_HOLD * _rms(ref_maps)


@pytest.mark.cuda
@pytest.mark.parametrize("with_signal", [False, True])
def test_k1_bf16_draw_equals_planes_mode_and_k4_on_card(cuda_device,
                                                        with_signal):
    """At bf16 operands on K1_RAGGED's plan (37 pulses, odd gate offsets,
    41 Doppler bins) at 13 beams: K1's draw mode equals its planes mode on
    the plain Philox planes and on K1c's bf16 rows, and K4 equals K1, bit
    for bit, at f32 and bf16 output."""
    bf, num_b = torch.bfloat16, 13
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b, seed=11)
    signal = signal if with_signal else None
    seed = (9, 2)
    planes = nr.philox_planes(plan, seed, num_b, device=cuda_device)
    rows16 = nr.gen_noise_planes(plan, seed, num_b, device=cuda_device,
                                 dtype=bf)
    for out in (torch.float32, bf):
        kw = dict(layout="bvg", mul_dtype=bf, out_dtype=out)
        k1 = nr.noise_rdm(plan, lmat, signal, seed=seed, **kw)
        fed = nr.noise_rdm(plan, lmat, signal, planes=planes, **kw)
        fed16 = nr.noise_rdm(plan, lmat, signal, planes=rows16, **kw)
        k4 = nr.noise_rdm(plan, lmat, signal, seed=seed, rolling=False, **kw)
        torch.cuda.synchronize()
        assert float(k1.abs().max()) > 0.0
        assert torch.equal(k1, fed) and torch.equal(k1, fed16)
        assert torch.equal(k1, k4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["plan", "ragged"])
def test_k1c_bf16_rows_on_card(cuda_device, shape):
    """K1c's bf16 mode writes every segment's rows in one launch, each row
    xlen values padded with zeros to a multiple of 8, equal bit for bit to
    the plain Philox planes rounded to nearest even; at ragged sizes
    (xlen not a multiple of 8, an odd number of pulse rows) too."""
    bf = torch.bfloat16
    lr = make_lowrank_stages(CFG, precompute(CFG), device=cuda_device)
    plan = lr.rplan
    if shape == "ragged":
        segs = tuple(sg._replace(window=sg.window + 1 + 2 * i,
                                 pad_front=sg.pad_front + 5 + i)
                     for i, sg in enumerate(plan.segments))
        plan = plan._replace(segments=segs, n_pulses=7)
        assert all(sg.xlen % 8 for sg in segs)
    before = (nr.k1c_launch_count, nr.k1c_bf16_launch_count)
    got = nr.gen_noise_planes(plan, (7, 11), 3, device=cuda_device, dtype=bf)
    want = nr.philox_planes(plan, (7, 11), 3, device=cuda_device)
    torch.cuda.synchronize()
    assert (nr.k1c_launch_count, nr.k1c_bf16_launch_count) == (
        before[0] + 1, before[1] + 1)
    for (a, b), (c, d), sg in zip(got, want, plan.segments):
        ld = nr.k1c_row_len(sg.xlen, bf)
        assert a.dtype == bf and a.shape == (3, plan.n_pulses, sg.xlen)
        assert a.stride() == (plan.n_pulses * ld, ld, 1)
        assert torch.equal(a, c.to(bf)) and torch.equal(b, d.to(bf))
        for x in (a, b):
            rows = x.as_strided((3 * plan.n_pulses, ld), (ld, 1))
            assert not rows[:, sg.xlen:].float().any()


@pytest.mark.cuda
def test_k4_f32_bf16_output_is_its_map_rounded_on_card(cuda_device):
    """K4 at f32 operands with bf16 output (K1's epilogue that walks the
    beams rounds it) equals its f32-output map rounded to bf16 values."""
    plan, lmat, signal = _ragged_inputs(cuda_device, 13, seed=5)
    kw = dict(seed=(4, 8), layout="bvg", rolling=False)
    y = nr.noise_rdm(plan, lmat, signal, **kw)
    y16 = nr.noise_rdm(plan, lmat, signal, out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y16, nr.round_mul(y, torch.bfloat16))
    assert not torch.equal(y16, y)


# ------------------------------------------------------------ the bf16 mix

# (Doppler bins, gates): the perf frame's, and K1_RAGGED's 41 bins at a
# segment's 300 and 700 gates (even, not multiples of 8: two-cell runs)
# and its 1037 gates in all (odd: the one-cell instance)
MIX_SHAPES = {"full": (332, 3404), "g300": (41, 300), "g700": (41, 700),
              "g1037": (41, 1037)}


@pytest.fixture(scope="module")
def old_mix():
    """scripts/ablate_mix.py (the mix before its redesign, built there)."""
    import importlib.util
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "scripts", "ablate_mix.py")
    spec = importlib.util.spec_from_file_location("ablate_mix", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build_old()


def _mix_inputs(device, num_b, num_v, num_g, seed=1):
    """Random bf16 planes [B, V, G], an L [B, B] holding bf16 values and
    rank-K signal factors for K = 0, 2 and 40."""
    rng = np.random.default_rng(seed)
    c = lambda *s: torch.from_numpy((rng.normal(size=s) + 1j * rng.normal(
        size=s)).astype(np.complex64)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    mtr, mti = (torch.randn((num_b, num_v, num_g), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
    lmat = nr.round_mul(c(num_b, num_b) * 0.5, torch.bfloat16).contiguous()
    signals = {0: None}
    for k in (2, 40):
        signals[k] = (c(k, num_v), c(k, num_g), c(k, num_b) * 0.1)
    return mtr, mti, lmat, signals


@pytest.mark.cuda
@pytest.mark.parametrize("num_b", [1, 2, 13, 16])
@pytest.mark.parametrize("shape", list(MIX_SHAPES))
def test_mix_equals_old_mix_on_card(cuda_device, old_mix, shape, num_b):
    """The redesigned bf16 mix equals the mix it replaced bit for bit, map
    and pair maps, at K of 0, 2 and 40, with and without the maps (2 beams
    and up), with and without bf16 output; one launch a call."""
    ablate, old_lib = old_mix
    num_v, num_g = MIX_SHAPES[shape]
    mtr, mti, lmat, signals = _mix_inputs(cuda_device, num_b, num_v, num_g)
    for k in (0, 2, 40):
        for with_maps in ((False, True) if num_b > 1 else (False,)):
            for round_out in (False, True):
                before = nr.mix_launch_count
                new, new_maps = nr.mix(mtr, mti, lmat, signals[k],
                                       round_out=round_out,
                                       emit_maps=with_maps)
                assert nr.mix_launch_count == before + 1
                old, old_maps = ablate.run_mix(old_lib, mtr, mti, lmat,
                                               signals[k],
                                               round_out=round_out,
                                               emit_maps=with_maps)
                torch.cuda.synchronize()
                what = (k, with_maps, round_out)
                assert float(old.abs().max()) > 0.0, what
                assert torch.equal(new, old), what
                assert not with_maps or torch.equal(new_maps, old_maps), what


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["full", "g1037"])
def test_mix_matches_plain_on_card(cuda_device, shape):
    """The mix against its plain version (``mix_plain``) on the same planes
    at 13 beams with K = 2 and 40: the map within 1e-6 RMS of the plain
    map (the 13-term sums and the signal in f32, in another order), the
    maps within 1e-6 of the plain map's pair maps, bf16 output the f32
    output rounded bit for bit."""
    num_v, num_g = MIX_SHAPES[shape]
    mtr, mti, lmat, signals = _mix_inputs(cuda_device, 13, num_v, num_g,
                                          seed=4)
    mt = torch.complex(mtr.float(), mti.float())
    for k in (2, 40):
        y, maps = nr.mix(mtr, mti, lmat, signals[k], emit_maps=True)
        y16, _ = nr.mix(mtr, mti, lmat, signals[k], round_out=True)
        ref, ref_maps = nr.mix_plain(mt, lmat, signals[k], emit_maps=True)
        torch.cuda.synchronize()
        assert _rms(y - ref) <= 1e-6 * _rms(ref)
        inner = lambda m: m[:, :num_v, ck.HALO:ck.HALO + num_g]
        assert _rms(inner(maps) - inner(ref_maps)) <= 1e-6 * _rms(
            inner(ref_maps))
        assert torch.equal(y16, nr.round_mul(y, torch.bfloat16))


@pytest.mark.cuda
def test_mix_launches_once_a_bf16_call_on_card(cuda_device):
    """Each bf16 call of K1 (draw and planes mode), K4, K10, K7 (planes
    and draw mode) and K9 launches the mix once."""
    bf = torch.bfloat16
    num_b = 5
    plan, lmat, signal = _ragged_inputs(cuda_device, num_b, seed=2)
    planes = _bf16_planes(plan, num_b, plan.n_pulses, 3, cuda_device)
    kw = dict(layout="bvg", mul_dtype=bf)
    calls = {
        "K1": lambda: nr.noise_rdm(plan, lmat, signal, seed=(1, 2), **kw),
        "K1_maps": lambda: nr.noise_rdm(plan, lmat, signal, seed=(1, 2),
                                        emit_maps=True, **kw),
        "K1_planes": lambda: nr.noise_rdm(plan, lmat, signal, planes=planes,
                                          **kw),
        "K4": lambda: nr.noise_rdm(plan, lmat, signal, seed=(1, 2),
                                   rolling=False, **kw),
        "K10": lambda: nr.noise_rdm(plan, lmat, signal, planes=planes,
                                    variant="resident", **kw),
        "K7": lambda: nr.noise_rdm(plan, lmat, signal, planes=planes,
                                   variant="stacked", **kw),
        "K7_draw": lambda: nr.noise_rdm(plan, lmat, signal, seed=(1, 2),
                                        stacked=True, **kw),
        "K9": lambda: nr.noise_rdm(plan, lmat, signal, planes=planes,
                                   variant="allbeams", **kw)}
    got = {}
    for name, call in calls.items():
        before = nr.mix_launch_count
        call()
        torch.cuda.synchronize()
        got[name] = nr.mix_launch_count - before
    assert got == {name: 1 for name in calls}



# ------------------------------ the kernel routes at a zero-padded Doppler FFT

# cfg.mtd_fft_len at small_test_config's 32 pulses: V = 2P, and V = 40, not
# a multiple of 8 or 16 (the Doppler rows of D, the DFT's tile and the maps
# padded); the perf path runs 512 bins from 332 pulses (chip_smoke.py's
# phase fft512)
FFT_LENS = (40, 64)


def _fft_stages(device, fft_len):
    cfg = CFG.replace(mtd_fft_len=fft_len)
    lr = make_lowrank_stages(cfg, precompute(cfg), device=device)
    assert lr.rplan.n_dop == fft_len != lr.rplan.n_pulses
    return cfg, lr, lr.signal_factors(TargetBatch.make(*TARGETS))


@pytest.mark.cuda
@pytest.mark.parametrize("mul", ["f32", "bf16"])
@pytest.mark.parametrize("fft_len", FFT_LENS)
def test_k1_at_fft_len_matches_plain_on_card(cuda_device, fft_len, mul):
    """K1 at V != P, draw mode with the signal and the pair maps, against
    its plain version (RMS of the difference within 1e-5 of the RMS at f32,
    BF16_HOLD at bf16) and its planes mode on the plain Philox planes bit
    for bit; the maps those of its map bit for bit, the padded Doppler rows
    zero; bf16 output the map rounded; each part counted."""
    _, lr, factors = _fft_stages(cuda_device, fft_len)
    plan, lmat = lr.rplan, lr.l_factor
    md = _MUL[mul]
    seed = (3, 5)
    planes = nr.philox_planes(plan, seed, 5, device=cuda_device)
    ref, ref_maps = nr.noise_rdm_plain(plan, lmat, planes, factors,
                                       mul_dtype=md, emit_maps=True)
    names = ("launch_count", "k1_bf16_launch_count", "dft_launch_count",
             "mix_launch_count", "tf32_dft_launch_count",
             "k1c_draw_launch_count")
    before = {n: getattr(nr, n) for n in names}
    kw = dict(layout="bvg", mul_dtype=md)
    y, maps = nr.noise_rdm(plan, lmat, factors, seed=seed, emit_maps=True,
                           **kw)
    fed = nr.noise_rdm(plan, lmat, factors, planes=planes, **kw)
    y16 = nr.noise_rdm(plan, lmat, factors, seed=seed,
                       out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    got = {n: getattr(nr, n) - before[n] for n in names}
    bf = mul == "bf16"
    assert got == {"launch_count": 3, "k1_bf16_launch_count": 3 * bf,
                   "dft_launch_count": 3 * bf, "mix_launch_count": 3 * bf,
                   "tf32_dft_launch_count": 3 * (not bf),
                   "k1c_draw_launch_count": 2}
    assert y.shape == (5, fft_len, plan.n_gates)
    assert torch.equal(y, fed)
    assert torch.equal(y16, nr.round_mul(y, torch.bfloat16))
    assert torch.equal(maps, nr.pair_maps_plain(y))
    assert not maps[:, fft_len:].any()
    hold = BF16_HOLD if bf else 1e-5
    assert _rms(y - ref) <= hold * _rms(ref)
    inner = lambda m: m[:, :fft_len, ck.HALO:ck.HALO + plan.n_gates]
    assert _rms(inner(maps) - inner(ref_maps)) <= hold * _rms(inner(ref_maps))


@pytest.mark.cuda
@pytest.mark.parametrize("mul", ["f32", "bf16"])
@pytest.mark.parametrize("fft_len", FFT_LENS)
def test_k4_at_fft_len_on_card(cuda_device, fft_len, mul):
    """K4 at V != P with the signal: within K1's hold of its plain version
    (at bf16 equal to K1 bit for bit, as at V = P); one K4 launch a call."""
    _, lr, factors = _fft_stages(cuda_device, fft_len)
    plan, lmat = lr.rplan, lr.l_factor
    md = _MUL[mul]
    seed = (4, 8)
    ref = nr.noise_rdm_plain(plan, lmat, nr.philox_planes(
        plan, seed, 5, device=cuda_device), factors, mul_dtype=md)
    before = nr.k4_launch_count
    got = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg",
                       rolling=False, mul_dtype=md)
    k1 = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg",
                      mul_dtype=md)
    torch.cuda.synchronize()
    assert nr.k4_launch_count == before + 1
    assert got.shape == (5, fft_len, plan.n_gates)
    assert _rms(got - ref) <= (BF16_HOLD if mul == "bf16" else 1e-5) * _rms(ref)
    if mul == "bf16":
        assert torch.equal(got, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("mul", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["resident", "stacked", "allbeams"])
@pytest.mark.parametrize("fft_len", FFT_LENS)
def test_rdm_variants_at_fft_len_on_card(cuda_device, fft_len, variant, mul):
    """K10, K7 and K9 at V != P with the signal against the plain version
    at the same multiply type (1e-5 RMS at f32, BF16_HOLD at bf16); one
    launch of the schedule a call."""
    _, lr, factors = _fft_stages(cuda_device, fft_len)
    md = _MUL[mul]
    planes = nr.philox_planes(lr.rplan, (3, 5), 5, device=cuda_device)
    ref = nr.noise_rdm_plain(lr.rplan, lr.l_factor, planes, factors,
                             mul_dtype=md)
    before = getattr(nr, _COUNTER[variant])
    got = nr.noise_rdm(lr.rplan, lr.l_factor, factors, planes=planes,
                       variant=variant, mul_dtype=md, layout="bvg")
    torch.cuda.synchronize()
    assert getattr(nr, _COUNTER[variant]) == before + 1
    assert got.shape == (5, fft_len, lr.rplan.n_gates)
    assert _rms(got - ref) <= (BF16_HOLD if mul == "bf16" else 1e-5) * _rms(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fft_len", FFT_LENS)
def test_k2_and_frame_at_fft_len_on_card(cuda_device, fft_len):
    """K2 over V != P Doppler rows of K1's pair maps: mask and row counts
    identical to its plain version; the perf frame at V != P on the card
    (K1 at bf16 once; K2 in the tail's CUDA graph, its wrapper called at
    the eager warm-up and the capture, then one replay) and on the CPU at
    the accelerator's dtypes: same final targets within rtol 1e-3 (the
    noise's bf16 roundings come after sums in other orders)."""
    from radar_tpu_torch.pipeline import frame

    cfg, lr, factors = _fft_stages(cuda_device, fft_len)
    num_g = lr.rplan.n_gates
    _, maps = nr.noise_rdm(lr.rplan, lr.l_factor, factors, seed=(3, 5),
                           layout="bvg", mul_dtype=torch.bfloat16,
                           emit_maps=True)
    before = ck.launch_count
    mask, rc = ck.goca_cfar_qvg(maps, cfg.cfar, num_g, fft_len)
    mask_p, rc_p = ck.goca_cfar_qvg_plain(maps, cfg.cfar, num_g, fft_len)
    torch.cuda.synchronize()
    assert ck.launch_count == before + 1
    assert torch.equal(mask, mask_p) and torch.equal(rc, rc_p)
    assert int(mask.sum()) >= 1
    tb = TargetBatch.make(*TARGETS)
    before = (nr.launch_count, nr.k1_bf16_launch_count, ck.launch_count,
              frame.tail_graph_captures, frame.tail_graph_replays)
    a = make_frame_processor(cfg, device=cuda_device)(5, tb)
    torch.cuda.synchronize()
    assert (nr.launch_count, nr.k1_bf16_launch_count, ck.launch_count,
            frame.tail_graph_captures, frame.tail_graph_replays) == (
        before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 1,
        before[4] + 1)
    b = make_frame_processor(cfg, device="cpu", accelerator_dtypes=True)(5, tb)
    assert int(a.num_final) == int(b.num_final) >= 2
    _assert_same_rows(_rows(a), _rows(b), rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["run", "trials"])
def test_sync_spans_match_the_cards_sync_count(cuda_device, kind):
    """A 3-frame multi-frame run and a batch of 3 trials on the reference
    stream: the program's ``rt.sync`` spans equal the host's
    synchronisations that ``torch.cuda.set_sync_debug_mode("warn")``
    reports over the same work (not counting the mode's own notice that
    it is a prototype)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from radar_tpu_torch.pipeline.driver import run_multiframe
    from radar_tpu_torch.pipeline.montecarlo import make_trial_fn

    cfg = small_test_config()
    tb = TargetBatch.make(*TARGETS)
    if kind == "run":
        process = make_frame_processor(cfg, device=cuda_device)
        work = lambda seed: run_multiframe(cfg, tb, 3, seed=seed,
                                           processor=process,
                                           device=cuda_device)
    else:
        trials = make_trial_fn(cfg, device=cuda_device)
        work = lambda seed: trials(tb, [seed, seed + 1, seed + 2])
    work(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                work(5)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message)
                and "prototype" not in str(w.message) for w in caught)
    spans = [e for e in prof.events() if e.name == "rt.sync"
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert syncs >= 3 * 3
    assert len(spans) == syncs


# ------------------------------------------------ the connected-labels kernel


def _label_fields(seed, n, nf, span=20.0, frac=0.8):
    rng = np.random.default_rng(seed)
    return ([((rng.random(n) * span).astype(np.float32), 1.5)
             for _ in range(nf)], rng.random(n) < frac)


def _label_chain(order):
    x = np.empty(len(order), np.float32)
    x[order] = np.arange(len(order), dtype=np.float32)
    return [(x, 1.0)], np.ones(len(order), bool)


def _label_cases():
    """(fields [(f32 [n], gate)], valid [n]): random graphs, the permuted
    chains of test_torch_tail.py, 512-slot paths of diameter 511,
    differences that land on the gate in f32, all invalid, n = 1, n off
    the kernel's 1024-thread block (517), and the most slots it takes
    (``MAX_SLOTS``, 1024)."""
    rng = np.random.default_rng(5)
    cases = {f"random96_{s}": _label_fields(s, 96, 2) for s in range(3)}
    cases["random512_3f"] = _label_fields(3, 512, 3)
    cases["random512_dense"] = _label_fields(4, 512, 2, span=8.0, frac=0.95)
    cases["chain7"] = _label_chain(np.array([1, 4, 2, 3, 6, 5, 0]))
    for i in range(20):
        cases[f"chain128_{i}"] = _label_chain(rng.permutation(128))
    cases["path512"] = _label_chain(rng.permutation(512))
    cases["path512_reversed"] = _label_chain(np.arange(512)[::-1])
    x = np.concatenate([np.arange(12, dtype=np.float32) * np.float32(0.25),
                        np.float32([100.0, 100.0 + np.float32(0.1), 200.0])])
    y = np.concatenate([np.zeros(12, np.float32), np.float32([0, 0.1, 0])])
    cases["on_gate"] = ([(x, 0.25), (y, 0.1)], np.ones(15, bool))
    cases["all_invalid"] = ([(np.zeros(512, np.float32), 1.0)],
                            np.zeros(512, bool))
    cases["one_slot"] = ([(np.float32([2.0]), 1.0)], np.ones(1, bool))
    cases["n517"] = _label_fields(6, 517, 3)
    cases["n1024"] = _label_fields(7, 1024, 3, span=60.0)
    return cases


@pytest.mark.cuda
def test_connected_kernel_equals_the_eager_labels_on_card(cuda_device):
    """The kernel's labels equal ``connected_labels(gate_adjacency(.))``
    on the card bit for bit, one launch a call."""
    from radar_tpu_torch.cluster import connected as cc

    for name, (fields, valid) in _label_cases().items():
        t = [(torch.from_numpy(f).to(cuda_device), g) for f, g in fields]
        ok = torch.from_numpy(valid).to(cuda_device)
        before = cc.launch_count
        got = cc.gated_labels(t, ok)
        assert cc.launch_count == before + 1, name
        want = cc.connected_labels(cc.gate_adjacency(t, ok), ok)
        assert got.dtype == torch.int64
        assert torch.equal(got, want), name
        if name.startswith(("chain", "path")):
            assert set(got.tolist()) == {0}


@pytest.mark.cuda
def test_connected_kernel_refuses_past_its_slots_on_card(cuda_device):
    """Past ``MAX_SLOTS`` the kernel's wrapper raises, and launches
    nothing."""
    from radar_tpu_torch.cluster import connected as cc

    fields, valid = _label_fields(7, cc.MAX_SLOTS + 1, 2, span=60.0)
    t = [(torch.from_numpy(f).to(cuda_device), g) for f, g in fields]
    ok = torch.from_numpy(valid).to(cuda_device)
    before = cc.launch_count
    with pytest.raises(ValueError, match="at most 1024 slots"):
        cc.gated_labels(t, ok)
    assert cc.launch_count == before


# ------------------------------------------------------ the tail's CUDA graph

def _matmul_means(cfg):
    import dataclasses

    return cfg.replace(cfar=dataclasses.replace(cfg.cfar,
                                                means_impl="matmul"))


def _pair_mode(cfg):
    import dataclasses

    return cfg.replace(cluster=dataclasses.replace(cfg.cluster,
                                                   keep_pair_mode=True))


_REF = small_test_config()
_TAIL_CFGS = {
    "vgq": _REF,
    "vgq_from_rdm": _REF.replace(tail_from_rdm=True),
    "qvg_k2": _REF.replace(use_pallas_cfar=True),
    "vgq_matmul": _matmul_means(_REF),
    "native_scan": _REF.replace(extract_native_scan=True),
    "monopulse_complex_pair_mode": _pair_mode(_REF.replace(
        monopulse_complex=True)),
    "monopulse_refined": _REF.replace(monopulse_refined=True),
    "rank_k_qvg": CFG,
    "rank_k_matmul": _matmul_means(CFG),
    "kernel_maps": CFG.replace(kernel_maps=True),
    "kernel_maps_matmul": _matmul_means(CFG.replace(kernel_maps=True)),
    "qgv": CFG.replace(beams_major_tail=True),
}


def _tail_input(st, tb, seed):
    """(rdm, layout, maps_p) of one frame of the stage set ``st``."""
    lr = st.lowrank
    if lr is None:
        return st.chain(st.synth(tb), seed)[-1], "vgb", None
    if st.tail == "kernel_maps":
        rdm, maps_p = lr.noise_rdm_sig(seed, tb, layout="bvg",
                                       emit_maps=True)
        return rdm, "bvg", maps_p
    return (lr.noisy_rdm(lr.signal_rdm(tb, lr.rdm_layout), seed, None, None),
            lr.rdm_layout, None)


def _same_result(a, b) -> bool:
    leaves = lambda r: (*r.targets, r.num_raw_detections, r.num_final)
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_TAIL_CFGS))
def test_tail_graph_replays_equal_the_eager_tail_on_card(cuda_device, case,
                                                        monkeypatch):
    """On each tail a replayed FrameResult equals the eager one bit for bit
    over 4 seeds: on the same RDM through ``detect``, and through the frame
    processor and the trial function against twins whose stages have no
    graphs. One capture a stage set and key, one replay a call; the
    results of successive calls stay intact (no two share memory)."""
    from radar_tpu_torch.pipeline import frame, montecarlo

    cfg, tb, seeds = _TAIL_CFGS[case], TargetBatch.make(*TARGETS), [3, 4, 5, 6]
    st = frame.make_frame_stages(cfg, device=cuda_device)
    eager = st._replace(graphs=None)
    caps, reps = frame.tail_graph_captures, frame.tail_graph_replays
    for s in seeds:
        rdm, layout, maps_p = _tail_input(st, tb, s)
        out = st.detect(rdm, layout, maps_p)
        assert out[:4] == (None,) * 4
        assert _same_result(out[-1], eager.detect(rdm, layout, maps_p)[-1])
    assert len(st.graphs) == 1
    process = frame.make_frame_processor(cfg, device=cuda_device)
    trials = montecarlo.make_trial_fn(cfg, device=cuda_device)
    got = [process(s, tb) for s in seeds]
    got_t = trials(tb, seeds)
    assert frame.tail_graph_captures == caps + 3
    assert frame.tail_graph_replays == reps + 3 * len(seeds)
    assert len({r.targets.range_m.data_ptr() for r in got}) == len(seeds)
    real = frame.make_frame_stages
    no_graphs = lambda *a, **k: real(*a, **k)._replace(graphs=None)
    monkeypatch.setattr(frame, "make_frame_stages", no_graphs)
    monkeypatch.setattr(montecarlo, "make_frame_stages", no_graphs)
    want = [frame.make_frame_processor(cfg, device=cuda_device)(s, tb)
            for s in seeds]
    want_t = montecarlo.make_trial_fn(cfg, device=cuda_device)(tb, seeds)
    assert frame.tail_graph_replays == reps + 3 * len(seeds)
    for g, w in zip(got, want):
        assert _same_result(g, w) and int(g.num_final) >= 2
    for g, w in zip(got_t, want_t):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vgq", "kernel_maps"])
def test_tail_replay_makes_no_host_sync_on_card(cuda_device, case):
    """After its capture, a tail's replay (copy-in, replay, clones) runs
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    from radar_tpu_torch.pipeline import frame

    st = frame.make_frame_stages(_TAIL_CFGS[case], device=cuda_device)
    rdm, layout, maps_p = _tail_input(st, TargetBatch.make(*TARGETS), 3)
    st.detect(rdm, layout, maps_p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = st.detect(rdm, layout, maps_p)[-1]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(res.num_final) >= 2


@pytest.mark.cuda
def test_tail_graph_one_capture_a_stage_set_and_key_on_card(cuda_device):
    """A stage set captures once a key (another RDM shape, another
    layout of the same values) and replays every call; another stage set
    captures its own. The kernels' wrappers count their real calls: at a
    capture K3 twice and the connected labels four times (the eager
    warm-up, then the capture), at a replay none."""
    from radar_tpu_torch.cluster import connected as cc
    from radar_tpu_torch.pipeline import frame

    cfg, tb = small_test_config(), TargetBatch.make(*TARGETS)
    st = frame.make_frame_stages(cfg, device=cuda_device)
    rdm = _tail_input(st, tb, 3)[0]
    narrow = rdm[:, :rdm.shape[1] - 40]
    inputs = [rdm, rdm, narrow, narrow.clone(), rdm, narrow]
    caps, reps = frame.tail_graph_captures, frame.tail_graph_replays
    for i, x in enumerate(inputs):
        before = (ck.k3_launch_count, cc.launch_count)
        st.detect(x, "vgb")
        calls = 2 if i in (0, 2, 3) else 0
        assert (ck.k3_launch_count, cc.launch_count) == (
            before[0] + calls, before[1] + 2 * calls), i
    # keys: rdm; the narrow view; its contiguous copy (other strides)
    assert frame.tail_graph_captures == caps + 3 == caps + len(st.graphs)
    assert frame.tail_graph_replays == reps + len(inputs)
    other = frame.make_frame_stages(cfg, device=cuda_device)
    other.detect(rdm, "vgb")
    assert frame.tail_graph_captures == caps + 4 and len(other.graphs) == 1


@pytest.mark.cuda
def test_tail_graph_keeps_the_banded_means_matrix_on_card(cuda_device):
    """A matmul-means tail's graph reads the banded means matrix at its
    address; the matrix outlives more other cached matrices than a
    bounded cache would hold, and the memory freed around it rewritten,
    so a later replay equals the eager tail bit for bit."""
    from radar_tpu_torch.ops import cfar
    from radar_tpu_torch.pipeline import frame

    cfg, tb = _TAIL_CFGS["vgq_matmul"], TargetBatch.make(*TARGETS)
    st = frame.make_frame_stages(cfg, device=cuda_device)
    rdm, layout, maps_p = _tail_input(st, tb, 3)
    st.detect(rdm, layout, maps_p)
    p = cfg.cfar
    for tile in range(129, 161):
        cfar._banded_means_tensor(p.guard_cells_r, p.ref_cells_r, tile,
                                  torch.float32, rdm.device)
    shape = cfar._banded_means_matrix(p.guard_cells_r, p.ref_cells_r,
                                      128).shape
    junk = [torch.full(shape, 1e6, device=rdm.device) for _ in range(64)]
    torch.cuda.synchronize()
    del junk
    rdm, layout, maps_p = _tail_input(st, tb, 4)
    got = st.detect(rdm, layout, maps_p)[-1]
    want = st._replace(graphs=None).detect(rdm, layout, maps_p)[-1]
    assert _same_result(got, want) and int(got.num_final) >= 2
