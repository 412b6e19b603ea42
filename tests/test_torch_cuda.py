"""PyTorch port on the card: kernels K1, K1c, K2, K3, K4, K5, K6, K7, K8,
K9 and K10 against their plain PyTorch versions (K6 on a ring of two ranks
sharing the card, through ``run_ranks``; K8 at bf16, the staging kernel
and the strip GEMM, and at f32, the staging kernel and the 3xTF32 strip
GEMM, also at ragged shapes and with probe inputs; K7's bf16 draw mode,
the strip GEMM with drawing producers, against its planes mode), the
perf-config frame (each noise-RDM route) and the reference-stream frame
through the kernels against the plain path on the CPU, and a small SNR
sweep. Marked ``cuda``; each test skips without an NVIDIA GPU.

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
def test_frame_on_card_matches_cpu(cuda_device):
    """Same seed through K1 and K2 on the card and through the plain
    versions on the CPU: same final targets within rtol 1e-4."""
    tb = TargetBatch.make(*TARGETS)
    a = make_frame_processor(CFG, device=cuda_device)(5, tb)
    b = make_frame_processor(CFG, device="cpu")(5, tb)
    assert int(a.num_final) == int(b.num_final) >= 2
    _assert_same_rows(_rows(a), _rows(b), rtol=1e-4)


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
    injected noise: same final targets within rtol 1e-4."""
    cfg = CFG.replace(noise_rdm_impl=impl, noise_dist=dist)
    tb = TargetBatch.make(*TARGETS)
    cpu = make_frame_processor(cfg, device="cpu")
    card = make_frame_processor(cfg, device=cuda_device)
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
# of the map's bytes as the build before the maps epilogue (commit 808a8af)
# wrote them on an NVIDIA H100 80GB HBM3, planes mode the same
K1_BITS_SHA256 = ("3a59303f43cbb276de8fbe500ddb51001fc1980587afc5a4c1fd6cfad0"
                  "c683c1")


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
