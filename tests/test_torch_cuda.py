"""PyTorch port on the card: kernels K1, K2, K3 and K5 against their plain
PyTorch versions, and the perf-config and reference-stream frames through
the kernels against the plain path on the CPU. Marked ``cuda``; each test
skips without an NVIDIA GPU.

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
