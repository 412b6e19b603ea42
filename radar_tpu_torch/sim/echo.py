"""Rank-K echo factors and the beam-space noise factor — port of
``radar_tpu/sim/echo.py:49-237`` (the parts the lowrank frame path uses).

The noise-free beam cube of one frame is rank K (one term per target):

  beams[p, s, b] = sum_k dop_amp[k, p] * base[k, s] * steer_b[k, b]

  base_k  = tx_pulse delayed by round(2R/c*fs) samples, zero-filled in
            front, no wraparound                      (ref :66-69)
  dop_k   = exp(+j*2*pi*(2V/lambda)*p*PRT)            (ref :57-58)
  amp_k   = sqrt(SNR_lin * P_noise / P_signal_unscaled) (ref :61-63)
  steer_b = exp(+j*c*2*pi*d*sin(El)/lambda) @ mix     (ref :71-74, DBF fused)

Phases are formed in float32 in the same order as the JAX code, so both
packages agree to float32 rounding. The delay is applied as an exact
integer shift (the JAX code takes it through a power-of-two FFT, which
equals the shift up to float rounding).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import RadarConfig

P_NOISE_FLOOR = 1.0  # reference v8 noise floor (fun_process_single_frame.m:16)


def synthesize_factors(targets, precomp, cfg: RadarConfig, mix, *,
                       device):
    """``(dop_amp [K,P], base [K,S], steer_b [K,B])`` complex64 tensors on
    ``device`` for a ``TargetBatch`` (host arrays). ``mix`` is the [C,B]
    effective DBF weight matrix."""
    sig = cfg.sig
    f32 = torch.float32
    rng = np.asarray(targets.range_m, np.float64)
    vel = np.asarray(targets.velocity_ms, np.float64)
    el = np.asarray(targets.elevation_deg, np.float64)
    snr_lin = 10.0 ** (np.asarray(targets.snr_db, np.float64) / 10.0)
    amp = torch.as_tensor(
        np.sqrt(snr_lin * P_NOISE_FLOOR / precomp.p_signal_unscaled)
        .astype(np.float32), device=device)

    # delayed base pulse: exact zero-filled integer shift
    tx = torch.as_tensor(np.asarray(precomp.tx_pulse), device=device
                         ).to(torch.complex64)
    num_s = tx.shape[0]
    delay = torch.as_tensor(np.round(2.0 * rng / sig.c * sig.fs)
                            .astype(np.int64), device=device)      # [K]
    s = torch.arange(num_s, device=device)
    src = s[None, :] - delay[:, None]                               # [K,S]
    ok = ((src >= 0) & (delay[:, None] > 0) & (delay[:, None] < num_s))
    base = torch.where(ok, tx[src.clamp(min=0)],
                       torch.zeros((), dtype=tx.dtype, device=device))

    # slow-time Doppler phasor: theta = f32(f32(2*pi*PRT * fd) * p)
    fd = torch.as_tensor((2.0 * vel / sig.wavelength).astype(np.float32),
                         device=device)
    w = torch.tensor(2.0 * np.pi * sig.prt, dtype=f32, device=device)
    m = torch.arange(sig.prt_num, dtype=f32, device=device)
    theta = (w * fd)[:, None] * m[None, :]
    dop = torch.complex(torch.cos(theta), torch.sin(theta))

    # channel steering phasors: theta = f32(f32(dphi) * c)
    dphi = torch.as_tensor(
        (2.0 * np.pi * cfg.array.element_spacing * np.sin(np.deg2rad(el))
         / sig.wavelength).astype(np.float32), device=device)
    n = torch.arange(sig.channel_num, dtype=f32, device=device)
    th_c = dphi[:, None] * n[None, :]
    steer = torch.complex(torch.cos(th_c), torch.sin(th_c))          # [K,C]
    mix_t = torch.as_tensor(np.asarray(mix), device=device).to(
        torch.complex64)
    return dop * amp[:, None], base, steer @ mix_t


def beam_noise_factor(dbf_w_effective, p_noise: float = P_NOISE_FLOOR):
    """Host Cholesky factor L [B,B] (numpy) with ``z @ L.T`` (z iid CN(0,1))
    distributed exactly as per-channel AWGN passed through DBF:
    covariance ``p_noise * M @ M^H`` for effective weights M [B,C]."""
    m = np.asarray(dbf_w_effective)
    cov = p_noise * (m @ m.conj().T)
    try:
        return np.linalg.cholesky(cov)
    except np.linalg.LinAlgError:
        # rank-deficient weight banks (synthetic configs): eigh square root
        vals, vecs = np.linalg.eigh(cov)
        return vecs * np.sqrt(np.clip(vals, 0.0, None))[None, :]
