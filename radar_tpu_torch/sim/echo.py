"""Echo synthesis and AWGN — port of ``radar_tpu/sim/echo.py:36-292``.

The noise-free echo of one frame is rank K (one term per target), built
from per-target factor vectors shared by all three synthesizers (the
``_target_factors`` of the JAX code):

  raw[p, s, c]   = sum_k dop_amp[k, p] * base[k, s] * steer[k, c]
  beams[p, s, b] = sum_k dop_amp[k, p] * base[k, s] * (steer[k] @ mix)[b]

  base_k  = tx_pulse delayed by round(2R/c*fs) samples, zero-filled in
            front, no wraparound                      (ref :66-69)
  dop_k   = exp(+j*2*pi*(2V/lambda)*p*PRT)            (ref :57-58)
  amp_k   = sqrt(SNR_lin * P_noise / P_signal_unscaled) (ref :61-63)
  steer_k = exp(+j*c*2*pi*d*sin(El)/lambda)           (ref :71-74)

Phases are formed in float32 in the same order as the JAX code, so both
packages agree to float32 rounding. The delay is applied as an exact
integer shift (the JAX code takes it through a power-of-two FFT, which
equals the shift up to float rounding).

AWGN: the reference draws complex Gaussian noise per channel every frame
(fun_process_single_frame.m:81-88). The port draws it with ``torch.randn``
from an explicit ``torch.Generator``; JAX's threefry stream cannot be
reproduced, so tests inject the same numpy draws into both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import RadarConfig
from ..utils.profiling import host_to_device

P_NOISE_FLOOR = 1.0  # reference v8 noise floor (fun_process_single_frame.m:16)


def radar_equation_amplitude(range_m, rcs, wavelength: float,
                             gain: float = 1e8):
    """Historical v1 amplitude model, host float64:
    A = gain * sqrt(RCS * lambda^2) / (R^2 * (4*pi)^(3/2)), with the
    reference's fudge gain 1e8 (main_simulate_echoes_with_array.m:167-170).
    Pass the result as ``amplitudes=`` to a synthesizer."""
    r = np.asarray(range_m, np.float64)
    return (gain * np.sqrt(np.asarray(rcs, np.float64) * wavelength**2)
            / (r**2 * (4.0 * np.pi) ** 1.5))


def _target_factors(targets, precomp, cfg: RadarConfig, amplitudes, *,
                    device):
    """``(dop_amp [K,P], base [K,S], steer [K,C])`` complex64 tensors on
    ``device`` for a ``TargetBatch`` of host arrays."""
    sig = cfg.sig
    f32 = torch.float32
    rng = np.asarray(targets.range_m, np.float64)
    vel = np.asarray(targets.velocity_ms, np.float64)
    el = np.asarray(targets.elevation_deg, np.float64)
    if amplitudes is None:
        snr_lin = 10.0 ** (np.asarray(targets.snr_db, np.float64) / 10.0)
        amplitudes = np.sqrt(snr_lin * P_NOISE_FLOOR
                             / precomp.p_signal_unscaled)
    amp = host_to_device(np.asarray(amplitudes, np.float64)
                         .astype(np.float32), device)

    # delayed base pulse: exact zero-filled integer shift
    tx = host_to_device(np.asarray(precomp.tx_pulse), device
                        ).to(torch.complex64)
    num_s = tx.shape[0]
    delay = host_to_device(np.round(2.0 * rng / sig.c * sig.fs)
                           .astype(np.int64), device)              # [K]
    s = torch.arange(num_s, device=device)
    src = s[None, :] - delay[:, None]                               # [K,S]
    ok = ((src >= 0) & (delay[:, None] > 0) & (delay[:, None] < num_s))
    base = torch.where(ok, tx[src.clamp(min=0)],
                       torch.zeros((), dtype=tx.dtype, device=device))

    # slow-time Doppler phasor: theta = f32(f32(2*pi*PRT * fd) * p)
    fd = host_to_device((2.0 * vel / sig.wavelength).astype(np.float32),
                        device)
    w = host_to_device(2.0 * np.pi * sig.prt, device, f32)
    m = torch.arange(sig.prt_num, dtype=f32, device=device)
    theta = (w * fd)[:, None] * m[None, :]
    dop = torch.complex(torch.cos(theta), torch.sin(theta))

    # channel steering phasors: theta = f32(f32(dphi) * c)
    dphi = host_to_device(
        (2.0 * np.pi * cfg.array.element_spacing * np.sin(np.deg2rad(el))
         / sig.wavelength).astype(np.float32), device)
    n = torch.arange(sig.channel_num, dtype=f32, device=device)
    th_c = dphi[:, None] * n[None, :]
    steer = torch.complex(torch.cos(th_c), torch.sin(th_c))          # [K,C]
    return dop * amp[:, None], base, steer


def synthesize_factors(targets, precomp, cfg: RadarConfig, mix, *,
                       device, amplitudes=None):
    """Rank-K factors of the noise-free beam cube: ``(dop_amp [K,P],
    base [K,S], steer_b [K,B])``. ``mix`` is the [C,B] effective DBF
    weight matrix."""
    dop_amp, base, steer = _target_factors(targets, precomp, cfg,
                                           amplitudes, device=device)
    mix_t = torch.as_tensor(np.asarray(mix), device=device).to(
        torch.complex64)
    return dop_amp, base, steer @ mix_t


def synthesize_echoes(targets, precomp, cfg: RadarConfig, *, device,
                      amplitudes=None) -> torch.Tensor:
    """Raw IQ cube [prt_num, point_prt, channel_num] complex64 of one
    frame. ``amplitudes`` overrides the SNR-referenced amplitude model
    (e.g. ``radar_equation_amplitude``)."""
    dop_amp, base, steer = _target_factors(targets, precomp, cfg,
                                           amplitudes, device=device)
    return torch.einsum("kp,ks,kc->psc", dop_amp, base, steer).contiguous()


def synthesize_echo_beams(targets, precomp, cfg: RadarConfig, mix, *,
                          device, amplitudes=None) -> torch.Tensor:
    """Noise-free beam cube [prt_num, point_prt, beams]: synthesis and DBF
    fused, so the raw channel cube never exists (equal to
    ``dbf(synthesize_echoes(...))`` up to float reassociation)."""
    dop_amp, base, steer_b = synthesize_factors(
        targets, precomp, cfg, mix, device=device, amplitudes=amplitudes)
    return torch.einsum("kp,ks,kb->psb", dop_amp, base,
                        steer_b).contiguous()


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


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the integer ``seed``
    (mod 2^64): the source of a frame's or trial's torch draws."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def white_complex_noise(shape, generator: torch.Generator, *,
                        device) -> torch.Tensor:
    """iid CN(0,1) complex64 cube: each rail N(0, 1/2)."""
    return torch.randn(tuple(shape), dtype=torch.complex64,
                       generator=generator, device=device)


def add_noise(raw_iq: torch.Tensor, generator: torch.Generator,
              p_noise: float = P_NOISE_FLOOR) -> torch.Tensor:
    """Independent complex AWGN on every (pulse, sample, channel) cell,
    sqrt(p_noise/2) per rail (fun_process_single_frame.m:81-88)."""
    z = white_complex_noise(raw_iq.shape, generator, device=raw_iq.device)
    if p_noise != 1.0:
        z = z * float(np.float32(np.sqrt(p_noise)))
    return raw_iq + z


def add_noise_beamspace(beams: torch.Tensor, l_factor,
                        z: torch.Tensor) -> torch.Tensor:
    """Add beam-space AWGN ``z @ L.T`` for a white CN(0,1) cube z [P,S,B]
    (see ``beam_noise_factor``): distributed as per-channel AWGN passed
    through DBF."""
    lt = torch.as_tensor(l_factor, device=beams.device).to(beams.dtype)
    return beams + torch.einsum("psj,bj->psb", z.to(beams.dtype), lt)
