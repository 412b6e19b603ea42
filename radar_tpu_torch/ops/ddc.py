"""Digital down-conversion: mixing, decimation low-pass, downsampling —
port of ``radar_tpu/ops/ddc.py`` (reference simulation_learn.m:94-110).

The reference's pedagogy chain: mix the RF echo to baseband, causal-filter
with the measured 12-tap low-pass (``FIR.mat`` variable ``Num``) to remove
the mixing image, and downsample by 4. Batched over every leading axis;
the FIR is one ``conv1d`` over the real and imaginary planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import assets


def _is_f64(x: torch.Tensor) -> bool:
    return x.dtype in (torch.float64, torch.complex128)


def mix_to_baseband(x: torch.Tensor, carrier_freq: float, fs: float,
                    phase: float = 0.0) -> torch.Tensor:
    """Multiply by exp(-j*2*pi*f0*t) along the last axis. The LO is
    complex128 for a float64/complex128 input, complex64 otherwise."""
    n = x.shape[-1]
    t = np.arange(n) / fs
    lo = np.exp(-1j * (2 * np.pi * carrier_freq * t + phase))
    dtype = torch.complex128 if _is_f64(x) else torch.complex64
    return x * torch.as_tensor(lo, dtype=dtype, device=x.device)


def decimation_filter(x: torch.Tensor, taps=None) -> torch.Tensor:
    """Causal FIR along the last axis (MATLAB ``filter(Num, 1, x)``) with
    the measured decimation taps by default; the taps take the input's
    real dtype."""
    h = np.asarray(assets.ddc_fir_taps() if taps is None else taps)
    real = x.real.dtype if x.is_complex() else x.dtype
    lh = len(h)
    # conv1d correlates: y[i] = sum_j w[j] xp[i + j], so w = h reversed
    w = torch.as_tensor(np.ascontiguousarray(h[::-1]), dtype=real,
                        device=x.device).reshape(1, 1, lh)
    planes = torch.view_as_real(x).movedim(-1, 0) if x.is_complex() \
        else x[None]
    lead = planes.shape[:-1]
    flat = planes.reshape(-1, 1, planes.shape[-1])
    y = torch.nn.functional.conv1d(
        torch.nn.functional.pad(flat, (lh - 1, 0)), w).reshape(
        lead + (planes.shape[-1],))
    if x.is_complex():
        return torch.complex(y[0], y[1])
    return y[0]


def downsample(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Keep every ``factor``-th sample (MATLAB ``downsample``)."""
    return x[..., ::factor]


def ddc(x: torch.Tensor, carrier_freq: float, fs: float,
        factor: int = 4) -> torch.Tensor:
    """Full chain: mix -> decimation low-pass -> downsample."""
    return downsample(decimation_filter(mix_to_baseband(x, carrier_freq,
                                                        fs)), factor)
