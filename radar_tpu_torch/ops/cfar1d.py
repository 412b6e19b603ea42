"""Real-data-style segmented 1D CA-GO/SO CFAR — port of
``radar_tpu/ops/cfar1d.py`` (SURVEY.md section 2.1 "CFAR detector
(real-data style)").

Reconstructed by the reference package from the inline copies in the
reference's debug harness:

  - ``local_execute_cfar`` (debug_simulated_data_processing_v2.m:419-440):
    split the 3404 range gates into the three pulse segments
    [228 | 723 | 2453] and CFAR each independently.
  - ``executeCFAR_2D`` (:442-462): mask a zero-velocity clutter band of
    +/- MTD_0v_num Doppler rows around the (1-based) center row
    round(V/2)+1; masked rows never detect.
  - ``Function_CFAR1D_sub`` (:467-511): per range column, mean over
    ``ref`` cells beyond ``guard`` cells on each side; a side whose window
    runs off the segment edge reuses the other side's window (edge
    fallback); combine GO (max) or SO (min), or CA (average); detect on
    ``x >= T * noise``.

The window sums are the ordered shifted adds of ``ops/cfar.py``; the means
multiply them by the reciprocal of ``ref`` in the input's dtype, the form
XLA compiles the reference's division into (eager JAX divides and can
differ in the last bit). The CA average is a plain ``0.5 * (l + r)``: the
edge selects stand between the multiplies and the add, so XLA forms no
FMA there. Flags and thresholds equal jitted JAX bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import Cfar1DParams
from .cfar import _lead_trail_sums


def _segment_noise_1d(x: torch.Tensor, guard: int, ref: int, method: str,
                      axis: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge-fallback 1D CFAR noise estimate along ``axis`` and the interior
    mask (True where both windows lie fully in range: no fallback).
    Exposed for the Pfa calibration (ops/cfar_analysis.py)."""
    lead, trail = _lead_trail_sums(x, guard, ref, axis)
    inv = torch.tensor(1.0 / ref, dtype=x.dtype).item()
    lead = lead * inv
    trail = trail * inv

    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    shape = [1] * x.ndim
    shape[axis] = n
    left_ok = (idx >= guard + ref).reshape(shape)    # full left window
    right_ok = (idx < n - guard - ref).reshape(shape)

    # edge fallback: a side whose window is clipped borrows the other side
    ref_l = torch.where(left_ok, lead, trail)
    ref_r = torch.where(right_ok, trail, lead)
    if method == "GO":
        noise = torch.maximum(ref_l, ref_r)
    elif method == "SO":
        noise = torch.minimum(ref_l, ref_r)
    elif method == "CA":
        noise = 0.5 * (ref_l + ref_r)
    else:
        raise ValueError(f"unknown 1D CFAR method: {method}")
    return noise, (left_ok & right_ok).expand(x.shape)


def _t_factor(t, like: torch.Tensor):
    """A threshold factor as a scalar or a tensor broadcast ahead of
    ``like``'s axes: a [T] vector gives outputs with a leading T axis."""
    if isinstance(t, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(t, device=like.device).to(like.dtype)
        return t.reshape(t.shape + (1,) * like.ndim)
    return t


def _segment_cfar_1d(x: torch.Tensor, guard: int, ref: int, t_cfar,
                     method: str, axis: int = 1) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """1D CFAR along ``axis`` of one segment; returns (flags, threshold)."""
    noise, _ = _segment_noise_1d(x, guard, ref, method, axis)
    threshold = _t_factor(t_cfar, x) * noise
    return x >= threshold, threshold


def zero_velocity_mask(num_v: int, num_suppress: int,
                       device=None) -> torch.Tensor:
    """Boolean [V]: True where detection is allowed. Clutter band =
    +/- num_suppress rows around the 1-based center round(V/2)+1
    (executeCFAR_2D, ref :448-452); (V+1)//2 is MATLAB's half-away-from-
    zero round for every V, where Python's round is half-to-even."""
    center = (num_v + 1) // 2
    idx = torch.arange(num_v, device=device)
    return ~((idx >= center - num_suppress) & (idx <= center + num_suppress))


def segmented_cfar_1d(maps: torch.Tensor, params: Cfar1DParams,
                      gate_splits: tuple, delta_v_bin: float,
                      threshold_factor=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The real-data CFAR on [V, G(, pairs)] amplitude maps: (flags bool,
    threshold) of the same shape; clutter-band rows are always False with
    zero threshold.

    ``delta_v_bin``: velocity per Doppler bin (wavelength*prf/(2*prtNum)),
    which sizes the clutter band MTD_0v_num = floor(MTD_V/deltaV)
    (main_test_with_simulated_data.m:120-123).

    ``threshold_factor`` overrides ``params.threshold_factor``: a number, a
    0-d tensor, or a [T] vector, which gives [T, V, G(, pairs)] outputs
    from one noise estimate (the operating-curve sweep of
    ``scripts/run_roc_realdata.py``)."""
    num_v = maps.shape[0]
    n0v = int(params.mtd_zero_vel_ms / delta_v_bin)
    vshape = [1] * maps.ndim
    vshape[0] = num_v
    vmask = zero_velocity_mask(num_v, n0v, maps.device).reshape(vshape)

    t_cfar = (params.threshold_factor if threshold_factor is None
              else threshold_factor)
    flags, thresholds = [], []
    start = 0
    for width in gate_splits:
        f, t = _segment_cfar_1d(maps[:, start:start + width],
                                params.guard_cells, params.ref_cells, t_cfar,
                                params.method, axis=1)
        flags.append(f)
        thresholds.append(t)
        start += width
    axis = flags[0].ndim - maps.ndim + 1
    return (torch.cat(flags, dim=axis) & vmask,
            torch.cat(thresholds, dim=axis) * vmask)
