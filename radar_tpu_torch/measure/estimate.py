"""Per-detection parameter estimation: spline peak refinement + amplitude
monopulse — port of ``radar_tpu/measure/estimate.py:33-80, 103-111, 144-235``.

Reference (fun_process_single_frame.m:226-299): for each detection the
+/-extra_dots stencil of the pair-sum map is upsampled with MATLAB's
not-a-knot 'spline' (8x in range, 4x in Doppler) and the peak offset
refines range and velocity; the angle is amplitude monopulse on the two
member beams at the INTEGER indices (the reference's documented flaw, kept
as the default). Spline interpolation is linear in the data, so each
upsample is one small matmul against a precomputed matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cfar import Detections


class ParamDetections(NamedTuple):
    range_m: torch.Tensor
    velocity_ms: torch.Tensor
    angle_deg: torch.Tensor
    power: torch.Tensor
    pair_idx: torch.Tensor
    valid: torch.Tensor


def _stencil_gather(maps: torch.Tensor, v_idx, r_idx, pair_idx, extra: int,
                    axis: str, layout: str) -> torch.Tensor:
    """+/-extra stencil of a pair-sum map ([pairs, V, G] "qvg" or
    [V, G, pairs] "vgq") along range ('r', clipped to the map) or Doppler
    ('v', wrapped: the fftshifted Doppler axis is circular) -> [cap, 2e+1]."""
    offs = torch.arange(-extra, extra + 1, device=maps.device)
    v_ax, r_ax = (1, 2) if layout == "qvg" else (0, 1)
    if axis == "r":
        r = (r_idx[:, None] + offs[None, :]).clamp(0, maps.shape[r_ax] - 1)
        v = v_idx[:, None]
    else:
        r = r_idx[:, None]
        v = torch.remainder(v_idx[:, None] + offs[None, :], maps.shape[v_ax])
    p = pair_idx[:, None]
    return maps[p, v, r] if layout == "qvg" else maps[v, r, p]


def _spline_peak_offset(stencil: torch.Tensor, q: torch.Tensor, times: int,
                        extra: int):
    """Peak offset in cells (in [-extra, extra]) of the upsampled stencil
    and its index on the upsampled grid (first maximum on ties)."""
    up = stencil @ q.T
    i = torch.argmax(up, dim=1)
    return i.to(stencil.dtype) / times - extra, i


def estimate_parameters(dets: Detections, pair_maps: torch.Tensor,
                        rdm: torch.Tensor, consts, extra_dots: int,
                        r_times: int, v_times: int, layout: str = "vgb",
                        maps_layout: str = "qvg") -> ParamDetections:
    """``rdm``: [V, G, beams] ("vgb") or [beams, V, G] ("bvg") complex;
    ``pair_maps``: [pairs, V, G] ("qvg", the kernel-CFAR tail) or
    [V, G, pairs] ("vgq", the default tail); ``consts``:
    ``pipeline.frame.MeasureConsts`` on the rdm's device."""
    if maps_layout not in ("qvg", "vgq"):
        raise NotImplementedError(f"maps_layout={maps_layout!r} is not "
                                  "ported (the port runs 'qvg' and 'vgq')")
    f32 = torch.float32
    q_r = consts.q_range.to(f32)
    q_v = consts.q_vel.to(f32)
    gather = lambda axis: _stencil_gather(
        pair_maps, dets.v_idx, dets.r_idx, dets.pair_idx, extra_dots,
        axis, maps_layout).to(f32)
    off_r, _ = _spline_peak_offset(gather("r"), q_r, r_times, extra_dots)
    est_range = consts.range_axis[dets.r_idx] + off_r * consts.delta_r
    off_v, _ = _spline_peak_offset(gather("v"), q_v, v_times, extra_dots)
    est_vel = consts.velocity_axis[dets.v_idx] + off_v * consts.delta_v

    # monopulse at the integer indices (reference flaw preserved)
    p, v, r = dets.pair_idx, dets.v_idx, dets.r_idx
    if layout == "bvg":
        s_a, s_b = rdm[p, v, r].abs(), rdm[p + 1, v, r].abs()
    elif layout == "vgb":
        s_a, s_b = rdm[v, r, p].abs(), rdm[v, r, p + 1].abs()
    else:
        raise ValueError(f"unknown rdm layout {layout!r}")
    eps = torch.finfo(f32).eps
    ratio = (s_a - s_b) / (s_a + s_b + eps)
    ang = consts.beam_angles_deg
    mid = 0.5 * (ang[p] + ang[p + 1])
    est_angle = mid + consts.k_slopes_lut[p] * ratio

    zero = torch.zeros((), dtype=f32, device=rdm.device)
    w = lambda x: torch.where(dets.valid, x.to(f32), zero)
    return ParamDetections(range_m=w(est_range), velocity_ms=w(est_vel),
                           angle_deg=w(est_angle), power=w(dets.amp),
                           pair_idx=dets.pair_idx, valid=dets.valid)
