"""Per-detection parameter estimation: spline peak refinement + amplitude
monopulse — port of ``radar_tpu/measure/estimate.py``.

Reference (fun_process_single_frame.m:226-299): for each detection the
+/-extra_dots stencil of the pair-sum map is upsampled with MATLAB's
not-a-knot 'spline' (8x in range, 4x in Doppler) and the peak offset
refines range and velocity; the angle is amplitude monopulse on the two
member beams at the INTEGER indices (the reference's documented flaw, kept
as the default; ``monopulse_refined`` evaluates each member beam's spline
surface at the refined subcell position instead, and ``monopulse_complex``
takes the ratio of the complex RDM values, the v7.6 variant). Spline
interpolation is linear in the data, so each upsample is one small matmul
against a precomputed matrix.
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


_MAPS_AXES = {"vgq": (0, 1), "qvg": (1, 2), "qgv": (2, 1)}  # (Doppler, range)


def _stencil_gather(maps: torch.Tensor, v_idx, r_idx, pair_idx, extra: int,
                    axis: str, layout: str) -> torch.Tensor:
    """+/-extra stencil of a pair-sum map ([V, G, pairs] "vgq", [pairs, V,
    G] "qvg" or [pairs, G, V] "qgv") along range ('r', clipped to the map)
    or Doppler ('v', wrapped: the fftshifted Doppler axis is circular) ->
    [cap, 2e+1]."""
    offs = torch.arange(-extra, extra + 1, device=maps.device)
    v_ax, r_ax = _MAPS_AXES[layout]
    if axis == "r":
        r = (r_idx[:, None] + offs[None, :]).clamp(0, maps.shape[r_ax] - 1)
        v = v_idx[:, None]
    else:
        r = r_idx[:, None]
        v = torch.remainder(v_idx[:, None] + offs[None, :], maps.shape[v_ax])
    p = pair_idx[:, None]
    if layout == "qvg":
        return maps[p, v, r]
    return maps[p, r, v] if layout == "qgv" else maps[v, r, p]


def _stencil_gather_rdm(rdm: torch.Tensor, v_idx, r_idx, pair_idx,
                        extra: int, axis: str) -> torch.Tensor:
    """The pair-sum stencil gathered pointwise from the complex [V, G,
    beams] RDM: |rdm[.., p]| + |rdm[.., p+1]| at the cells
    ``_stencil_gather`` reads from the maps (the same values;
    ``cfg.tail_from_rdm``)."""
    offs = torch.arange(-extra, extra + 1, device=rdm.device)
    if axis == "r":
        r = (r_idx[:, None] + offs[None, :]).clamp(0, rdm.shape[1] - 1)
        v = v_idx[:, None]
    else:
        r = r_idx[:, None]
        v = torch.remainder(v_idx[:, None] + offs[None, :], rdm.shape[0])
    p = pair_idx[:, None]
    return rdm[v, r, p].abs() + rdm[v, r, p + 1].abs()


def _spline_peak_offset(stencil: torch.Tensor, q: torch.Tensor, times: int,
                        extra: int):
    """Peak offset in cells (in [-extra, extra]) of the upsampled stencil
    and its index on the upsampled grid (first maximum on ties)."""
    up = stencil @ q.T
    i = torch.argmax(up, dim=1)
    return i.to(stencil.dtype) / times - extra, i


def _stencil_gather_2d(rdm: torch.Tensor, beam, v_idx, r_idx, extra: int,
                       layout: str) -> torch.Tensor:
    """[cap, 2e+1 (v), 2e+1 (r)] stencil of one beam's complex RDM around
    each detection (range clipped, Doppler wrapped, as the 1D gathers)."""
    offs = torch.arange(-extra, extra + 1, device=rdm.device)
    v_ax, r_ax = (1, 2) if layout == "bvg" else (0, 1)
    vc = torch.remainder(v_idx[:, None] + offs[None, :], rdm.shape[v_ax])
    rc = (r_idx[:, None] + offs[None, :]).clamp(0, rdm.shape[r_ax] - 1)
    b = beam[:, None, None]
    if layout == "bvg":
        return rdm[b, vc[:, :, None], rc[:, None, :]]
    return rdm[vc[:, :, None], rc[:, None, :], b]


def _value_at_refined(st2: torch.Tensor, q_r: torch.Tensor,
                      q_v: torch.Tensor, i_r, i_v) -> torch.Tensor:
    """The separable spline surface of a [cap, 2e+1 (v), 2e+1 (r)] stencil
    at the upsampled-grid indices (i_v, i_r) found on the sum map: the
    range upsample, its column i_r, then the Doppler upsample at i_v."""
    cap = st2.shape[0]
    rows = torch.einsum("cvr,qr->cvq", st2, q_r)
    at_r = rows[torch.arange(cap, device=st2.device)[:, None],
                torch.arange(st2.shape[1], device=st2.device)[None, :],
                i_r[:, None]]                                # [cap, 2e+1]
    cols = at_r @ q_v.T
    return cols[torch.arange(cap, device=st2.device), i_v]


def estimate_parameters(dets: Detections, pair_maps: torch.Tensor | None,
                        rdm: torch.Tensor, consts, extra_dots: int,
                        r_times: int, v_times: int, layout: str = "vgb",
                        maps_layout: str | None = None, *,
                        monopulse_complex: bool = False,
                        monopulse_refined: bool = False) -> ParamDetections:
    """``rdm``: [V, G, beams] ("vgb") or [beams, V, G] ("bvg") complex;
    ``pair_maps``: [V, G, pairs] ("vgq"), [pairs, V, G] ("qvg") or [pairs,
    G, V] ("qgv"), by default "qgv" with a "bvg" rdm and "vgq" otherwise;
    ``pair_maps=None`` gathers the stencils from a "vgb" rdm
    (``cfg.tail_from_rdm``). ``consts``: ``pipeline.frame.MeasureConsts``
    on the rdm's device."""
    if layout not in ("vgb", "bvg"):
        raise ValueError(f"unknown rdm layout {layout!r}")
    if maps_layout is None:
        maps_layout = "qgv" if layout == "bvg" else "vgq"
    from_rdm = pair_maps is None
    if from_rdm and layout != "vgb":
        raise ValueError("pair_maps=None (tail_from_rdm) needs rdm layout "
                         "'vgb'")
    f32 = torch.float32
    q_r = consts.q_range.to(f32)
    q_v = consts.q_vel.to(f32)

    def gather(axis):
        if from_rdm:
            st = _stencil_gather_rdm(rdm, dets.v_idx, dets.r_idx,
                                     dets.pair_idx, extra_dots, axis)
        else:
            st = _stencil_gather(pair_maps, dets.v_idx, dets.r_idx,
                                 dets.pair_idx, extra_dots, axis,
                                 maps_layout)
        return st.to(f32)

    off_r, i_r = _spline_peak_offset(gather("r"), q_r, r_times, extra_dots)
    est_range = consts.range_axis[dets.r_idx] + off_r * consts.delta_r
    off_v, i_v = _spline_peak_offset(gather("v"), q_v, v_times, extra_dots)
    est_vel = consts.velocity_axis[dets.v_idx] + off_v * consts.delta_v

    p, v, r = dets.pair_idx, dets.v_idx, dets.r_idx
    if monopulse_refined:
        # each member beam's spline surface at the refined subcell position
        # found on the sum map (the flaw-fixed variant)
        st_a = _stencil_gather_2d(rdm, p, v, r, extra_dots, layout)
        st_b = _stencil_gather_2d(rdm, p + 1, v, r, extra_dots, layout)
        if not monopulse_complex:
            st_a, st_b = st_a.abs().to(f32), st_b.abs().to(f32)
        qr, qv = q_r.to(st_a.dtype), q_v.to(st_a.dtype)
        s_a = _value_at_refined(st_a, qr, qv, i_r, i_v)
        s_b = _value_at_refined(st_b, qr, qv, i_r, i_v)
    else:
        # monopulse at the integer indices (reference flaw preserved)
        if layout == "bvg":
            s_a, s_b = rdm[p, v, r], rdm[p + 1, v, r]
        else:
            s_a, s_b = rdm[v, r, p], rdm[v, r, p + 1]
        if not monopulse_complex:
            s_a, s_b = s_a.abs(), s_b.abs()
    eps = torch.finfo(f32).eps
    ratio = (s_a - s_b) / (s_a + s_b + eps)
    if ratio.is_complex():
        ratio = ratio.real
    ang = consts.beam_angles_deg
    mid = 0.5 * (ang[p] + ang[p + 1])
    est_angle = mid + consts.k_slopes_lut[p] * ratio

    zero = torch.zeros((), dtype=f32, device=rdm.device)
    w = lambda x: torch.where(dets.valid, x.to(f32), zero)
    return ParamDetections(range_m=w(est_range), velocity_ms=w(est_vel),
                           angle_deg=w(est_angle), power=w(dets.amp),
                           pair_idx=dets.pair_idx, valid=dets.valid)
