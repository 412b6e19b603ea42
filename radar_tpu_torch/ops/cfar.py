"""2D GOCA-CFAR and first-K detection extraction — port of
``radar_tpu/ops/cfar.py:146-216, 367-454``.

Reference (fun_process_single_frame.m:172-223): on each adjacent-beam sum
map |RDM_A| + |RDM_B|, a cross-shaped greatest-of cell-averaging detector

  noise_R = max(mean(lead ref_R cells), mean(trail ref_R cells))   (range)
  noise_V = max(mean(lead ref_V cells), mean(trail ref_V cells))   (Doppler)
  threshold = T_CFAR * max(noise_R, noise_V)

with guard cells, and border cells (closer than ref+guard to an edge)
never tested. The window means are ``ref`` ordered shifted adds, as in the
reference, then a multiply by the f32 reciprocal of ``ref`` — what XLA
compiles the reference's division by the constant into (eager JAX divides,
which can differ in the last bit); the port does the same on every device
so kernel K2 can match it bit for bit.

Detections leave as a fixed-capacity list in (pair, range, velocity)
order, the order of MATLAB's column-major ``find`` per pair (ref :215-221).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config.params import CfarParams


def _shifted(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """x[i - k] along ``axis`` with zero fill (static shift)."""
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if abs(k) >= n:
        return out
    if k > 0:
        out.narrow(axis, k, n - k).copy_(x.narrow(axis, 0, n - k))
    else:
        out.narrow(axis, 0, n + k).copy_(x.narrow(axis, -k, n + k))
    return out


def lead_trail_means(x: torch.Tensor, guard: int, ref: int,
                     axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lead[i] = mean(x[i-guard-ref : i-guard]), trail[i] =
    mean(x[i+guard+1 : i+guard+ref+1]); zero fill past the edges."""
    lead = torch.zeros_like(x)
    trail = torch.zeros_like(x)
    for k in range(guard + 1, guard + ref + 1):
        lead = lead + _shifted(x, k, axis)
        trail = trail + _shifted(x, -k, axis)
    inv = float(np.float32(1.0 / ref))
    return lead * inv, trail * inv


def _combine(lead: torch.Tensor, trail: torch.Tensor,
             method: str) -> torch.Tensor:
    if method == "GOCA":
        return torch.maximum(lead, trail)
    if method == "SOCA":
        return torch.minimum(lead, trail)
    if method == "CA":
        return 0.5 * (lead + trail)
    raise ValueError(f"unknown CFAR method: {method}")


def pair_sum_maps(rdm: torch.Tensor) -> torch.Tensor:
    """|RDM| adjacent-beam sums: [V, G, B] complex -> [V, G, B-1] real."""
    mag = rdm.abs()
    return mag[:, :, :-1] + mag[:, :, 1:]


def goca_noise_and_valid(maps: torch.Tensor, params: CfarParams,
                         layout: str = "vgq"):
    """max(noise_R, noise_V) and the border-validity mask, before the
    threshold factor. ``layout`` is "vgq" ([V, G, pairs]) or "qvg"
    ([pairs, V, G])."""
    if params.means_impl != "shift":
        raise NotImplementedError(
            f"cfg.cfar.means_impl={params.means_impl!r} is not ported")
    r_axis, v_axis = {"vgq": (1, 0), "qvg": (2, 1)}[layout]
    lead_r, trail_r = lead_trail_means(maps, params.guard_cells_r,
                                       params.ref_cells_r, axis=r_axis)
    noise_r = _combine(lead_r, trail_r, params.method)
    lead_v, trail_v = lead_trail_means(maps, params.guard_cells_v,
                                       params.ref_cells_v, axis=v_axis)
    noise_v = _combine(lead_v, trail_v, params.method)
    noise = torch.maximum(noise_r, noise_v)

    num_v, num_r = maps.shape[v_axis], maps.shape[r_axis]
    border_r = params.ref_cells_r + params.guard_cells_r
    border_v = params.ref_cells_v + params.guard_cells_v
    ar = torch.arange(num_r, device=maps.device)
    av = torch.arange(num_v, device=maps.device)
    r_ok = (ar >= border_r) & (ar < num_r - border_r)
    v_ok = (av >= border_v) & (av < num_v - border_v)
    if layout == "vgq":
        valid = v_ok[:, None, None] & r_ok[None, :, None]
    else:
        valid = v_ok[None, :, None] & r_ok[None, None, :]
    return noise, valid


def goca_cfar_2d(maps: torch.Tensor, params: CfarParams,
                 layout: str = "vgq") -> tuple[torch.Tensor, torch.Tensor]:
    """(mask bool, threshold) in the input layout; border cells are always
    False in the mask."""
    noise, valid = goca_noise_and_valid(maps, params, layout)
    threshold = params.threshold_factor * noise
    return (maps > threshold) & valid, threshold


class Detections(NamedTuple):
    """Fixed-capacity raw detection list (0-based indices)."""

    v_idx: torch.Tensor     # int64 [cap]
    r_idx: torch.Tensor     # int64 [cap]
    pair_idx: torch.Tensor  # int64 [cap]
    amp: torch.Tensor       # real [cap]
    valid: torch.Tensor     # bool [cap]
    count: torch.Tensor     # int32 scalar (true number found, may exceed cap)


def extract_detections(mask: torch.Tensor, maps: torch.Tensor,
                       capacity: int, layout: str = "qvg",
                       row_counts: torch.Tensor | None = None) -> Detections:
    """The first ``capacity`` True cells of a [pairs, V, G'] mask in
    (pair, range, velocity) order, with their ``maps`` [pairs, V, G]
    amplitudes (G' >= G; columns past G must be False).

    Rows are (pair, gate) columns of width V. Their hit counts
    (``row_counts`` [pairs, G'], e.g. from kernel K2, or the mask's sum)
    give each slot's row by a prefix sum and a binary search; a cumsum over
    the slot's gathered column finds its Doppler bin. Everything stays on
    the device: no ``nonzero``, no host sync."""
    if layout != "qvg":
        raise NotImplementedError(f"extract_detections layout={layout!r} "
                                  "is not ported (the slice runs 'qvg')")
    num_q, num_v, num_g = mask.shape
    dev = mask.device
    if row_counts is None:
        row_counts = mask.sum(dim=1, dtype=torch.int32)
    rcf = row_counts.reshape(-1).to(torch.int64)               # [Q*G']
    incl = torch.cumsum(rcf, 0)
    row_off = incl - rcf                                        # exclusive
    total = incl[-1]
    slots = torch.arange(capacity, dtype=torch.int64, device=dev)
    valid = slots < torch.clamp(total, max=capacity)
    r_s = torch.searchsorted(row_off, slots, right=True) - 1
    r_s = r_s.clamp(0, num_q * num_g - 1)
    q_s = r_s // num_g
    g_s = r_s % num_g
    col = mask[q_s, :, g_s].to(torch.int32)                     # [cap, V]
    within = torch.cumsum(col, dim=1) - col                     # exclusive
    want = slots - row_off[r_s]
    hit = (col > 0) & (within == want[:, None])
    v_c = torch.argmax(hit.to(torch.int32), dim=1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pair = torch.where(valid, q_s, zero)
    r = torch.where(valid, g_s, zero)
    v = torch.where(valid, v_c, zero)
    amp = maps[pair, v, r]
    return Detections(
        v_idx=v, r_idx=r, pair_idx=pair,
        amp=torch.where(valid, amp, torch.zeros((), dtype=amp.dtype,
                                                device=dev)),
        valid=valid, count=rcf.sum().to(torch.int32))
