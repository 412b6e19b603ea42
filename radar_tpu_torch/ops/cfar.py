"""2D GOCA-CFAR and first-K detection extraction — port of
``radar_tpu/ops/cfar.py:146-216, 272-312, 367-454``.

Reference (fun_process_single_frame.m:172-223): on each adjacent-beam sum
map |RDM_A| + |RDM_B|, a cross-shaped greatest-of cell-averaging detector

  noise_R = max(mean(lead ref_R cells), mean(trail ref_R cells))   (range)
  noise_V = max(mean(lead ref_V cells), mean(trail ref_V cells))   (Doppler)
  threshold = T_CFAR * max(noise_R, noise_V)

with guard cells, and border cells (closer than ref+guard to an edge)
never tested. The window means are ``ref`` ordered shifted adds, as in the
reference, then a multiply by the f32 reciprocal of ``ref`` — what XLA
compiles the reference's division by the constant into (eager JAX divides,
which can differ in the last bit) — and the "CA" combine takes the fused
multiply-add XLA's CPU compiler makes of it. The port does the same on
every device, so kernels K2 and K3 match it bit for bit.

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


def _lead_trail_sums(x: torch.Tensor, guard: int, ref: int, axis: int):
    """Window sums of the ``ref`` cells before and after the guard band,
    added in the reference's order (k = guard+1 .. guard+ref)."""
    lead = torch.zeros_like(x)
    trail = torch.zeros_like(x)
    for k in range(guard + 1, guard + ref + 1):
        lead = lead + _shifted(x, k, axis)
        trail = trail + _shifted(x, -k, axis)
    return lead, trail


def _combine(lead: torch.Tensor, trail: torch.Tensor, ref: int,
             method: str) -> torch.Tensor:
    """The per-axis noise estimate from the two window sums. For "CA" XLA
    contracts ``lead*inv + trail*inv`` into ``fma(lead, inv, trail*inv)``;
    the product lead*inv is exact in f64, so the f64 sum rounded to f32 is
    that FMA (but for a double rounding, at odds of about 2^-29)."""
    inv = float(np.float32(1.0 / ref))
    if method == "GOCA":
        return torch.maximum(lead * inv, trail * inv)
    if method == "SOCA":
        return torch.minimum(lead * inv, trail * inv)
    if method == "CA":
        s = lead.double() * inv + (trail * inv).double()
        return 0.5 * s.to(lead.dtype)
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
    noise_r = _combine(*_lead_trail_sums(maps, params.guard_cells_r,
                                         params.ref_cells_r, r_axis),
                       params.ref_cells_r, params.method)
    noise_v = _combine(*_lead_trail_sums(maps, params.guard_cells_v,
                                         params.ref_cells_v, v_axis),
                       params.ref_cells_v, params.method)
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


def _first_k(row_counts: torch.Tensor, capacity: int, column):
    """The first ``capacity`` hits over rows of width V in row order.
    ``row_counts`` [rows] holds each row's hits and ``column(r)`` returns
    rows ``r`` [cap] as [cap, V] int32 masks. Returns (row [cap], position
    in row [cap], valid [cap]). A prefix sum and a binary search give each
    slot's row; a cumsum over the fetched row finds its position. All on
    the device: no ``nonzero``, no host sync."""
    rcf = row_counts.reshape(-1).to(torch.int64)
    dev = rcf.device
    incl = torch.cumsum(rcf, 0)
    row_off = incl - rcf                                        # exclusive
    slots = torch.arange(capacity, dtype=torch.int64, device=dev)
    valid = slots < torch.clamp(incl[-1], max=capacity)
    r_s = (torch.searchsorted(row_off, slots, right=True) - 1).clamp(
        0, rcf.shape[0] - 1)
    col = column(r_s)
    within = torch.cumsum(col, dim=1) - col                     # exclusive
    hit = (col > 0) & (within == (slots - row_off[r_s])[:, None])
    return r_s, torch.argmax(hit.to(torch.int32), dim=1), valid


def first_k_true_vgq(mask: torch.Tensor, capacity: int):
    """Ascending (pair, range, velocity)-major flat indices of the first
    ``capacity`` True cells of a [V, G, pairs] mask, and their validity;
    invalid slots hold 0. Rows are (pair, gate) of width V, read in the
    mask's own layout (no relayout of the cube)."""
    num_v, num_g, _ = mask.shape
    rc = mask.sum(dim=0, dtype=torch.int32).T                  # [Q, G]
    r_s, v_c, valid = _first_k(
        rc, capacity,
        lambda r: mask[:, r % num_g, r // num_g].T.to(torch.int32))
    return torch.where(valid, r_s * num_v + v_c, 0), valid


def extract_detections(mask: torch.Tensor, maps: torch.Tensor,
                       capacity: int, layout: str = "qvg",
                       row_counts: torch.Tensor | None = None) -> Detections:
    """The first ``capacity`` True cells of the mask in (pair, range,
    velocity) order, with their ``maps`` amplitudes: the JAX
    ``impl="direct"`` extraction (its ``"rowfetch"`` gives the same output
    bit for bit in all cases, so the port has only this one).

    ``layout="qvg"``: mask [pairs, V, G'] and maps [pairs, V, G] (G' >= G,
    columns past G False); ``row_counts`` [pairs, G'] (e.g. from kernel K2)
    saves the mask reduction. ``layout="vgq"``: mask and maps [V, G,
    pairs]. Rows are (pair, gate) of width V in both layouts, read where
    they lie, with no host sync."""
    if layout == "vgq":
        num_v, num_g, _ = mask.shape
        idx, valid = first_k_true_vgq(mask, capacity)
        pair, rem = idx // (num_g * num_v), idx % (num_g * num_v)
        r, v = rem // num_v, rem % num_v
        amp = maps[v, r, pair]
        count = mask.sum()
    elif layout == "qvg":
        num_g = mask.shape[2]
        if row_counts is None:
            row_counts = mask.sum(dim=1, dtype=torch.int32)
        r_s, v_c, valid = _first_k(
            row_counts, capacity,
            lambda r: mask[r // num_g, :, r % num_g].to(torch.int32))
        zero = torch.zeros((), dtype=torch.int64, device=mask.device)
        pair = torch.where(valid, r_s // num_g, zero)
        r = torch.where(valid, r_s % num_g, zero)
        v = torch.where(valid, v_c, zero)
        amp = maps[pair, v, r]
        count = row_counts.sum()
    else:
        raise NotImplementedError(f"extract_detections layout={layout!r} "
                                  "is not ported (the port runs 'qvg' and "
                                  "'vgq')")
    return Detections(
        v_idx=v, r_idx=r, pair_idx=pair,
        amp=torch.where(valid, amp, torch.zeros((), dtype=amp.dtype,
                                                device=amp.device)),
        valid=valid, count=count.to(torch.int32))
