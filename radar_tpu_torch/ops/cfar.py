"""2D GOCA-CFAR and first-K detection extraction — port of
``radar_tpu/ops/cfar.py``.

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
``CfarParams.means_impl="matmul"`` takes the range means from a blocked
banded-stencil matrix product instead (``lead_trail_means_matmul``), equal
up to the order of the sums.

Layouts of the pair-sum maps: "vgq" [V, G, pairs] (the default tail),
"qvg" [pairs, V, G] (the kernel-CFAR tails) and "qgv" [pairs, G, V] (the
beams-major tail, ``pair_sum_maps_bm``).

Detections leave as a fixed-capacity list in (pair, range, velocity)
order, the order of MATLAB's column-major ``find`` per pair (ref :215-221).
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=8)
def _banded_means_matrix(guard: int, ref: int, tile: int) -> np.ndarray:
    """[tile + 2*halo, 2*tile] banded stencil (halo = guard + ref):
    columns 0..tile-1 give the lead window means of a ``tile``-wide output
    block from its input window, tile..2*tile-1 the trail means."""
    halo = guard + ref
    w = np.zeros((tile + 2 * halo, 2 * tile), np.float64)
    for j in range(tile):
        for k in range(guard + 1, guard + ref + 1):
            w[j + halo - k, j] = 1.0 / ref          # lead:  x[i - k]
            w[j + halo + k, tile + j] = 1.0 / ref   # trail: x[i + k]
    return w


def lead_trail_means_matmul(x: torch.Tensor, guard: int, ref: int,
                            axis: int, tile: int = 128):
    """The lead and trail window means along ``axis`` as one blocked
    banded-stencil matrix product: each ``tile``-wide output block
    contracts its ``tile + 2*(guard+ref)`` input window (zero fill at the
    borders) against ``_banded_means_matrix`` (in ``x``'s dtype). Equal to
    the shifted adds up to the order of the sums (the matrix product's
    own)."""
    halo = guard + ref
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    n_tiles = -(-n // tile)
    xp = torch.nn.functional.pad(xm, (halo, n_tiles * tile - n + halo))
    blocks = xp.unfold(-1, tile + 2 * halo, tile)    # [..., n_tiles, win]
    w = torch.tensor(_banded_means_matrix(guard, ref, tile), dtype=x.dtype,
                     device=x.device)
    y = torch.matmul(blocks, w)                      # [..., n_tiles, 2T]
    flat = xm.shape[:-1] + (n_tiles * tile,)
    lead = y[..., :tile].reshape(flat)[..., :n]
    trail = y[..., tile:].reshape(flat)[..., :n]
    return lead.movedim(-1, axis), trail.movedim(-1, axis)


def pair_sum_maps(rdm: torch.Tensor) -> torch.Tensor:
    """|RDM| adjacent-beam sums: [V, G, B] complex -> [V, G, B-1] real."""
    mag = rdm.abs()
    return mag[:, :, :-1] + mag[:, :, 1:]


def pair_sum_maps_bm(rdm_bm: torch.Tensor) -> torch.Tensor:
    """Beams-major variant: [B, V, G] complex -> [B-1, G, V] real sum
    maps (contiguous), whose order is the reference's (pair, range,
    velocity) scan order."""
    mag = rdm_bm.abs()
    return (mag[:-1] + mag[1:]).transpose(1, 2).contiguous()


_AXES = {"vgq": (1, 0), "qgv": (1, 2), "qvg": (2, 1)}   # (range, Doppler)


def goca_noise_and_valid(maps: torch.Tensor, params: CfarParams,
                         layout: str = "vgq"):
    """max(noise_R, noise_V) and the border-validity mask, before the
    threshold factor. ``layout`` is "vgq" ([V, G, pairs]), "qvg"
    ([pairs, V, G]) or "qgv" ([pairs, G, V]). Under ``means_impl="matmul"``
    the range means come from ``lead_trail_means_matmul``."""
    if params.means_impl not in ("shift", "matmul"):
        raise ValueError(f"unknown means_impl {params.means_impl!r}")
    r_axis, v_axis = _AXES[layout]
    if params.means_impl == "matmul":
        # the means are the sums of a window of one cell
        noise_r = _combine(*lead_trail_means_matmul(
            maps, params.guard_cells_r, params.ref_cells_r, r_axis), 1,
            params.method)
    else:
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
    elif layout == "qgv":
        valid = r_ok[None, :, None] & v_ok[None, None, :]
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


def first_k_true_indices(flat: torch.Tensor, capacity: int,
                         row_width: int = 4096):
    """Ascending flat indices of the first ``capacity`` True entries of a
    boolean vector (rows of ``row_width``), and their validity; invalid
    slots hold 0."""
    n = flat.shape[0]
    num_rows = -(-n // row_width)
    m2 = torch.nn.functional.pad(flat.to(torch.int32),
                                 (0, num_rows * row_width - n))
    m2 = m2.reshape(num_rows, row_width)
    r_s, pos, valid = _first_k(m2.sum(dim=1), capacity, lambda r: m2[r])
    return torch.where(valid, r_s * row_width + pos, 0), valid


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


def first_k_true_beams_major(mask: torch.Tensor, capacity: int,
                             layout: str = "qgv",
                             row_counts: torch.Tensor | None = None):
    """(pair, range, velocity, valid) of the first ``capacity`` True cells
    of a [pairs, G, V] ("qgv") or [pairs, V, G'] ("qvg") mask in (pair,
    range, velocity) order; invalid slots hold 0. Rows are (pair, gate) of
    width V in both layouts, read where they lie. ``row_counts`` [pairs,
    G] (e.g. from kernel K2) saves the mask reduction."""
    if layout == "qgv":
        num_g = mask.shape[1]
        axis, column = 2, lambda r: mask[r // num_g, r % num_g, :]
    elif layout == "qvg":
        num_g = mask.shape[2]
        axis, column = 1, lambda r: mask[r // num_g, :, r % num_g]
    else:
        raise ValueError(f"unknown beams-major layout {layout!r}")
    if row_counts is None:
        row_counts = mask.sum(dim=axis, dtype=torch.int32)
    r_s, v_c, valid = _first_k(row_counts, capacity,
                               lambda r: column(r).to(torch.int32))
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    return (torch.where(valid, r_s // num_g, zero),
            torch.where(valid, r_s % num_g, zero),
            torch.where(valid, v_c, zero), valid)


def extract_detections(mask: torch.Tensor, maps: torch.Tensor | None,
                       capacity: int, layout: str = "qvg",
                       row_counts: torch.Tensor | None = None, *,
                       native_scan: bool = False,
                       rdm: torch.Tensor | None = None) -> Detections:
    """The first ``capacity`` True cells of the mask in (pair, range,
    velocity) order, with their ``maps`` amplitudes: the JAX
    ``impl="direct"`` extraction (its ``"rowfetch"`` gives the same output
    bit for bit in all cases, so the port has only this one).

    ``layout="qvg"``: mask [pairs, V, G'] and maps [pairs, V, G] (G' >= G,
    columns past G False); ``row_counts`` [pairs, G'] (e.g. from kernel K2)
    saves the mask reduction. ``layout="qgv"``: mask and maps [pairs, G,
    V]. ``layout="vgq"``: mask and maps [V, G, pairs]. Rows are (pair,
    gate) of width V in every layout, read where they lie, with no host
    sync.

    vgq only: ``native_scan`` scans the mask in its own [V, G, pairs] order
    and sorts the <= ``capacity`` hits into (pair, range, velocity) order
    afterwards (the same output unless the hits exceed the capacity, where
    it keeps another subset, JAX's); ``rdm`` ([V, G, B] complex, with
    ``maps=None``) takes the amplitudes |rdm[v,r,p]| + |rdm[v,r,p+1]| from
    the RDM (``cfg.tail_from_rdm``)."""
    if layout == "vgq":
        num_v, num_g, num_q = mask.shape
        if native_scan:
            idx, valid = first_k_true_indices(mask.reshape(-1), capacity)
            v, rem = idx // (num_g * num_q), idx % (num_g * num_q)
            r, pair = rem // num_q, rem % num_q
            # (pair, range, velocity) order; invalid slots sort last
            key = torch.where(valid, (pair * num_g + r) * num_v + v,
                              torch.iinfo(torch.int32).max)
            order = torch.argsort(key, stable=True)
            v, r, pair, valid = v[order], r[order], pair[order], valid[order]
        else:
            idx, valid = first_k_true_vgq(mask, capacity)
            pair, rem = idx // (num_g * num_v), idx % (num_g * num_v)
            r, v = rem // num_v, rem % num_v
        if rdm is not None:
            amp = rdm[v, r, pair].abs() + rdm[v, r, pair + 1].abs()
        else:
            amp = maps[v, r, pair]
        count = mask.sum()
    elif layout in ("qvg", "qgv"):
        pair, r, v, valid = first_k_true_beams_major(mask, capacity, layout,
                                                     row_counts)
        amp = maps[pair, v, r] if layout == "qvg" else maps[pair, r, v]
        count = mask.sum() if row_counts is None else row_counts.sum()
    else:
        raise ValueError(f"unknown extraction layout {layout!r}")
    return Detections(
        v_idx=v, r_idx=r, pair_idx=pair,
        amp=torch.where(valid, amp, torch.zeros((), dtype=amp.dtype,
                                                device=amp.device)),
        valid=valid, count=count.to(torch.int32))
