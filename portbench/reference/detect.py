"""Detections, estimates and clusters of a range-Doppler map.

After the upstream MATLAB frame (``fun_process_single_frame.m:172-407``):
the adjacent-beam sum maps |RDM_b| + |RDM_b+1|, the cross-shaped 2D
GOCA-CFAR (greatest of the lead and trail window means on each axis, the
larger axis times the threshold factor, cells nearer an edge than guard +
reference never tested), the first ``max_detections`` hits in (pair,
range, velocity) order (MATLAB's column-major ``find``), the spline peak
refinement (not-a-knot, first maximum of the upsampled stencil, range
clipped and Doppler wrapped), amplitude monopulse on the two member beams
at the integer cell, then the two clusterings: intra-beam components under
(range, velocity, angle) gates merged by power-weighted mean with the
summed power, and inter-beam components under (range, velocity) gates
merged winner-take-all by power. Each cluster sits at its smallest member
index. The maps and the CFAR run in float64 on the map's device, the rest
on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .consts import F32_EPS, Radar


class Targets(NamedTuple):
    """A frame's final targets in slot order, and its raw detections."""
    range_m: np.ndarray
    velocity_ms: np.ndarray
    angle_deg: np.ndarray
    power: np.ndarray
    num_raw: int


def _window_means(x: torch.Tensor, guard: int, ref: int, axis: int):
    """Lead and trail means of the ``ref`` cells beyond ``guard`` cells on
    each side along ``axis`` (zero past the edges)."""
    halo = guard + ref
    n = x.shape[axis]
    pad = [0, 0] * (x.ndim - 1 - axis) + [halo, halo]
    xp = torch.nn.functional.pad(x, pad)
    cs = torch.cumsum(xp, dim=axis)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    at = lambda o: cs.narrow(axis, o, n)
    lead = at(halo - guard) - at(halo - guard - ref)
    trail = at(halo + guard + ref + 1) - at(halo + guard + 1)
    return lead / ref, trail / ref


def cfar_hits(r: Radar, rdm: torch.Tensor):
    """(sum maps [V, G, Q], hit indices (v, g, q) in (pair, range,
    velocity) order, their count)."""
    p = r.conf["cfar"]
    if p["method"] != "GOCA":
        raise NotImplementedError("the reference runs the GOCA CFAR")
    mag = rdm.abs()
    maps = mag[:, :, :-1] + mag[:, :, 1:]
    del mag
    lr, tr = _window_means(maps, p["guard_cells_r"], p["ref_cells_r"], 1)
    noise = torch.maximum(lr, tr)
    del lr, tr
    lv, tv = _window_means(maps, p["guard_cells_v"], p["ref_cells_v"], 0)
    noise = torch.maximum(noise, torch.maximum(lv, tv))
    del lv, tv
    mask = maps > p["threshold_factor"] * noise
    del noise
    bv = p["ref_cells_v"] + p["guard_cells_v"]
    br = p["ref_cells_r"] + p["guard_cells_r"]
    inner = torch.zeros_like(mask)
    inner[bv:r.num_v - bv, br:r.num_g - br, :] = True
    mask &= inner
    q, g, v = torch.nonzero(mask.permute(2, 1, 0), as_tuple=True)
    return maps, (v, g, q), int(q.numel())


def _components(adj: np.ndarray) -> np.ndarray:
    """Each slot's smallest fellow member under the closure of ``adj``."""
    n = adj.shape[0]
    label = np.full(n, -1)
    for i in range(n):
        if label[i] >= 0:
            continue
        label[i] = i
        stack = [i]
        while stack:
            u = stack.pop()
            for w in np.nonzero(adj[u] & (label < 0))[0]:
                label[w] = i
                stack.append(w)
    return label


def _adjacent(fields) -> np.ndarray:
    a = True
    for f, gate in fields:
        a = a & (np.abs(f[:, None] - f[None, :]) <= gate)
    return a


def estimate_and_cluster(r: Radar, rdm: torch.Tensor) -> Targets:
    conf = r.conf
    maps, (v, g, q), num_raw = cfar_hits(r, rdm)
    cap = conf["cfar"]["max_detections"]
    v, g, q = v[:cap], g[:cap], q[:cap]
    ip = conf["interp"]
    e = ip["extra_dots"]
    offs = torch.arange(-e, e + 1, device=maps.device)
    st_r = maps[v[:, None], (g[:, None] + offs).clamp(0, r.num_g - 1),
                q[:, None]]
    st_v = maps[torch.remainder(v[:, None] + offs, r.num_v), g[:, None],
                q[:, None]]
    amp = maps[v, g, q]
    a, b = rdm[v, g, q].abs(), rdm[v, g, q + 1].abs()
    host = lambda x: x.cpu().numpy()
    st_r, st_v, amp, a, b = map(host, (st_r, st_v, amp, a, b))
    v, g, q = host(v), host(g), host(q)
    del maps

    i_r = np.argmax(st_r @ r.q_range.T, axis=1)
    i_v = np.argmax(st_v @ r.q_vel.T, axis=1)
    rng = r.range_axis[g] + (i_r / ip["r_interp_times"] - e) * r.delta_r
    vel = (r.velocity_axis[v] + (i_v / ip["v_interp_times"] - e)
           * r.delta_v)
    ratio = (a - b) / (a + b + F32_EPS)
    ang = r.beam_angles
    angle = 0.5 * (ang[q] + ang[q + 1]) + r.k_slopes[q] * ratio
    power = amp

    cl = conf["cluster"]
    lab = _components(_adjacent([(rng, cl["max_range_sep"]),
                                 (vel, cl["max_vel_sep"]),
                                 (angle, cl["max_angle_sep"])]))
    reps = np.nonzero(lab == np.arange(len(lab)))[0]
    s_rng, s_vel, s_ang, s_pow = [], [], [], []
    for i in reps:
        m = lab == i
        w = power[m]
        s_pow.append(w.sum())
        s_rng.append((rng[m] * w).sum() / w.sum())
        s_vel.append((vel[m] * w).sum() / w.sum())
        s_ang.append((angle[m] * w).sum() / w.sum())
    s_rng, s_vel, s_ang, s_pow = map(np.asarray, (s_rng, s_vel, s_ang, s_pow))
    v_gate = (cl["max_vel_sep"] if cl.get("stage2_vel_gate") is None
              else cl["stage2_vel_gate"])
    lab2 = _components(_adjacent([(s_rng, cl["max_range_sep"]),
                                  (s_vel, v_gate)]))
    out = []
    for i in np.nonzero(lab2 == np.arange(len(lab2)))[0]:
        m = np.nonzero(lab2 == i)[0]
        w = m[np.argmax(s_pow[m])]
        out.append((s_rng[w], s_vel[w], s_ang[w], s_pow[w]))
    cols = np.asarray(out, np.float64).reshape(-1, 4).T
    return Targets(*cols, num_raw=num_raw)
