"""Historical v5 single-stage index-space clustering — port of
``radar_tpu/cluster/legacy.py`` (main_simulate_echoes_with_array_v5.m:
491-560).

The v5 driver clusters raw CFAR cell hits of one sum RDM in index space:
connected components under cell-count gates (|dv| <= 3, |dr| <= 5 cells),
then a power-weighted centroid of the fractional cell indices, turned into
physical units by linear interpolation of the axes (MATLAB
``interp1(1:N, axis, centroid_idx)``). No angle and no second stage.
"""

from __future__ import annotations

import torch

from .connected import connected_labels, gate_adjacency, merge_weighted_mean
from .stages import ClusteredTargets


def _interp(x: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``numpy.interp(x, arange(len(fp)), fp)``: linear between the
    samples, clamped to the end values."""
    n = fp.shape[0]
    xc = x.clamp(0, n - 1)
    i0 = xc.floor().to(torch.int64).clamp(0, max(n - 2, 0))
    i1 = (i0 + 1).clamp(max=n - 1)
    t = xc - i0.to(x.dtype)
    return torch.where(x > n - 1, fp[-1], fp[i0] + t * (fp[i1] - fp[i0]))


def cluster_single_stage_v5(v_idx, r_idx, power, valid, range_axis,
                            velocity_axis, max_range_sep_cells: int = 5,
                            max_vel_sep_cells: int = 3) -> ClusteredTargets:
    """Cluster raw CFAR hits ``(v_idx, r_idx)`` (0-based cell indices,
    any dtype) with powers taken from the RDM at those cells, gates in
    cells (v5:497-498). Range and velocity come from the axes at the
    power-weighted fractional centroid (v5:555-557); ``angle_deg`` is zero
    (v5 predates monopulse, v5:559). Tensors on any device."""
    power = torch.as_tensor(power)
    dtype, dev = power.dtype, power.device
    vf = torch.as_tensor(v_idx, device=dev).to(dtype)
    rf = torch.as_tensor(r_idx, device=dev).to(dtype)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    adj = gate_adjacency([(rf, float(max_range_sep_cells)),
                          (vf, float(max_vel_sep_cells))], valid)
    labels = connected_labels(adj, valid)
    merged, wsum, rep_valid = merge_weighted_mean(labels, valid, power,
                                                  {"v": vf, "r": rf})
    rng = _interp(merged["r"], torch.as_tensor(range_axis, device=dev,
                                               dtype=dtype))
    vel = _interp(merged["v"], torch.as_tensor(velocity_axis, device=dev,
                                               dtype=dtype))
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = lambda x: torch.where(rep_valid, x, zero)
    return ClusteredTargets(range_m=w(rng), velocity_ms=w(vel),
                            angle_deg=torch.zeros_like(w(rng)),
                            power=w(wsum), valid=rep_valid)
