"""Two-stage detection clustering — port of ``radar_tpu/cluster/stages.py``.

Stage 1, intra-beam (fun_process_single_frame.m:302-352): components under
(|dR| <= max_range_sep, |dV| <= max_vel_sep, |dAngle| <= max_angle_sep),
merged by power-weighted mean; power = sum of member powers.
Stage 2, inter-beam anti-ghost (ref :355-407): components under (R, V)
gates, merged winner-take-all by power.
``ClusterParams.keep_pair_mode`` (the v7_7 variant) carries the modal
member pair index through stage 1 and the winner's through stage 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.params import ClusterParams
from ..measure.estimate import ParamDetections
from .connected import (connected_labels, gate_adjacency, merge_weighted_mean,
                        merge_winner_take_all)


class ClusteredTargets(NamedTuple):
    """Per-slot clustered target list; ``valid`` marks live slots.
    ``pair_idx`` is None unless ``keep_pair_mode``: then the modal member
    pair index (stage 1, _v7_7.m:766) or the winner's (stage 2)."""

    range_m: torch.Tensor
    velocity_ms: torch.Tensor
    angle_deg: torch.Tensor
    power: torch.Tensor
    valid: torch.Tensor
    pair_idx: torch.Tensor | None = None

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()


def _modal_pair_idx(labels: torch.Tensor, valid: torch.Tensor,
                    pair_idx: torch.Tensor) -> torch.Tensor:
    """Per-cluster mode of the member pair indices at representative
    slots, MATLAB ``mode``'s tie-break to the smallest value: among the
    members whose pair index is the most frequent, the smallest index."""
    n = labels.shape[0]
    idx = torch.arange(n, device=labels.device)
    member = (labels[None, :] == idx[:, None]) & valid[None, :]  # [n, n]
    same_pair = pair_idx[None, :] == pair_idx[:, None]
    # counts[i, j]: members of cluster i sharing member j's pair index
    # (exact small integers in f32; the card has no integer matmul)
    counts = member.float() @ same_pair.float()
    cmax = torch.where(member, counts, -1.0).max(dim=1, keepdim=True).values
    at_max = member & (counts == cmax)
    big = torch.iinfo(torch.int32).max
    return torch.where(at_max, pair_idx[None, :].to(torch.int64),
                       big).min(dim=1).values


def cluster_stage1(dets: ParamDetections,
                   params: ClusterParams) -> ClusteredTargets:
    adj = gate_adjacency(
        [(dets.range_m, params.max_range_sep),
         (dets.velocity_ms, params.max_vel_sep),
         (dets.angle_deg, params.max_angle_sep)], dets.valid)
    labels = connected_labels(adj, dets.valid)
    merged, wsum, rep_valid = merge_weighted_mean(
        labels, dets.valid, dets.power,
        {"range_m": dets.range_m, "velocity_ms": dets.velocity_ms,
         "angle_deg": dets.angle_deg})
    zero = torch.zeros((), dtype=dets.power.dtype, device=dets.power.device)
    w = lambda x: torch.where(rep_valid, x, zero)
    pair_mode = None
    if params.keep_pair_mode:
        pair_mode = torch.where(rep_valid, _modal_pair_idx(
            labels, dets.valid, dets.pair_idx), 0)
    return ClusteredTargets(
        range_m=w(merged["range_m"]), velocity_ms=w(merged["velocity_ms"]),
        angle_deg=w(merged["angle_deg"]), power=w(wsum), valid=rep_valid,
        pair_idx=pair_mode)


def cluster_stage2(t: ClusteredTargets,
                   params: ClusterParams) -> ClusteredTargets:
    # the reference reuses max_vel_sep here (ref :361); stage2_vel_gate
    # widens only this anti-ghost merge
    v_gate = (params.max_vel_sep if params.stage2_vel_gate is None
              else params.stage2_vel_gate)
    adj = gate_adjacency([(t.range_m, params.max_range_sep),
                          (t.velocity_ms, v_gate)], t.valid)
    labels = connected_labels(adj, t.valid)
    fields = {"range_m": t.range_m, "velocity_ms": t.velocity_ms,
              "angle_deg": t.angle_deg}
    if t.pair_idx is not None:
        fields["pair_idx"] = t.pair_idx
    merged, rep_valid = merge_winner_take_all(labels, t.valid, t.power,
                                              fields)
    zero = torch.zeros((), dtype=t.power.dtype, device=t.power.device)
    w = lambda x: torch.where(rep_valid, x, zero)
    return ClusteredTargets(
        range_m=w(merged["range_m"]), velocity_ms=w(merged["velocity_ms"]),
        angle_deg=w(merged["angle_deg"]), power=w(merged["power"]),
        valid=rep_valid,
        pair_idx=(torch.where(rep_valid, merged["pair_idx"], 0)
                  if t.pair_idx is not None else None))
