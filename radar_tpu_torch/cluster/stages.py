"""Two-stage detection clustering — port of ``radar_tpu/cluster/stages.py``.

Stage 1, intra-beam (fun_process_single_frame.m:302-352): components under
(|dR| <= max_range_sep, |dV| <= max_vel_sep, |dAngle| <= max_angle_sep),
merged by power-weighted mean; power = sum of member powers.
Stage 2, inter-beam anti-ghost (ref :355-407): components under (R, V)
gates, merged winner-take-all by power.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.params import ClusterParams
from ..measure.estimate import ParamDetections
from .connected import (connected_labels, gate_adjacency, merge_weighted_mean,
                        merge_winner_take_all)


class ClusteredTargets(NamedTuple):
    """Per-slot clustered target list; ``valid`` marks live slots."""

    range_m: torch.Tensor
    velocity_ms: torch.Tensor
    angle_deg: torch.Tensor
    power: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()


def _check(params: ClusterParams) -> None:
    if params.keep_pair_mode:
        raise NotImplementedError(
            "cfg.cluster.keep_pair_mode=True (v7_7 modal pair index) is not "
            "ported")


def cluster_stage1(dets: ParamDetections,
                   params: ClusterParams) -> ClusteredTargets:
    _check(params)
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
    return ClusteredTargets(
        range_m=w(merged["range_m"]), velocity_ms=w(merged["velocity_ms"]),
        angle_deg=w(merged["angle_deg"]), power=w(wsum), valid=rep_valid)


def cluster_stage2(t: ClusteredTargets,
                   params: ClusterParams) -> ClusteredTargets:
    _check(params)
    # the reference reuses max_vel_sep here (ref :361); stage2_vel_gate
    # widens only this anti-ghost merge
    v_gate = (params.max_vel_sep if params.stage2_vel_gate is None
              else params.stage2_vel_gate)
    adj = gate_adjacency([(t.range_m, params.max_range_sep),
                          (t.velocity_ms, v_gate)], t.valid)
    labels = connected_labels(adj, t.valid)
    merged, rep_valid = merge_winner_take_all(
        labels, t.valid, t.power,
        {"range_m": t.range_m, "velocity_ms": t.velocity_ms,
         "angle_deg": t.angle_deg})
    zero = torch.zeros((), dtype=t.power.dtype, device=t.power.device)
    w = lambda x: torch.where(rep_valid, x, zero)
    return ClusteredTargets(
        range_m=w(merged["range_m"]), velocity_ms=w(merged["velocity_ms"]),
        angle_deg=w(merged["angle_deg"]), power=w(merged["power"]),
        valid=rep_valid)
