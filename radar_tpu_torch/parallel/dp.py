"""Data-parallel frames and trials — port of ``radar_tpu/parallel/dp.py``
(SURVEY.md section 2.3 "trial/data parallelism"; the reference's only
parallel boundary, the ``parfor`` trial loop at
main_plot_snr_vs_angle_error.m:167, mapped onto ranks).

Shard the batch, not the frame: every rank of the ``dp`` axis runs the
complete single-device pipeline (the perf path with kernels K1 and K2
included) on its N/dp frames or trials, one after another, with no
collective in the loop; one all-gather at the end gives every rank the
whole batch. A frame is computed exactly as the single-device processor
computes it on the same seed, so a dp batch equals the single-device runs
bit for bit. Ranks that share a dp index but differ on ``ch``/``cpi``
compute the same frames (those axes are inert here), except in
:func:`make_dp_sharded_frame_processor`, where they shard each frame
(``parallel/sharded.py``).

Frames and trials are keyed by integer seeds, as everywhere in the port;
``targets`` carry a leading batch axis (``broadcast_targets`` tiles one
target set).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import RadarConfig
from ..pipeline.frame import FrameResult, make_frame_processor
from ..pipeline.montecarlo import make_trial_fn
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed
from .mesh import AXIS_CPI, AXIS_DP, Mesh


def broadcast_targets(targets: TargetBatch, n: int) -> TargetBatch:
    """Tile one target set across a batch axis (Monte-Carlo trials: same
    truth, different noise seeds)."""
    return TargetBatch(*(np.broadcast_to(np.asarray(x)[None],
                                         (n,) + np.shape(x))
                         for x in targets))


def _tree_map(fn, *trees):
    """``fn`` over the tensors of NamedTuples of tensors (a field that is
    None, as ``ClusteredTargets.pair_idx`` without ``keep_pair_mode``,
    stays None)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree_map(fn, *leaves)
                                for leaves in zip(*trees)))
    return fn(*trees)


def _local_range(n: int, mesh: Mesh, axis: str) -> range:
    n_dp = mesh.size(axis)
    if n % n_dp:
        raise ValueError(f"batch {n} not divisible by {axis}={n_dp}")
    per = n // n_dp
    return range(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)


def _batched(process, mesh: Mesh, axis: str):
    """``process_batch(seeds [N], targets [N, K]) -> FrameResult [N]`` of a
    per-frame processor: this rank's frames, then the all-gather."""

    def process_batch(seeds, targets: TargetBatch) -> FrameResult:
        seeds = [int(s) for s in seeds]
        local = [process(seeds[j], TargetBatch(*(np.asarray(x)[j]
                                                 for x in targets)))
                 for j in _local_range(len(seeds), mesh, axis)]
        stacked = _tree_map(lambda *xs: torch.stack(xs), *local)
        return _tree_map(lambda x: mesh.all_gather(x, axis), stacked)

    return process_batch


def make_dp_frame_processor(cfg: RadarConfig, mesh: Mesh,
                            precomp: Precomputed | None = None, *,
                            axis: str = AXIS_DP):
    """``process_batch(seeds [N], targets [N, K]) -> FrameResult [N]``,
    the batch sharded over ``axis``; every rank returns the whole batch on
    its device. N must be a multiple of the axis size."""
    return _batched(make_frame_processor(cfg, precomp, device=mesh.device),
                    mesh, axis)


def make_dp_sharded_frame_processor(cfg: RadarConfig, mesh: Mesh,
                                    precomp: Precomputed | None = None, *,
                                    axis: str = AXIS_DP):
    """dp x model-parallel: the batch sharded over ``axis`` and each frame
    sharded over ``ch`` and ``cpi`` (``parallel/sharded.py`` with
    ``frame_axes=(cpi,)``), the layout of a real cluster: dp across hosts,
    ch/cpi within one."""
    from .sharded import make_sharded_frame_processor

    return _batched(make_sharded_frame_processor(cfg, mesh, precomp,
                                                 frame_axes=(AXIS_CPI,)),
                    mesh, axis)


def make_dp_trial_fn(cfg: RadarConfig, mesh: Mesh,
                     precomp: Precomputed | None = None, *,
                     axis: str = AXIS_DP):
    """``trials(targets, seeds [T]) -> (angles [T], hits [T])`` with
    ``pipeline/montecarlo.py::make_trial_fn``'s contract (the first final
    target's angle, NaN on a miss), the trials sharded over ``axis``;
    every rank returns all T. ``targets`` is one target set."""
    trials_fn = make_trial_fn(cfg, precomp, device=mesh.device)

    def trials(targets: TargetBatch, seeds):
        seeds = [int(s) for s in seeds]
        mine = [seeds[j] for j in _local_range(len(seeds), mesh, axis)]
        angles, hits = trials_fn(targets, mine)
        return mesh.all_gather(angles, axis), mesh.all_gather(hits, axis)

    return trials
