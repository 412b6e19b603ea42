"""Streaming many-target Monte-Carlo with detection-rate statistics — port
of ``radar_tpu/pipeline/streaming.py`` (BASELINE.json config 5).

Scenes of random targets are drawn on the host from a
``numpy.random.Generator`` exactly as the JAX code draws them, so both
packages see the same scenes. Per scene, ``trials_per_scene`` frames run
one after another on one device through the frame processor (every
configuration, as JAX's single-device routes do), and their final targets
are copied to the host once per scene. Truth matching uses the clustering
gates; statistics aggregate per-SNR-bin detection rates over all injected
targets.

With a mesh (every rank calls with the same arguments and gets the whole
statistics), ``dp_trials=True`` shards each scene's trials over the dp
axis (``parallel/dp.py``'s contract), the reference's parfor boundary
(main_plot_snr_vs_angle_error.m:167) on ranks, equal to the one-rank run
trial for trial; without it, every trial's frame is sharded over the mesh
(``parallel/sharded.py``). Without a mesh the flag is ignored, as JAX
ignores it: the trials run on one device, and the statistics are those of
``dp_trials=False``.

Trial seeds: trial ``t`` of scene ``s`` takes the integer seed
``pipeline/driver.py::trial_seed(seed, s, t)``.

Resume (``store=``, an ``io.orbax_store.OrbaxFrameStore``): each scene's
final targets (the valid flags, ranges and velocities the statistics read)
are saved under the scene's index, and a rerun with the same (seed, scene
schedule) replays the saved scenes, with field-exact statistics. On the
dp route each rank saves and restores only its own trials' rows, so a run
stopped on dp=4 resumes on dp=2 (the elastic resume; JAX's ``like=``
restore). The manifest is JAX's, with its ``trial_route``: "map" or
"vmap" by JAX's rule on one device, "dp" (no mesh shape: a trial's numbers
do not depend on dp there) on the dp route, and on the sharded route
"gspmd:" with every axis the frame shards over, dp included, because the
port's sharded frame splits pulses and gates over (dp, cpi): a resume
there on another mesh shape is refused (JAX leaves dp out,
``radar_tpu/pipeline/streaming.py:192-196``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config.params import RadarConfig
from ..io.orbax_store import OrbaxFrameStore
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed
from .driver import config_sha, trial_seed
from .frame import make_frame_processor


class StreamingStats(NamedTuple):
    total_targets: int
    total_detected: int
    detection_rate: float
    snr_bin_edges: np.ndarray
    snr_bin_rate: np.ndarray        # detection rate per SNR bin
    snr_bin_counts: np.ndarray
    range_rmse_m: float             # over matched detections
    velocity_rmse_ms: float


class HostTargets(NamedTuple):
    """Final targets of one frame as host arrays (what ``_match_rate``
    reads)."""

    valid: np.ndarray
    range_m: np.ndarray
    velocity_ms: np.ndarray


def random_scene(rng: np.random.Generator, num_targets: int,
                 cfg: RadarConfig, snr_range=(0.0, 20.0)) -> TargetBatch:
    """Random targets inside the unambiguous detection region: ranges in
    the CFAR-valid gate span, velocities inside the valid Doppler region,
    elevations across the beam fan."""
    sig = cfg.sig
    delta_r = sig.c / (2 * sig.fs)
    border_r = cfg.cfar.ref_cells_r + cfg.cfar.guard_cells_r
    border_v = cfg.cfar.ref_cells_v + cfg.cfar.guard_cells_v
    r = rng.uniform((border_r + 5) * delta_r,
                    (sig.n_total_gate - border_r - 5) * delta_r, num_targets)
    v_max = sig.v_max
    # valid shifted Doppler bins are [border_v, prt_num-border_v)
    v_lo = (border_v + 2) / sig.prt_num - 0.5
    v_hi = (sig.prt_num - border_v - 2) / sig.prt_num - 0.5
    v = rng.uniform(v_lo * v_max, v_hi * v_max, num_targets)
    el = rng.uniform(-10.0, 40.0, num_targets)
    snr = rng.uniform(*snr_range, num_targets)
    return TargetBatch.make(r, v, el, snr)


def _match_rate(final, truth: TargetBatch, gate_r: float, gate_v: float):
    """Per-truth-target detected flags + (dR, dV) of the best match.

    Convention: each truth is gated INDEPENDENTLY (no one-to-one
    assignment) — one merged detection sitting inside two truths' gates
    marks both detected. With truths drawn uniformly over ~3k gates the
    collision probability is <1e-3 per pair."""
    valid = np.asarray(final.valid)
    fr = np.asarray(final.range_m)[valid]
    fv = np.asarray(final.velocity_ms)[valid]
    k = truth.num_targets
    detected = np.zeros(k, bool)
    dr = np.full(k, np.nan)
    dv = np.full(k, np.nan)
    if len(fr):
        for i in range(k):
            d_r = np.abs(fr - truth.range_m[i])
            d_v = np.abs(fv - truth.velocity_ms[i])
            ok = (d_r <= gate_r) & (d_v <= gate_v)
            if ok.any():
                j = int(np.argmin(np.where(ok, d_r, np.inf)))
                detected[i] = True
                dr[i] = fr[j] - truth.range_m[i]
                dv[i] = fv[j] - truth.velocity_ms[i]
    return detected, dr, dv


def run_streaming_mc(cfg: RadarConfig, num_scenes: int = 16,
                     targets_per_scene: int = 8, trials_per_scene: int = 4,
                     seed: int = 0, mesh=None,
                     precomp: Precomputed | None = None,
                     snr_range=(0.0, 20.0), match_gate_r: float = 60.0,
                     match_gate_v: float = 3.0, progress: bool = False,
                     dp_trials: bool = False, store=None, *,
                     device="cuda", processor=None) -> StreamingStats:
    """Total injected targets = num_scenes*targets_per_scene*trials_per_scene,
    run on ``device`` (the card by default), or on the mesh's device with
    ``mesh`` (see the module docstring; ``dp_trials`` acts only there). ``processor`` may be a frame
    processor built once and reused (single-device route only);
    ``store`` resumes any route (see the module docstring)."""
    local = None            # the dp route: this rank's trials
    if mesh is not None:
        from ..parallel.mesh import AXES, AXIS_DP, check_mesh

        if store is not None and not isinstance(store, OrbaxFrameStore):
            raise NotImplementedError(
                "store= on the mesh routes takes an io.orbax_store."
                "OrbaxFrameStore (its multi-rank save and restore)")
        check_mesh(mesh)
        if processor is not None:
            raise ValueError("processor= drives the single-device route; "
                             "with mesh= the route is built from the mesh")
        if dp_trials:
            from ..parallel.multihost import local_batch_slice

            processor = make_frame_processor(cfg, precomp,
                                             device=mesh.device)
            local = range(trials_per_scene)[local_batch_slice(
                trials_per_scene, mesh)]
            route = "dp"
        else:
            from ..parallel.sharded import make_sharded_frame_processor

            processor = make_sharded_frame_processor(cfg, mesh, precomp)
            route = "gspmd:" + "x".join(f"{a}={mesh.shape[a]}"
                                        for a in AXES)
        progress = progress and mesh.rank == 0
    else:
        if processor is None:
            processor = make_frame_processor(cfg, precomp, device=device)
        route = "map" if (cfg.lowrank_rdm and cfg.fused_synth_dbf
                          and cfg.noise_rdm_impl in ("pallas",
                                                     "pallas_prng")) \
            else "vmap"

    def host_targets(seeds, truth) -> HostTargets:
        """Final targets of ``seeds``' trials, copied once to the host:
        [trials, slots] per field."""
        finals = [processor(sd, truth).targets for sd in seeds]
        return HostTargets(*(torch.stack([getattr(f, name) for f in finals])
                             .cpu().numpy() for name in HostTargets._fields))

    def gathered(host: HostTargets) -> HostTargets:
        """The dp route's rows of every rank, in trial order."""
        return HostTargets(*(mesh.all_gather(torch.from_numpy(x).to(
            mesh.device), AXIS_DP).cpu().numpy() for x in host))

    done = set()
    if store is not None:
        from ..io.checkpoint import check_run_manifest

        # refuse a store written by a different run: its scenes would be
        # matched against this run's truths (radar_tpu/pipeline/
        # streaming.py:160-202)
        check_run_manifest(store.root, {
            "seed": int(seed), "config_sha": config_sha(cfg),
            "targets_per_scene": int(targets_per_scene),
            "trials_per_scene": int(trials_per_scene),
            "snr_range": [float(snr_range[0]), float(snr_range[1])],
            "dtype": "complex64", "trial_route": route})
        done = set(store.frames_done())
        if mesh is not None:            # the ranks replay the same scenes
            done = set(mesh.all_gather_object(sorted(done), AXES)[0])
    save_kw = {} if mesh is None else {
        "mesh": mesh, "axis": AXIS_DP if local is not None else None}

    rng = np.random.default_rng(seed)
    all_snr, all_det, all_dr, all_dv = [], [], [], []
    for s in range(num_scenes):
        # the scene rng advances for replayed scenes too
        truth = random_scene(rng, targets_per_scene, cfg, snr_range)
        seeds = [trial_seed(seed, s, t) for t in range(trials_per_scene)]
        if s + 1 in done:
            host = HostTargets(**store.restore(s + 1, **save_kw))
        else:
            host = host_targets(seeds if local is None
                                else [seeds[t] for t in local], truth)
            if store is not None:
                store.save(s + 1, host._asdict(), **save_kw)
        if local is not None:
            host = gathered(host)
        for t in range(trials_per_scene):
            det, dr, dv = _match_rate(
                HostTargets(*(x[t] for x in host)), truth, match_gate_r,
                match_gate_v)
            all_snr.append(truth.snr_db)
            all_det.append(det)
            all_dr.append(dr)
            all_dv.append(dv)
        if progress:
            print(f"scene {s + 1}/{num_scenes}: "
                  f"rate={np.mean(all_det[-trials_per_scene:]):.2f}")

    return aggregate_stats(np.concatenate(all_snr), np.concatenate(all_det),
                           np.concatenate(all_dr), np.concatenate(all_dv),
                           snr_range)


def aggregate_stats(snr: np.ndarray, det: np.ndarray, dr: np.ndarray,
                    dv: np.ndarray, snr_range) -> StreamingStats:
    """Detection-rate statistics from flat per-injected-target records."""
    edges = np.linspace(snr_range[0], snr_range[1], 9)
    bins = np.clip(np.digitize(snr, edges) - 1, 0, len(edges) - 2)
    rate = np.zeros(len(edges) - 1)
    counts = np.zeros(len(edges) - 1, int)
    for b in range(len(edges) - 1):
        m = bins == b
        counts[b] = m.sum()
        rate[b] = det[m].mean() if m.any() else np.nan
    matched = ~np.isnan(dr)
    return StreamingStats(
        total_targets=len(det),
        total_detected=int(det.sum()),
        detection_rate=float(det.mean()),
        snr_bin_edges=edges,
        snr_bin_rate=rate,
        snr_bin_counts=counts,
        range_rmse_m=float(np.sqrt(np.nanmean(dr[matched] ** 2)))
        if matched.any() else np.nan,
        velocity_rmse_ms=float(np.sqrt(np.nanmean(dv[matched] ** 2)))
        if matched.any() else np.nan,
    )
