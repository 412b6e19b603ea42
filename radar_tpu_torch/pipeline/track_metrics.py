"""Track-level scoring of the inter-frame associator — port of
``radar_tpu/pipeline/track_metrics.py`` (host numpy, as there) — against
known truth trajectories (SURVEY.md section 4 idiom 1 — ground-truth
injection — lifted from "compare by eye" to quantitative track metrics
the reference never computes; associator under test:
main_simulate_echoes_with_array_v8_3.m:253-335 / _v8_2.m:227-332).

Scoring model: every detection-log row is assigned to the nearest truth
trajectory within (range, velocity, elevation) gates, or to "clutter" if
none match. A TRACK (one associator output component) is then:

  - MATCHED to truth k if >= ``purity_floor`` of its member rows are
    assigned to k (majority truth);
  - a FALSE track otherwise (members mostly clutter or no majority).

Per-truth outcomes aggregate over matched tracks:

  - ``detected``: has at least one matched track;
  - ``coverage``: fraction of the run's frames covered by members of the
    truth's matched tracks (a well-tracked target approaches 1.0);
  - ``n_tracks``: matched-track count (1 = clean, >1 = FRAGMENTED).

Truth trajectories use the v8_2 "simple" kinematics (R(f) = R0 - V*f*T,
El/V constant, v8_2:200-205) or the v8_3 constant-altitude model
(v8_3:203-228), matching sim.scenario.Scenario.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config.params import RadarConfig
from ..sim.scenario import TargetBatch


def truth_trajectories(truth: TargetBatch, num_frames: int,
                       cfg: RadarConfig,
                       kinematics: str = "simple") -> dict:
    """Per-frame truth state arrays [K, F] for frames 1..num_frames (state
    advances BEFORE processing each frame, so frame f has taken f steps)."""
    t_frame = cfg.sig.frame_time
    f = np.arange(1, num_frames + 1)[None, :]            # [1, F]
    r0 = truth.range_m[:, None]
    v0 = truth.velocity_ms[:, None]
    el0 = np.deg2rad(truth.elevation_deg)[:, None]
    if kinematics == "simple":
        return {"range_m": r0 - v0 * f * t_frame,
                "velocity_ms": np.broadcast_to(v0, (len(truth.range_m),
                                                    num_frames)),
                "elevation_deg": np.broadcast_to(
                    truth.elevation_deg[:, None],
                    (len(truth.range_m), num_frames))}
    if kinematics != "altitude":
        raise ValueError(f"unknown kinematics model {kinematics!r}")
    const_h = r0 * np.sin(el0)
    const_vg = v0 / np.cos(el0)
    r_ground = r0 * np.cos(el0) - const_vg * f * t_frame
    r = np.sqrt(r_ground**2 + const_h**2)
    el = np.rad2deg(np.arcsin(const_h / r))
    return {"range_m": r, "velocity_ms": const_vg * np.cos(np.deg2rad(el)),
            "elevation_deg": el}


@dataclasses.dataclass
class TrackScore:
    """Track-level metrics for one scene (see module docstring)."""

    n_truth: int
    n_tracks: int
    truth_detected: np.ndarray       # [K] bool: >=1 matched track
    truth_coverage: np.ndarray       # [K] frame-coverage of matched tracks
    truth_n_tracks: np.ndarray       # [K] matched-track count (frag if >1)
    false_tracks: int                # tracks with no majority truth
    track_purity: np.ndarray         # [T] majority fraction per track
    switched_tracks: int             # tracks mixing 2 truths substantially
    # subset of false_tracks whose members DO match a truth in (R, V)
    # but fail the elevation gate: beam-sidelobe GHOSTS of a real target
    # that slipped the reference's stage-2 (R,V)-only anti-ghost merge
    # (its dV<=0.4 m/s gate, fun_process_single_frame.m:361) because the
    # ghost's velocity estimate differs by more than the gate. Distinct
    # from clutter-born false tracks (members match nothing).
    ghost_tracks: int = 0

    @property
    def track_pd(self) -> float:
        return float(self.truth_detected.mean())

    @property
    def fragmentation(self) -> float:
        """Mean matched-track count over DETECTED truths (1.0 = clean)."""
        d = self.truth_n_tracks[self.truth_detected]
        return float(d.mean()) if len(d) else np.nan


# default truth-match gates (2 range cells of slack + the Doppler-
# resolution scale). Scripts that record gates in their artifacts derive
# the record from this dict so the artifact cannot silently disagree
# with the scoring (self-review round 5).
DEFAULT_MATCH_GATES = {"range_m": 60.0, "velocity_ms": 3.0,
                       "elevation_deg": 5.0, "purity_floor": 0.5}


def score_tracks(log, tracks, truth: TargetBatch, num_frames: int,
                 cfg: RadarConfig, kinematics: str = "simple",
                 gate_r: float = DEFAULT_MATCH_GATES["range_m"],
                 gate_v: float = DEFAULT_MATCH_GATES["velocity_ms"],
                 gate_el: float = DEFAULT_MATCH_GATES["elevation_deg"],
                 purity_floor: float = DEFAULT_MATCH_GATES["purity_floor"],
                 switch_floor: float = 0.3) -> TrackScore:
    """Score an associator output (``tracks`` over DetectionLog ``log``)
    against ``truth``'s trajectories. Gates default to the streaming-MC
    match gates (2 range cells of slack + the Doppler-resolution scale)."""
    k = truth.num_targets
    traj = truth_trajectories(truth, num_frames, cfg, kinematics)
    n = len(log)
    # assignment of every log row to a truth (or -1 = clutter)
    assign = np.full(n, -1, int)
    if n:
        fidx = log.frame.astype(int) - 1                  # [N] 0-based
        d_r = np.abs(log.range_m[None, :]
                     - traj["range_m"][:, fidx])          # [K, N]
        d_v = np.abs(log.velocity_ms[None, :]
                     - traj["velocity_ms"][:, fidx])
        d_e = np.abs(log.elevation_deg[None, :]
                     - traj["elevation_deg"][:, fidx])
        ok = (d_r <= gate_r) & (d_v <= gate_v) & (d_e <= gate_el)
        dist = np.where(ok, (d_r / gate_r)**2 + (d_v / gate_v)**2
                        + (d_e / gate_el)**2, np.inf)
        best = np.argmin(dist, axis=0)
        assign = np.where(np.isfinite(dist[best, np.arange(n)]), best, -1)

    # R/V-only assignment (elevation ignored) for ghost classification
    assign_rv = np.full(n, -1, int)
    if n:
        ok_rv = (d_r <= gate_r) & (d_v <= gate_v)
        dist_rv = np.where(ok_rv, (d_r / gate_r)**2 + (d_v / gate_v)**2,
                           np.inf)
        best_rv = np.argmin(dist_rv, axis=0)
        assign_rv = np.where(
            np.isfinite(dist_rv[best_rv, np.arange(n)]), best_rv, -1)

    truth_detected = np.zeros(k, bool)
    truth_n_tracks = np.zeros(k, int)
    covered: list[set] = [set() for _ in range(k)]
    false_tracks = 0
    ghost_tracks = 0
    switched = 0
    purity = np.zeros(len(tracks))
    for ti, tr in enumerate(tracks):
        members = tr.member_idx
        a = assign[members]
        counts = np.bincount(a[a >= 0], minlength=k)
        total = len(members)
        if total == 0 or counts.max(initial=0) < purity_floor * total:
            false_tracks += 1
            purity[ti] = counts.max(initial=0) / max(total, 1)
            rv = assign_rv[members]
            rv_counts = np.bincount(rv[rv >= 0], minlength=k)
            if total and rv_counts.max(initial=0) >= purity_floor * total:
                ghost_tracks += 1
            continue
        major = int(np.argmax(counts))
        purity[ti] = counts[major] / total
        truth_detected[major] = True
        truth_n_tracks[major] += 1
        covered[major].update(log.frame[members][a == major].tolist())
        minor = np.sort(counts)[-2] if k > 1 else 0
        if minor >= switch_floor * total:
            switched += 1
    coverage = np.array([len(c) / num_frames for c in covered])
    return TrackScore(n_truth=k, n_tracks=len(tracks),
                      truth_detected=truth_detected,
                      truth_coverage=coverage,
                      truth_n_tracks=truth_n_tracks,
                      false_tracks=false_tracks, track_purity=purity,
                      switched_tracks=switched, ghost_tracks=ghost_tracks)
