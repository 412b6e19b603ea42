"""Multi-frame simulation drivers and inter-frame track association —
port of ``radar_tpu/pipeline/driver.py`` (reference
main_simulate_echoes_with_array_v8_3.m).

``run_multiframe``: the host owns the frame loop and the scenario
evolution (v8_3:200-248); each frame's device work is one call of the
frame processor. Final targets accumulate in a cumulative detection log
with the frame index and servo azimuth (v8_3:236-246), then associate into
tracks by 5D BFS clustering (v8_3:253-335) with the reference's hybrid
merge: winner-take-all by power for range, velocity, elevation and power,
power-weighted mean azimuth, and first/last frame and point-count
statistics.

``make_device_multiframe`` / ``run_multiframe_device``: the counterpart of
JAX's one-program ``lax.scan`` over frames. The kinematic state steps in
float32, operation for operation as JAX's scan body, and stays on the host
(five scalars a target; the echo factors are built on the host from numpy
targets). Each frame's ``FrameResult`` stays on the device; a chunk's
results are stacked there and come to the host once. With a store, the
run goes in chunks whose results and kinematic carry are saved, and a
rerun resumes from the last one, bit-identical to the run without chunks.

Frame seeds. JAX keys frame ``i`` with ``jax.random.fold_in(key, i)``; the
port derives the integer ``frame_seed(seed, i) = (seed mod 2^32) * 2^32 +
i`` (distinct for every frame of every run seed below 2^32, for frame
indices below 2^32). Its high and low words are the Philox key of K1 and
K5, and it seeds the ``torch.Generator`` of the other draws. The
Monte-Carlo studies key trial ``t`` at point ``i`` (SNR index or scene)
with ``trial_seed(seed, i, t) = (seed mod 2^32) * 2^32 + i * 2^20 + t``,
where JAX folds ``i`` and splits keys per batch.

Association runs the native spatial-hash engine (``native.py``, built at
first use; no fallback), and the dense numpy BFS where
``inter_frame.wrap_azimuth`` needs the circular azimuth metric the engine
lacks, as JAX dispatches them. Both give the same partition and component
order.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..cluster.connected import connected_components_np
from ..cluster.stages import ClusteredTargets
from ..config.params import RadarConfig
from ..sim.scenario import Scenario, TargetBatch
from .frame import FrameResult, make_frame_processor


def frame_seed(seed: int, frame_idx: int) -> int:
    """The integer seed of frame ``frame_idx`` of a run with ``seed``."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(frame_idx) & 0xFFFFFFFF)


def trial_seed(seed: int, point: int, trial: int) -> int:
    """The integer seed of Monte-Carlo trial ``trial`` at point ``point``
    (an SNR index of ``snr_sweep``, a scene of ``run_streaming_mc``) of a
    run with ``seed``: ``(seed mod 2^32) * 2^32 + point * 2^20 + trial``.
    Distinct for points below 2^12 and trials below 2^20 (larger ones
    raise); it depends on nothing else, so not on the batch size."""
    if not (0 <= point < 1 << 12 and 0 <= trial < 1 << 20):
        raise ValueError(f"trial_seed takes points below 2^12 and trials "
                         f"below 2^20, got ({point}, {trial})")
    return ((int(seed) & 0xFFFFFFFF) << 32) | (point << 20) | trial


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class DetectionLog:
    """Cumulative final-target log (ref ``cumulative_final_log``);
    struct-of-arrays, one row per final target per frame."""

    range_m: np.ndarray
    velocity_ms: np.ndarray
    elevation_deg: np.ndarray
    power: np.ndarray
    frame: np.ndarray        # int, 1-based like the reference's iFrame
    azimuth_deg: np.ndarray  # servo azimuth at that frame (iAntAngle)

    @staticmethod
    def empty() -> "DetectionLog":
        z = np.zeros(0)
        return DetectionLog(z, z, z, z, np.zeros(0, int), z)

    def __len__(self) -> int:
        return len(self.range_m)

    def append_frame(self, result, frame_idx: int, azimuth_deg: float):
        t = result.targets
        valid = _host(t.valid).astype(bool)
        n = int(valid.sum())
        cat = lambda a, b: np.concatenate([a, _host(b)[valid]])
        self.range_m = cat(self.range_m, t.range_m)
        self.velocity_ms = cat(self.velocity_ms, t.velocity_ms)
        self.elevation_deg = cat(self.elevation_deg, t.angle_deg)
        self.power = cat(self.power, t.power)
        self.frame = np.concatenate([self.frame, np.full(n, frame_idx)])
        self.azimuth_deg = np.concatenate(
            [self.azimuth_deg, np.full(n, azimuth_deg)])

    def append_rows(self, saved: dict, frame_idx: int):
        """Replay checkpointed measurement rows (the resume path of
        ``run_multiframe``): ``saved`` holds the per-frame arrays written
        by the "measurements" stage."""
        n = len(saved["range_m"])
        self.range_m = np.concatenate([self.range_m, saved["range_m"]])
        self.velocity_ms = np.concatenate(
            [self.velocity_ms, saved["velocity_ms"]])
        self.elevation_deg = np.concatenate(
            [self.elevation_deg, saved["elevation_deg"]])
        self.power = np.concatenate([self.power, saved["power"]])
        self.frame = np.concatenate([self.frame, np.full(n, frame_idx)])
        self.azimuth_deg = np.concatenate(
            [self.azimuth_deg, saved["azimuth_deg"]])


class Track(NamedTuple):
    """ref ``final_tracks_log`` entry (v8_3:310,327-334)."""

    range_m: float
    velocity_ms: float
    elevation_deg: float
    azimuth_deg: float
    power: float
    first_frame: int
    last_frame: int
    num_points: int
    member_idx: np.ndarray   # log rows of this track

    @property
    def height_m(self) -> float:
        """Target altitude H = R*sin(El), the v7_7 stage-2 derived field
        (main_simulate_echoes_with_array_v7_7.m:847)."""
        return self.range_m * float(np.sin(np.deg2rad(self.elevation_deg)))


def associate_tracks(log: DetectionLog, cfg: RadarConfig) -> list[Track]:
    """5D BFS association over the cumulative log (v8_3:276-335)."""
    n = len(log)
    if n == 0:
        return []
    ifc = cfg.inter_frame
    fields = (log.range_m, log.velocity_ms, log.azimuth_deg,
              log.elevation_deg, log.frame.astype(float))
    gates = (ifc.gate_r(cfg.cluster), ifc.gate_v(cfg.cluster),
             ifc.gate_az_deg, ifc.gate_el(cfg.cluster),
             float(ifc.max_frame_gap))
    if not ifc.wrap_azimuth:
        from ..native import associate_tracks_5d_native

        comp = associate_tracks_5d_native(*fields, gates)
    else:
        # the circular azimuth metric: the dense BFS, as JAX runs it
        adj = np.ones((n, n), dtype=bool)
        for i, (f, g) in enumerate(zip(fields, gates)):
            d = np.abs(f[:, None] - f[None, :])
            if i == 2:
                d = np.minimum(d, 360.0 - d)   # circular distance
            adj &= d <= g
        comp = connected_components_np(adj)

    tracks = []
    for cid in range(comp.max() + 1):
        m = np.nonzero(comp == cid)[0]
        powers = log.power[m]
        w = int(np.argmax(powers))
        if ifc.wrap_azimuth:
            # power-weighted circular mean: a cluster straddling north
            # merges to ~0 deg, not ~180
            az_r = np.deg2rad(log.azimuth_deg[m])
            az = float(np.mod(np.rad2deg(np.arctan2(
                (np.sin(az_r) * powers).sum(),
                (np.cos(az_r) * powers).sum())), 360.0))
        else:
            az = float((log.azimuth_deg[m] * powers).sum() / powers.sum())
        tracks.append(Track(
            range_m=float(log.range_m[m][w]),
            velocity_ms=float(log.velocity_ms[m][w]),
            elevation_deg=float(log.elevation_deg[m][w]),
            azimuth_deg=az, power=float(powers[w]),
            first_frame=int(log.frame[m].min()),
            last_frame=int(log.frame[m].max()),
            num_points=len(m), member_idx=m))
    return tracks


def tracks_without_association(log: DetectionLog) -> list[Track]:
    """inter_frame.enable=False passthrough (v8_3:337-352): one single-point
    track per log row."""
    return [Track(float(log.range_m[i]), float(log.velocity_ms[i]),
                  float(log.elevation_deg[i]), float(log.azimuth_deg[i]),
                  float(log.power[i]), int(log.frame[i]), int(log.frame[i]),
                  1, np.array([i]))
            for i in range(len(log))]


def make_device_multiframe(cfg: RadarConfig, precomp=None,
                           kinematics: str = "altitude", *, device="cuda"):
    """Multi-frame runner of JAX's device scan (``radar_tpu/pipeline/
    driver.py:174-243``): the kinematic state evolution (the v9.2 track
    model, v8_3:203-228, or under ``kinematics="simple"`` the v8_2 model
    ``R -= V*T`` with El and V constant, v8_2:200-205) and the frame
    processor, frame after frame, with no copy to the host in between.

    Returns ``run(seed, initial, num_frames, frame_offset=0,
    carry_in=None) -> (results, azimuths, carry_out)``. It runs frames
    ``frame_offset + 1 .. frame_offset + num_frames``; frame ``i`` takes
    ``frame_seed(seed, i)`` of the absolute index, so chunking never
    changes a draw. ``results`` stacks the frames' ``FrameResult`` leaves
    [num_frames, ...] on the device; ``azimuths`` [num_frames] and the
    carry (azimuth, r_state) are float32 numpy, ``r_state`` the ground
    range (the slant range under "simple"). A ``carry_in`` from an earlier
    chunk continues its state sequence bit for bit."""
    if kinematics not in ("altitude", "simple"):
        raise ValueError(f"unknown kinematics model {kinematics!r}")
    process = make_frame_processor(cfg, precomp, device=device)
    f32 = np.float32
    t_frame = f32(cfg.sig.frame_time)
    deg_per_frame = f32(cfg.scan.deg_per_frame(cfg.sig))

    def run(seed: int, initial: TargetBatch, num_frames: int,
            frame_offset: int = 0, carry_in=None):
        if num_frames < 1:
            raise ValueError(f"num_frames must be >= 1, got {num_frames}")
        # float32 throughout, step for step as JAX's scan body (:209-233)
        r0 = np.asarray(initial.range_m, f32)
        el0_deg = np.asarray(initial.elevation_deg, f32)
        el0 = np.deg2rad(el0_deg)
        v0 = np.asarray(initial.velocity_ms, f32)
        snr = np.asarray(initial.snr_db, f32)
        const_h = r0 * np.sin(el0)
        const_vg = v0 / np.cos(el0)
        if carry_in is None:
            carry_in = (cfg.scan.start_azimuth_deg,
                        r0 if kinematics == "simple" else r0 * np.cos(el0))
        azimuth, r_state = f32(carry_in[0]), np.asarray(carry_in[1], f32)
        results, azimuths = [], []
        for frame_idx in range(frame_offset + 1,
                               frame_offset + num_frames + 1):
            azimuth = np.mod(azimuth + deg_per_frame, f32(360.0))
            if kinematics == "simple":
                r_state = r_state - v0 * t_frame
                tb = TargetBatch(r_state, v0, el0_deg, snr)
            else:
                r_state = r_state - const_vg * t_frame
                r = np.sqrt(r_state**2 + const_h**2)
                el = np.rad2deg(np.arcsin(const_h / r))
                tb = TargetBatch(r, const_vg * np.cos(np.deg2rad(el)), el,
                                 snr)
            results.append(process(frame_seed(seed, frame_idx), tb))
            azimuths.append(azimuth)
        return (_stack(results), np.asarray(azimuths, f32),
                (azimuth, r_state))

    return run


def _stack(items: list):
    """Per-frame results (NamedTuples of tensors; None stays None) stacked
    along a new leading frame axis, on their device."""
    x0 = items[0]
    if x0 is None:
        return None
    if torch.is_tensor(x0):
        return torch.stack(items)
    return type(x0)(*(_stack(list(xs)) for xs in zip(*items)))


def _result_leaves(res: FrameResult) -> list:
    """The arrays of a (stacked) FrameResult, ``pair_idx`` where set."""
    return [x for x in (*res.targets, res.num_raw_detections,
                        res.num_final) if x is not None]


def _result_from_leaves(leaves: list) -> FrameResult:
    *targets, raw, final = leaves
    return FrameResult(ClusteredTargets(*targets), raw, final)


def device_results_to_log(results, azimuths) -> DetectionLog:
    """Stacked FrameResults [F, ...] (tensors on any device, or numpy) ->
    host DetectionLog, rows in frame order, then slot order."""
    t = results.targets
    valid = _host(t.valid).astype(bool)
    frame_idx = np.nonzero(valid)[0]
    rows = lambda x: _host(x)[valid].astype(np.float64)
    return DetectionLog(
        range_m=rows(t.range_m), velocity_ms=rows(t.velocity_ms),
        elevation_deg=rows(t.angle_deg), power=rows(t.power),
        frame=frame_idx + 1,
        azimuth_deg=_host(azimuths)[frame_idx].astype(np.float64))


def run_multiframe_device(cfg: RadarConfig, initial_targets: TargetBatch,
                          num_frames: int, seed: int = 0, precomp=None,
                          store=None, chunk_frames: int | None = None,
                          kinematics: str = "altitude", *, device="cuda"):
    """Device-scan counterpart of ``run_multiframe`` on ``device`` (the
    card by default); returns ``(log, tracks)`` (the kinematic state lives
    in the runner's carry, so no ``Scenario`` exists to return).

    ``store`` (an ``io.orbax_store.OrbaxFrameStore``) + ``chunk_frames``:
    restart-on-failure. The run goes in chunks; each chunk's stacked
    results and the kinematic carry are saved, keyed by the chunk's end
    frame, as flat leaves ``l0..ln`` plus ``azimuths``, ``carry_az`` and
    ``carry_rg``. A rerun replays the finished chunks from disk and
    resumes from the last carry, bit-identical to the run without chunks.
    A store written by a different run is refused."""
    runner = make_device_multiframe(cfg, precomp, kinematics, device=device)
    if store is None:
        results, azimuths, _ = runner(seed, initial_targets, num_frames)
    else:
        if not chunk_frames or chunk_frames <= 0:
            raise ValueError("store= needs chunk_frames > 0")
        if num_frames % chunk_frames:
            raise ValueError(f"num_frames {num_frames} not divisible by "
                             f"chunk_frames {chunk_frames}")
        from ..io.checkpoint import check_run_manifest

        check_run_manifest(store.root, {
            **_run_fingerprint(cfg, initial_targets, seed),
            "chunk_frames": int(chunk_frames),
            "kinematics": kinematics,   # the model changes the truth stream
        })
        done = set(store.frames_done())
        chunks, carry = [], None
        for lo in range(0, num_frames, chunk_frames):
            end = lo + chunk_frames
            if end in done:
                saved = store.restore(end)
                carry = (saved["carry_az"], saved["carry_rg"])
                n = sum(k[0] == "l" for k in saved)
                chunks.append(([saved[f"l{i}"] for i in range(n)],
                               saved["azimuths"]))
                continue
            res, az, carry = runner(seed, initial_targets, chunk_frames, lo,
                                    carry)
            # the chunk's one copy to the host
            leaves = [_host(x) for x in _result_leaves(res)]
            store.save(end, {**{f"l{i}": x for i, x in enumerate(leaves)},
                             "azimuths": az, "carry_az": carry[0],
                             "carry_rg": carry[1]})
            chunks.append((leaves, az))
        results = _result_from_leaves(
            [np.concatenate(xs) for xs in zip(*(c[0] for c in chunks))])
        azimuths = np.concatenate([c[1] for c in chunks])
    log = device_results_to_log(results, azimuths)
    if cfg.inter_frame.enable:
        tracks = associate_tracks(log, cfg)
    else:
        tracks = tracks_without_association(log)
    return log, tracks


def config_sha(cfg: RadarConfig) -> str:
    """Hash of every field of ``cfg`` (a frozen-dataclass tree, so its repr
    is deterministic), as the resume manifests record it."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _run_fingerprint(cfg: RadarConfig, targets: TargetBatch,
                     seed: int) -> dict:
    """Stable fingerprint of (config, initial scene, seed, dtype) for the
    resume manifest; the targets hash by their float64 bytes. The port's
    frame processor computes in complex64, the identity JAX's store holds
    for its default dtype."""
    h = hashlib.sha256()
    for f in (targets.range_m, targets.velocity_ms, targets.elevation_deg,
              targets.snr_db):
        h.update(np.ascontiguousarray(np.asarray(f, np.float64)).tobytes())
    return {
        "seed": int(seed),
        "config_sha": config_sha(cfg),
        "targets_sha": h.hexdigest()[:16],
        "dtype": "complex64",
        "num_frames": None,  # extending a run is allowed; not compared
    }


def run_multiframe(cfg: RadarConfig, initial_targets: TargetBatch,
                   num_frames: int, seed: int = 0, processor=None,
                   precomp=None, progress: bool = False, store=None,
                   kinematics: str = "altitude", *, device="cuda"):
    """Run the multi-frame simulation on ``device`` (the card by default;
    ``"cpu"`` runs the plain versions); returns (log, tracks, scenario).
    ``processor`` may be a frame processor built once and reused (called
    as ``processor(frame_seed, targets)``).

    ``store``: an ``io.checkpoint.CheckpointStore`` enabling
    restart-on-failure (SURVEY.md section 5.3/5.4): each frame's
    measurement rows are saved under the "measurements" stage, and a
    rerun with the same store replays the finished frames' rows from disk
    instead of recomputing them. The kinematics and the frame seeds are
    functions of (seed, frame index), so the resumed log equals the
    uninterrupted one. A store written by a different run is refused."""
    if store is not None:
        store.check_manifest({
            **_run_fingerprint(cfg, initial_targets, seed),
            "kinematics": kinematics,   # the model changes the truth stream
        })
    done = set(store.frames_done("measurements")) if store else set()
    if processor is None:
        processor = make_frame_processor(cfg, precomp, device=device)
    scen = Scenario.from_initial(initial_targets, cfg, kinematics)
    log = DetectionLog.empty()
    for frame_idx in range(1, num_frames + 1):
        targets = scen.step(cfg)
        if frame_idx in done:
            saved = store.load("measurements", frame_idx)
            log.append_rows(saved, frame_idx)
            if progress:
                print(f"frame {frame_idx}/{num_frames}: "
                      f"{len(saved['range_m'])} targets (resumed)")
            continue
        result = processor(frame_seed(seed, frame_idx), targets)
        log.append_frame(result, frame_idx, scen.azimuth_deg)
        if store is not None:
            rows = log.frame == frame_idx
            store.save("measurements", frame_idx,
                       range_m=log.range_m[rows],
                       velocity_ms=log.velocity_ms[rows],
                       elevation_deg=log.elevation_deg[rows],
                       power=log.power[rows],
                       azimuth_deg=log.azimuth_deg[rows])
        if progress:
            print(f"frame {frame_idx}/{num_frames}: "
                  f"{int(result.num_final)} targets, "
                  f"az={scen.azimuth_deg:.2f}")
    if cfg.inter_frame.enable:
        tracks = associate_tracks(log, cfg)
    else:
        tracks = tracks_without_association(log)
    return log, tracks, scen
