"""Per-stage array checkpointing — port of ``radar_tpu/io/checkpoint.py``
(SURVEY.md section 5.4), host numpy.

The reference's real-data pipeline persists every stage to .mat gated by ten
``config.save_options.*`` booleans with per-stage output directories
(main_test_with_simulated_data.m:26-35,143-163), and the early sim drivers
persist frames as ``frame_sim_array_N.mat`` holding ``raw_iq_data`` +
``servo_angle`` (main_simulate_echoes_with_array.m:225-229, _v2.m:281-293)
that downstream debug scripts reload (debug_simulated_data_processing.m:
160-164).

Here: compressed .npz per (stage, frame) under one checkpoint root, the
same stage granularity, frame-scenario save/load for sim replay, and the
resume guard shared by every store (restart-on-failure for the frame loop,
SURVEY.md section 5.3).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np


# stage name -> subdirectory (mirrors config.output_paths.*)
STAGE_DIRS = {
    "frameheads": "framehead_information",
    "iq_before_dbf": "iq_data_before_dbf",
    "iq_after_dbf": "baseband_raw_data",
    "pc": "pulse_compressed_data",
    "mtd": "mtd_data",
    "cfar_flags": "cfar_flags",
    "beam_sum_cfar": "beam_sum_cfar",
    "measurements": "beam_diff_estimation",
    "cumulative_log": "beam_diff_estimation_cumulative",
    "tracks": "tracks",
}


@dataclasses.dataclass(frozen=True)
class SaveOptions:
    """Per-stage persistence switches (ref ``config.save_options``)."""

    frameheads: bool = False
    iq_before_dbf: bool = False
    iq_after_dbf: bool = False
    pc: bool = False
    mtd: bool = False
    cfar_flags: bool = False
    beam_sum_cfar: bool = False
    measurements: bool = True
    cumulative_log: bool = True
    tracks: bool = True

    def enabled(self, stage: str) -> bool:
        return getattr(self, stage, False)


def check_run_manifest(root: str, manifest: dict) -> None:
    """Resume guard shared by every store: persist ``manifest`` (without
    its None values) as ``root/run_manifest.json`` on first use, and raise
    ValueError if an existing manifest disagrees on any non-None field. A
    resumed run with a different (seed, config, scene schedule) would
    otherwise splice stale checkpoints into a self-consistent-looking but
    wrong result."""
    path = os.path.join(root, "run_manifest.json")
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
        bad = {k: (existing.get(k), v) for k, v in manifest.items()
               if v is not None and existing.get(k) != v}
        if bad:
            raise ValueError(
                f"checkpoint store at {root} was written by a "
                f"different run; mismatched fields {bad}. Use a fresh "
                "--out directory or delete the stale store.")
    else:
        os.makedirs(root, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({k: v for k, v in manifest.items()
                       if v is not None}, f, indent=1)
        os.replace(tmp, path)


class CheckpointStore:
    """Filesystem store for per-(stage, frame) arrays."""

    def __init__(self, root: str, options: SaveOptions | None = None):
        self.root = root
        self.options = options or SaveOptions()

    def _path(self, stage: str, frame_idx: int) -> str:
        d = os.path.join(self.root, STAGE_DIRS.get(stage, stage))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"frame_{frame_idx:06d}.npz")

    def save(self, stage: str, frame_idx: int, /, **arrays: Any) -> str | None:
        """Persist arrays for a stage if its switch is on; returns the path.

        The write is atomic (a temporary file in the same directory, then
        ``os.replace``): a crash mid-write must never leave a truncated
        .npz that ``frames_done`` would count as a completed frame."""
        if not self.options.enabled(stage):
            return None
        path = self._path(stage, frame_idx)
        # the temporary name must END in .npz (np.savez appends it
        # otherwise) and must NOT start with "frame_" (frames_done's prefix)
        tmp = os.path.join(os.path.dirname(path),
                           f".tmp_{os.getpid()}_frame_{frame_idx:06d}.npz")
        try:
            np.savez_compressed(
                tmp, **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def load(self, stage: str, frame_idx: int) -> dict[str, np.ndarray]:
        path = self._path(stage, frame_idx)
        with np.load(path) as f:
            return {k: f[k] for k in f.files}

    def has(self, stage: str, frame_idx: int) -> bool:
        return os.path.exists(self._path(stage, frame_idx))

    def check_manifest(self, manifest: dict) -> None:
        """Guard against resuming into a store written by a DIFFERENT run
        (``check_run_manifest``). Fields whose value is None are not
        compared (num_frames: extending a run with more frames is the
        intended resume use)."""
        check_run_manifest(self.root, manifest)

    def frames_done(self, stage: str) -> list[int]:
        """Frame indices persisted for a stage: the resume point of a
        restarted run."""
        d = os.path.join(self.root, STAGE_DIRS.get(stage, stage))
        if not os.path.isdir(d):
            return []
        out = []
        for name in sorted(os.listdir(d)):
            if name.startswith("frame_") and name.endswith(".npz"):
                out.append(int(name[6:-4]))
        return out


def save_sim_frame(path: str, raw_iq: np.ndarray, servo_angle: float,
                   frame_idx: int) -> None:
    """The v1/v2 drivers' frame_sim_array_N.mat persistence."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, raw_iq_data=np.asarray(raw_iq),
                        servo_angle=np.float64(servo_angle),
                        frame_idx=np.int64(frame_idx))


def load_sim_frame(path: str) -> tuple[np.ndarray, float, int]:
    with np.load(path) as f:
        return f["raw_iq_data"], float(f["servo_angle"]), int(f["frame_idx"])


def save_detection_log_json(path: str, log) -> None:
    """Cumulative measurement log as JSON (the .bin export analog)."""
    rows = [{"range_m": float(log.range_m[i]),
             "velocity_ms": float(log.velocity_ms[i]),
             "elevation_deg": float(log.elevation_deg[i]),
             "power": float(log.power[i]),
             "frame": int(log.frame[i]),
             "azimuth_deg": float(log.azimuth_deg[i])}
            for i in range(len(log))]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
