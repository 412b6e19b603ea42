"""Multi-frame simulation driver and inter-frame track association — port
of ``radar_tpu/pipeline/driver.py:27-171, 374-433`` (reference
main_simulate_echoes_with_array_v8_3.m).

The host owns the frame loop and the scenario evolution (v8_3:200-248);
each frame's device work is one call of the frame processor. Final targets
accumulate in a cumulative detection log with the frame index and servo
azimuth (v8_3:236-246), then associate into tracks by 5D BFS clustering
(v8_3:253-335) with the reference's hybrid merge: winner-take-all by power
for range, velocity, elevation and power, power-weighted mean azimuth, and
first/last frame and point-count statistics.

Frame seeds. JAX keys frame ``i`` with ``jax.random.fold_in(key, i)``; the
port derives the integer ``frame_seed(seed, i) = (seed mod 2^32) * 2^32 +
i`` (distinct for every frame of every run seed below 2^32, for frame
indices below 2^32). Its high and low words are the Philox key of K1 and
K5, and it seeds the ``torch.Generator`` of the other draws. The
Monte-Carlo studies key trial ``t`` at point ``i`` (SNR index or scene)
with ``trial_seed(seed, i, t) = (seed mod 2^32) * 2^32 + i * 2^20 + t``,
where JAX folds ``i`` and splits keys per batch.

Association runs the dense numpy BFS (``cluster/connected.py::
connected_components_np``), which gives the same partition and component
order as the JAX package's native spatial-hash engine.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..cluster.connected import connected_components_np
from ..config.params import RadarConfig
from ..sim.scenario import Scenario, TargetBatch
from .frame import make_frame_processor


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
    gates = [(log.range_m, ifc.gate_r(cfg.cluster)),
             (log.velocity_ms, ifc.gate_v(cfg.cluster)),
             (log.azimuth_deg, ifc.gate_az_deg),
             (log.elevation_deg, ifc.gate_el(cfg.cluster)),
             (log.frame.astype(float), float(ifc.max_frame_gap))]
    adj = np.ones((n, n), dtype=bool)
    for i, (f, g) in enumerate(gates):
        d = np.abs(f[:, None] - f[None, :])
        if i == 2 and ifc.wrap_azimuth:
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


def run_multiframe(cfg: RadarConfig, initial_targets: TargetBatch,
                   num_frames: int, seed: int = 0, processor=None,
                   precomp=None, progress: bool = False, store=None,
                   kinematics: str = "altitude", *, device="cuda"):
    """Run the multi-frame simulation on ``device`` (the card by default;
    ``"cpu"`` runs the plain versions); returns (log, tracks, scenario).
    ``processor`` may be a frame processor built once and reused (called
    as ``processor(frame_seed, targets)``). Resuming from a ``store`` is
    not ported."""
    if store is not None:
        raise NotImplementedError(
            "store= (resume from a checkpoint store) is not ported")
    if processor is None:
        processor = make_frame_processor(cfg, precomp, device=device)
    scen = Scenario.from_initial(initial_targets, cfg, kinematics)
    log = DetectionLog.empty()
    for frame_idx in range(1, num_frames + 1):
        targets = scen.step(cfg)
        result = processor(frame_seed(seed, frame_idx), targets)
        log.append_frame(result, frame_idx, scen.azimuth_deg)
        if progress:
            print(f"frame {frame_idx}/{num_frames}: "
                  f"{int(result.num_final)} targets, "
                  f"az={scen.azimuth_deg:.2f}")
    if cfg.inter_frame.enable:
        tracks = associate_tracks(log, cfg)
    else:
        tracks = tracks_without_association(log)
    return log, tracks, scen
