"""Host-side scenario state — port of ``radar_tpu/sim/scenario.py:31-127``
(host numpy, float64, struct-of-arrays [K]).

The v9.2 "real track" model of the reference driver
(main_simulate_echoes_with_array_v8_3.m:100-117, 203-228): each target
flies a straight, constant-altitude, constant-ground-speed line; per frame
the slant range, elevation and radial velocity are recomputed from the
evolved ground range:

  H        = R0 * sin(El0)                 (constant)
  V_ground = V_rad0 / cos(El0)             (constant)
  R_g(t+1) = R_g(t) - V_ground * T_frame
  R        = sqrt(R_g^2 + H^2)
  El       = asin(H / R)
  V_rad    = V_ground * cos(El)

The servo azimuth advances ``rpm * 6 * T_frame`` degrees per frame, mod 360
(v8_3:24-25, 194, 207).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..config.params import RadarConfig


class TargetBatch(NamedTuple):
    range_m: np.ndarray
    velocity_ms: np.ndarray      # radial, positive = approaching
    elevation_deg: np.ndarray
    snr_db: np.ndarray

    @staticmethod
    def make(range_m, velocity_ms, elevation_deg, snr_db) -> "TargetBatch":
        f = lambda x: np.atleast_1d(np.asarray(x, np.float64))
        return TargetBatch(f(range_m), f(velocity_ms), f(elevation_deg),
                           f(snr_db))

    @property
    def num_targets(self) -> int:
        return int(np.shape(self.range_m)[0])


@dataclasses.dataclass
class Scenario:
    """Evolving multi-frame scenario (host state).

    ``kinematics``: "altitude" (default, the v8_3 model above) or "simple"
    (the v8_2 model, ``R -= V * T_frame`` with elevation and radial
    velocity constant, main_simulate_echoes_with_array_v8_2.m:200-205)."""

    const_h: np.ndarray          # altitude per target [K]
    const_v_ground: np.ndarray   # ground speed per target [K]
    current_r_ground: np.ndarray
    snr_db: np.ndarray
    azimuth_deg: float
    kinematics: str = "altitude"
    # simple-model state (unused under "altitude")
    current_r: np.ndarray | None = None
    const_v: np.ndarray | None = None
    const_el: np.ndarray | None = None

    @staticmethod
    def from_initial(initial: TargetBatch, cfg: RadarConfig,
                     kinematics: str = "altitude") -> "Scenario":
        if kinematics not in ("altitude", "simple"):
            raise ValueError(f"unknown kinematics model {kinematics!r}")
        el = np.deg2rad(initial.elevation_deg)
        return Scenario(
            const_h=initial.range_m * np.sin(el),
            const_v_ground=initial.velocity_ms / np.cos(el),
            current_r_ground=initial.range_m * np.cos(el),
            snr_db=initial.snr_db.copy(),
            azimuth_deg=cfg.scan.start_azimuth_deg,
            kinematics=kinematics,
            current_r=initial.range_m.copy(),
            const_v=initial.velocity_ms.copy(),
            const_el=initial.elevation_deg.copy(),
        )

    def step(self, cfg: RadarConfig) -> TargetBatch:
        """Advance one frame and return the target state to process (the
        reference advances the state before processing each frame)."""
        t_frame = cfg.sig.frame_time
        self.azimuth_deg = float(
            np.mod(self.azimuth_deg + cfg.scan.deg_per_frame(cfg.sig), 360.0))
        if self.kinematics == "simple":
            self.current_r = self.current_r - self.const_v * t_frame
            return TargetBatch(self.current_r.copy(), self.const_v.copy(),
                               self.const_el.copy(), self.snr_db.copy())
        self.current_r_ground = (self.current_r_ground
                                 - self.const_v_ground * t_frame)
        r = np.sqrt(self.current_r_ground**2 + self.const_h**2)
        el = np.rad2deg(np.arcsin(self.const_h / r))
        v_rad = self.const_v_ground * np.cos(np.deg2rad(el))
        return TargetBatch(r, v_rad, el, self.snr_db.copy())


def default_two_target_scene() -> TargetBatch:
    """The v8_3 driver's initial scene (v8_3:30-37)."""
    return TargetBatch.make([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                            [10.0, 15.0])


def five_target_scene() -> TargetBatch:
    """The v8_2 driver's 5-target scene, SNR -20..+15 dB
    (main_simulate_echoes_with_array_v8_2.m:28-51); v8_2 evolves it with
    the "simple" kinematics."""
    return TargetBatch.make(
        [3000.0, 5000.0, 6500.0, 8000.0, 10000.0],
        [15.0, 20.0, 10.0, 5.0, 8.0],
        [10.0, 5.0, 15.0, 20.0, 8.0],
        [-10.0, 1.0, -20.0, 5.0, 15.0])
