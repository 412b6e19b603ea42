"""Per-frame target state — the ``TargetBatch`` of
``radar_tpu/sim/scenario.py`` (host numpy, struct-of-arrays [K])."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
