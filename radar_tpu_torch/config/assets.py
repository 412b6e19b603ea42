"""Calibration data assets — port of ``radar_tpu/config/assets.py``.

The inline constants are copied; the measured ``.npz`` assets are read by
path from the reference package's data directory (data, not an import, so
both packages start from the same bytes).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                         "radar_tpu", "config", "data")

# Narrow-pulse FIR matched-filter taps, scaled as 6*taps/max(taps)
# (v8_3:141-142). Linear-phase, 35 taps, group delay 17.
FIR_TAPS_RAW = np.array(
    [794, 1403, 2143, 2672, 2591, 1711, -58, -2351, -4592, -5855, -5338,
     -2389, 3005, 10341, 18410, 25779, 30907, 32768, 30907, 25779, 18410,
     10341, 3005, -2389, -5338, -5855, -4592, -2351, -58, 1711, 2591, 2672,
     2143, 1403, 794], dtype=np.float64)

# Calibrated pointing angle of each of the 13 measured beams, degrees
# (v8_3:178).
BEAM_ANGLES_DEG_16CH = np.array(
    [-16.0, -9.6, -3.2, 3.2, 9.6, 16.0, 22.6, 29.2, 36.1, 43.3, 51.0, 59.6,
     70.3], dtype=np.float64)

# Calibrated monopulse slope K for each of the 12 adjacent-beam pairs
# (v8_3:179).
K_SLOPES_LUT_16CH = np.array(
    [-4.6391, -4.6888, -4.7578, -4.7891, -4.7214, -4.7513, -5.2343, -5.4529,
     -5.7323, -6.1685, -7.0256, -8.7612], dtype=np.float64)

# Real-data path nominal beam angles (main_test_with_simulated_data.m:72).
BEAM_ANGLES_DEG_REALDATA = np.array(
    [-12.5, -7.5, -2.5, 2.5, 7.5, 12.5, 17.5, 22.5, 27.5, 32.5, 37.5, 42.5,
     47.5], dtype=np.float64)


def fir_taps() -> np.ndarray:
    """Scaled narrow-pulse FIR taps, ``6 * taps / max(taps)`` (v8_3:142)."""
    return 6.0 * FIR_TAPS_RAW / FIR_TAPS_RAW.max()


@functools.cache
def dbf_coeffs() -> np.ndarray:
    """Measured DBF matrix W, complex [13 beams, 16 channels]."""
    with np.load(os.path.join(_DATA_DIR, "dbf_coeffs.npz")) as f:
        return f["dbf"]


@functools.cache
def angle_k_table() -> np.ndarray:
    """Monopulse K vs frequency point, [11, 12] (real-data path)."""
    with np.load(os.path.join(_DATA_DIR, "angle_k.npz")) as f:
        return f["angle_k"]


@functools.cache
def ddc_fir_taps() -> np.ndarray:
    """12-tap decimation low-pass (reference ``FIR.mat`` variable ``Num``,
    used by the mixing/decimation tutorial, simulation_learn.m:94-102)."""
    with np.load(os.path.join(_DATA_DIR, "ddc_fir.npz")) as f:
        return f["taps"]
