"""Host-side (numpy, float64) signal helpers used at precompute time — the
part of ``radar_tpu/utils/signal.py`` that ``waveform/precompute.py``
needs: Kaiser windows, FIR group delay, not-a-knot spline stencils."""

from __future__ import annotations

import numpy as np


def kaiser_window(n: int, beta: float) -> np.ndarray:
    """Kaiser window, identical definition to MATLAB ``kaiser(n, beta)``."""
    return np.kaiser(n, beta)


def fir_group_delay_mean(taps: np.ndarray, nfft: int = 512) -> int:
    """round(mean(grpdelay(taps))) for an FIR filter (v8_3:144), from the
    identity ``tau(w) = Re[DFT(n*h) / DFT(h)]`` on MATLAB's default grid."""
    taps = np.asarray(taps, dtype=np.float64)
    n = np.arange(len(taps))
    num = np.fft.rfft(n * taps, 2 * nfft)[:nfft]
    den = np.fft.rfft(taps, 2 * nfft)[:nfft]
    good = np.abs(den) > 1e-10 * np.max(np.abs(den))
    tau = np.real(num[good] / den[good])
    return int(round(float(np.mean(tau))))


def spline_upsample_matrix(n_points: int, times: int) -> np.ndarray:
    """Matrix Q [(n_points-1)*times + 1, n_points] with ``Q @ y`` equal to
    MATLAB ``interp1(0:n-1, y, 0:1/times:n-1, 'spline')`` (not-a-knot)."""
    from scipy.interpolate import CubicSpline

    x = np.arange(n_points, dtype=np.float64)
    xq = np.arange((n_points - 1) * times + 1, dtype=np.float64) / times
    cols = []
    for j in range(n_points):
        y = np.zeros(n_points)
        y[j] = 1.0
        cols.append(CubicSpline(x, y, bc_type="not-a-knot")(xq))
    return np.stack(cols, axis=1)


def next_pow2(n: int) -> int:
    """2 ** nextpow2(n) (v8_3:158-159)."""
    p = 1
    while p < n:
        p *= 2
    return p
