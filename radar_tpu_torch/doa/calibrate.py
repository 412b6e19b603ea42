"""Monopulse-slope calibration — the part of ``radar_tpu/doa/calibrate.py``
that ``waveform/precompute.py`` needs for synthetic (non-16-channel) banks
(calibrate_all_monopulse_slopes.m:35-90, magnitude-ratio convention)."""

from __future__ import annotations

import numpy as np

from .steering import steering_vector


def calibrate_k_slopes(dbf_w: np.ndarray, beam_angles_deg: np.ndarray,
                       element_spacing: float, wavelength: float,
                       num_scan: int = 501, fit_half_width: int = 5,
                       span_factor: float = 0.5) -> np.ndarray:
    """Monopulse slope K per adjacent beam pair, [B-1]: the linear-fit
    coefficient of (angle - crossover) against (|A|-|B|)/(|A|+|B|) over
    ``2*fit_half_width+1`` scan samples centred on the crossover."""
    beam_angles_deg = np.asarray(beam_angles_deg, np.float64)
    num_beams, num_elements = dbf_w.shape
    ks = np.zeros(num_beams - 1)
    for p in range(num_beams - 1):
        a0, a1 = beam_angles_deg[p], beam_angles_deg[p + 1]
        mid = 0.5 * (a0 + a1)
        sep = abs(a1 - a0)
        scan = np.linspace(mid - span_factor * sep, mid + span_factor * sep,
                           num_scan)
        s = steering_vector(scan, num_elements, element_spacing, wavelength)
        ra = np.abs(dbf_w[p].conj() @ s)
        rb = np.abs(dbf_w[p + 1].conj() @ s)
        r = (ra - rb) / (ra + rb + np.finfo(np.float64).eps)
        c = int(np.argmin(np.abs(scan - mid)))
        lo, hi = c - fit_half_width, c + fit_half_width + 1
        ks[p] = np.polyfit(r[lo:hi], scan[lo:hi] - mid, 1)[0]
    return ks
