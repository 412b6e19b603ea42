"""Monopulse-slope calibration and beam-pattern utilities (host numpy) —
port of ``radar_tpu/doa/calibrate.py``, the reference's offline
calibration tools generalized to any DBF weight bank:

  - ``beam_patterns``: steering-vector sweep -> per-beam pattern and peak
    pointing angle (plot_beam_patterns.m:42-95, at the config's carrier
    unless told otherwise); ``beam_patterns_reference`` keeps that
    script's quirks, which reproduce the pasted beam-angle LUT.
  - ``calibrate_k_slopes``: for each adjacent beam pair, scan the crossover
    region, form the monopulse ratio and linear-fit ratio -> angle offset
    around the crossover to get the slope K
    (calibrate_all_monopulse_slopes.m:35-90), on the magnitude ratio
    (``waveform/precompute.py``'s synthetic banks) or the complex one (the
    reference script's).
"""

from __future__ import annotations

import numpy as np

from .steering import steering_vector


def beam_patterns(dbf_w: np.ndarray, element_spacing: float, wavelength: float,
                  scan_deg: np.ndarray | None = None,
                  wavelength_override: float | None = None):
    """Returns (scan_deg, patterns [B, len(scan)], peak_angles_deg [B]).

    patterns are linear magnitude of w_b . S(theta).
    """
    if scan_deg is None:
        scan_deg = np.arange(-90.0, 100.0 + 1e-9, 0.1)
    num_elements = dbf_w.shape[1]
    # wavelength_override reproduces the reference script's quirk of
    # evaluating patterns at fc=9500 MHz instead of the system's 9450 MHz
    # (plot_beam_patterns.m:20)
    s = steering_vector(scan_deg, num_elements, element_spacing,
                        wavelength_override or wavelength)
    resp = np.abs(dbf_w.conj() @ s)  # [B, G]
    peaks = scan_deg[np.argmax(resp, axis=1)]
    return scan_deg, resp, peaks


def beam_patterns_reference(dbf_w: np.ndarray,
                            element_spacing: float = 0.0138):
    """Quirk-faithful reproduction of the reference's beam-pattern script
    (plot_beam_patterns.m) — the procedure that generated the pasted
    ``beam_angles_deg`` LUT (main_simulate_echoes_with_array_v8_3.m:178):

      - weights fliplr'd (plot_beam_patterns.m:40),
      - carrier fc = 9500 MHz, NOT the system's 9450 (:20),
      - 1-based element indices (:52 — magnitude-invariant, kept for
        bit-level fidelity of the complex responses),
      - pattern = w . S with NO conjugation (:64),
      - scan -90..100 deg at 0.1 deg (:49).

    Returns (scan_deg, patterns [B, G] linear magnitude, peak_angles [B]).
    On the measured 16-channel CSV the peaks reproduce the LUT EXACTLY
    (every entry lands on the same 0.1-deg scan sample); evaluated at the
    system's true 9450 MHz they drift up to 0.8 deg at the steepest beam —
    the LUT is a product of the quirky script, preserved as such."""
    c = 2.99792458e8
    wavelength = c / 9500e6
    scan_deg = np.arange(-90.0, 100.0 + 1e-9, 0.1)
    w = np.fliplr(np.asarray(dbf_w))
    s = steering_vector(scan_deg, w.shape[1], element_spacing, wavelength,
                        index_base=1)
    resp = np.abs(w @ s)  # no conj (plot_beam_patterns.m:64)
    peaks = scan_deg[np.argmax(resp, axis=1)]
    return scan_deg, resp, peaks


def calibrate_k_slopes(dbf_w: np.ndarray, beam_angles_deg: np.ndarray,
                       element_spacing: float, wavelength: float,
                       num_scan: int = 501, fit_half_width: int = 5,
                       ratio: str = "magnitude",
                       span_factor: float = 0.5) -> np.ndarray:
    """Monopulse slope K per adjacent beam pair, [B-1].

    For pair p the crossover is the midpoint of the two pointing angles; the
    scan spans +/- ``span_factor * separation`` around it. The slope is the
    linear-fit coefficient of (angle - crossover) against the monopulse
    ratio over ``2*fit_half_width+1`` samples centered on the crossover.

    Two ratio conventions:
      - "magnitude" (default): ratio = (|A|-|B|)/(|A|+|B|) — SELF-CONSISTENT
        with how the v8 pipeline applies K (monopulse on |RDM| values,
        fun_process_single_frame.m:282-285); used to auto-calibrate
        synthetic banks so estimation is unbiased by construction.
      - "complex": ratio = real((A-B)/(A+B)) on the complex field responses
        — the procedure of calibrate_all_monopulse_slopes.m:56-72 (weights
        must already carry the caller's channel convention, e.g. fliplr for
        that script's :26).

    NB reference inconsistency (documented, not a bug here): running the
    committed calibrate_all_monopulse_slopes.m procedure on the committed
    DBF CSV yields K = [-2.54, -2.33, ..., -21.5], which does NOT match the
    LUT pasted into main_simulate_echoes_with_array_v8_3.m:179
    ([-4.64 ... -8.76]); no parameterization of the committed scripts
    (fit window, scan span, magnitude-vs-complex) reproduces the pasted
    values. The framework ships the pasted LUT as the measured constant
    (config/assets.py) and exposes both calibration procedures.
    """
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
        if ratio == "complex":
            ca = dbf_w[p] @ s
            cb = dbf_w[p + 1] @ s
            r = np.real((ca - cb) / (ca + cb))
        else:
            ra = np.abs(dbf_w[p].conj() @ s)
            rb = np.abs(dbf_w[p + 1].conj() @ s)
            r = (ra - rb) / (ra + rb + np.finfo(np.float64).eps)
        c = int(np.argmin(np.abs(scan - mid)))
        lo, hi = c - fit_half_width, c + fit_half_width + 1
        coeff = np.polyfit(r[lo:hi], scan[lo:hi] - mid, 1)
        ks[p] = coeff[0]
    return ks
