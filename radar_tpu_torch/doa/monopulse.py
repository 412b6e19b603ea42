"""Textbook sum/difference (sigma/delta) monopulse for a uniform linear
array (host numpy) — port of ``radar_tpu/doa/monopulse.py`` (SURVEY.md
section 2.2: singlepulse_angle.m).

Construction (singlepulse_angle.m:16-29):
  - sum beam:  Hamming amplitude taper
  - diff beam: Hamming taper x anti-symmetric linear phase ramp
               exp(j * linspace(-pi/2, pi/2, N))
Slope self-calibration (ref :62-70): probe a small off-boresight angle
(0.1 deg), k = calib_angle / Re(delta/sigma); estimate (ref :73-78):
theta_hat = k * Re(delta/sigma).

NB a flaw in the reference construction, preserved as the ``corrected=False``
variant: the linear-phase ramp exp(j*linspace(-pi/2, pi/2, N)) does NOT null
the diff beam at boresight (the symmetric Hamming taper leaves Re(delta/sigma)
~ 0.81 at 0 deg), so the reference's zero-offset calibration misestimates
off-boresight angles by ~16x. The default ``corrected=True`` calibrates both
the boresight offset and the slope, recovering the textbook behavior.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .steering import steering_vector


class SumDiffBeams(NamedTuple):
    coeffs_sum: np.ndarray   # [C]
    coeffs_diff: np.ndarray  # [C]
    k_monopulse: float       # deg per unit real(delta/sigma)
    ratio_offset: float      # Re(delta/sigma) at boresight (0 in textbooks)
    corrected: bool


def make_sum_diff_beams(num_elements: int, element_spacing: float,
                        wavelength: float, calib_angle_deg: float = 0.1,
                        corrected: bool = True) -> SumDiffBeams:
    win = np.hamming(num_elements)
    coeffs_sum = win.astype(np.complex128)
    phase = np.linspace(-np.pi / 2, np.pi / 2, num_elements)
    coeffs_diff = win * np.exp(1j * phase)

    def ratio_at(angle_deg):
        s = steering_vector(np.array([angle_deg]), num_elements,
                            element_spacing, wavelength)[:, 0]
        return np.real((s @ np.conj(coeffs_diff))
                       / (s @ np.conj(coeffs_sum)))

    r0 = float(ratio_at(0.0)) if corrected else 0.0
    k = calib_angle_deg / (float(ratio_at(calib_angle_deg)) - r0)
    return SumDiffBeams(coeffs_sum, coeffs_diff, float(k), r0, corrected)


def estimate_angle(beams: SumDiffBeams, signal_ch: np.ndarray) -> float:
    """theta_hat from one array snapshot [C] at the target peak."""
    out_sum = signal_ch @ np.conj(beams.coeffs_sum)
    out_diff = signal_ch @ np.conj(beams.coeffs_diff)
    return float(beams.k_monopulse
                 * (np.real(out_diff / out_sum) - beams.ratio_offset))


def sum_diff_patterns(beams: SumDiffBeams, element_spacing: float,
                      wavelength: float,
                      scan_deg: np.ndarray | None = None):
    """Normalized sigma/delta patterns in dB for plotting (ref :32-46)."""
    if scan_deg is None:
        scan_deg = np.arange(-90.0, 90.0 + 1e-9, 0.1)
    s = steering_vector(scan_deg, len(beams.coeffs_sum), element_spacing,
                        wavelength)
    p_sum = np.abs(beams.coeffs_sum @ s)
    p_diff = np.abs(beams.coeffs_diff @ s)
    db = lambda p: 20 * np.log10(p / p.max() + 1e-300)
    return scan_deg, db(p_sum), db(p_diff)
