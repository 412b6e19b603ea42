"""ULA steering vectors and synthetic DBF banks — the part of
``radar_tpu/doa/steering.py`` that ``waveform/precompute.py`` needs.
Channel ``n`` sees phase ``+n * 2*pi*d*sin(theta)/lambda``
(fun_process_single_frame.m:163-169)."""

from __future__ import annotations

import numpy as np


def steering_vector(angles_deg: np.ndarray, num_elements: int,
                    element_spacing: float, wavelength: float) -> np.ndarray:
    """Steering matrix S, complex [num_elements, len(angles)]."""
    angles = np.deg2rad(np.atleast_1d(np.asarray(angles_deg, np.float64)))
    n = np.arange(num_elements)[:, None]
    phase = 2.0 * np.pi * element_spacing * np.sin(angles)[None, :] / wavelength
    return np.exp(1j * n * phase)


def synthesize_dbf_bank(beam_angles_deg: np.ndarray, num_elements: int,
                        element_spacing: float,
                        wavelength: float) -> np.ndarray:
    """Hamming-tapered beam-steering weight bank W, complex [beams, elems]."""
    taper = np.hamming(num_elements)
    s = steering_vector(beam_angles_deg, num_elements, element_spacing,
                        wavelength)  # [C, B]
    return (taper[:, None] * s).T.copy()


def default_synthetic_beam_angles(num_elements: int,
                                  num_beams: int) -> np.ndarray:
    """Beam grid for synthetic arrays: 6.4 deg spacing scaled by
    16/num_elements, starting at -16 deg (v8_3:178 geometry)."""
    spacing = 6.4 * 16.0 / num_elements
    return -16.0 + spacing * np.arange(num_beams, dtype=np.float64)
