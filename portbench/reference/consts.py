"""The radar's constants, worked out from a configuration file's sizes.

Plain NumPy/SciPy in float64, after the upstream MATLAB driver
(XuZerui2023/Radar-Signal-Simulation-and-Target-Detection,
``main_simulate_echoes_with_array_v8_3.m:68-190``): the three-pulse Tx
waveform, the matched filters, the segment starts, the MTD window, the
range and velocity axes, the measured DBF bank with its beam angles and
monopulse slopes, the spline upsampling matrices of the peak refinement,
and the Cholesky factor of the beams' noise covariance. Nothing here is
read from the measured program.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
from scipy.interpolate import CubicSpline

_HERE = os.path.dirname(os.path.abspath(__file__))

# narrow-pulse FIR matched filter, scaled 6 * taps / max(taps) (v8_3:141-142)
FIR_TAPS_RAW = np.array(
    [794, 1403, 2143, 2672, 2591, 1711, -58, -2351, -4592, -5855, -5338,
     -2389, 3005, 10341, 18410, 25779, 30907, 32768, 30907, 25779, 18410,
     10341, 3005, -2389, -5338, -5855, -4592, -2351, -58, 1711, 2591, 2672,
     2143, 1403, 794], dtype=np.float64)
# calibrated pointing angles and monopulse slopes of the 13 measured beams
# (v8_3:178-179)
BEAM_ANGLES_DEG = np.array(
    [-16.0, -9.6, -3.2, 3.2, 9.6, 16.0, 22.6, 29.2, 36.1, 43.3, 51.0, 59.6,
     70.3])
K_SLOPES = np.array(
    [-4.6391, -4.6888, -4.7578, -4.7891, -4.7214, -4.7513, -5.2343, -5.4529,
     -5.7323, -6.1685, -7.0256, -8.7612])
F32_EPS = float(np.finfo(np.float32).eps)


class Segment(NamedTuple):
    """One pulse-compression segment: the causal convolution of the PRT's
    samples from ``start`` with ``h``, output gates [lo, hi) of that
    convolution, spliced at global gates [g0, g0 + hi - lo)."""
    h: np.ndarray
    start: int
    lo: int
    hi: int
    g0: int


class Radar(NamedTuple):
    conf: dict                  # the configuration file's "radar" tree
    num_p: int                  # pulses
    num_s: int                  # samples a PRT
    num_c: int                  # channels
    num_b: int                  # beams
    num_v: int                  # Doppler bins
    num_g: int                  # range gates
    wavelength: float
    tx: np.ndarray              # [S] complex
    p_signal: float             # mean |tx|^2 over its nonzero samples
    segments: tuple             # three Segment
    mtd_win: np.ndarray         # [P]
    range_axis: np.ndarray      # [G]
    velocity_axis: np.ndarray   # [V]
    delta_r: float
    delta_v: float
    dbf_w: np.ndarray           # [B, C] measured weights W (y = x @ W^H)
    beam_angles: np.ndarray     # [B]
    k_slopes: np.ndarray        # [B - 1]
    q_range: np.ndarray         # spline upsampling matrices
    q_vel: np.ndarray


def _kaiser(n: int, beta: float = 4.5) -> np.ndarray:
    return np.kaiser(n, beta)


def spline_matrix(n_points: int, times: int) -> np.ndarray:
    """Q with Q @ y = MATLAB interp1(0:n-1, y, 0:1/times:n-1, 'spline')."""
    x = np.arange(n_points, dtype=np.float64)
    xq = np.arange((n_points - 1) * times + 1) / times
    eye = np.eye(n_points)
    return np.stack([CubicSpline(x, eye[j], bc_type="not-a-knot")(xq)
                     for j in range(n_points)], axis=1)


def measured_dbf() -> np.ndarray:
    with open(os.path.join(_HERE, "dbf_coeffs_16x13.json")) as f:
        d = json.load(f)
    return np.asarray(d["re"]) + 1j * np.asarray(d["im"])


def radar(conf: dict) -> Radar:
    """The constants of the configuration tree ``conf`` (a configuration
    file's "radar" object)."""
    sig = conf["sig"]
    c, fs, fc = sig["c"], sig["fs"], sig["fc"]
    num_p, prt = sig["prt_num"], sig["prt"]
    num_c, num_b = sig["channel_num"], sig["beam_num"]
    if conf["array"]["num_elements"] != num_c:
        raise ValueError("the reference takes one element a channel")
    if (num_c, num_b) != (16, 13):
        raise NotImplementedError("the reference holds the measured "
                                  "16-channel, 13-beam DBF bank only")
    if conf.get("dbf_variant", "v8") != "v8":
        raise NotImplementedError("the reference runs the v8 DBF, x @ W^H")
    wavelength = c / fc
    num_s = round(prt * fs)
    tau1, tau2, tau3 = sig["tau"]
    gap1, gap2 = sig["gap_duration"][:2]
    bw = sig["bandwidth"]
    n1, n2, n3 = round(tau1 * fs), round(tau2 * fs), round(tau3 * fs)
    t2 = np.linspace(-tau2 / 2, tau2 / 2, n2)
    t3 = np.linspace(-tau3 / 2, tau3 / 2, n3)
    pulse2 = np.exp(1j * 2 * np.pi * 0.5 * (-bw / tau2) * t2 ** 2)
    pulse3 = np.exp(1j * 2 * np.pi * 0.5 * (bw / tau3) * t3 ** 2)
    tx = np.zeros(num_s, np.complex128)
    tx[:n1] = 1.0
    off1 = round((tau1 + gap1) * fs)
    tx[off1:off1 + n2] = pulse2
    off2 = off1 + round((tau2 + gap2) * fs)
    tx[off2:off2 + n3] = pulse3
    p_signal = float(np.mean(np.abs(tx[tx != 0]) ** 2))

    fir = 6.0 * FIR_TAPS_RAW / FIR_TAPS_RAW.max()
    if not np.array_equal(fir, fir[::-1]):
        raise ValueError("the narrow filter is not linear-phase")
    fir_delay = (len(fir) - 1) // 2          # its group delay, exactly
    mf_med = np.conj(pulse2 * _kaiser(n2))[::-1]
    mf_long = np.conj(pulse3 * _kaiser(n3))[::-1]
    g1, g2, g3 = sig["point_prt_segments"]
    gap1_n, gap2_n = round(gap1 * fs), round(gap2 * fs)
    starts = (n1, n1 + gap1_n + n2, n1 + gap1_n + n2 + gap2_n + n3)
    segments = (
        Segment(fir.astype(np.complex128), starts[0], fir_delay,
                fir_delay + g1, 0),
        Segment(mf_med, starts[1], g1, g1 + g2, g1),
        Segment(mf_long, starts[2], g1 + g2, g1 + g2 + g3, g1 + g2))
    num_g = g1 + g2 + g3

    num_v = conf.get("mtd_fft_len") or num_p
    v_max = wavelength / (2 * prt)
    velocity_axis = np.linspace(-v_max / 2, v_max / 2, num_v)
    # the reference's bin width v_max / P beside an axis spaced
    # v_max / (P - 1): an upstream quirk, kept
    delta_v = v_max / num_v
    delta_r = c / fs / 2
    w = measured_dbf()
    ip = conf["interp"]
    n_st = 2 * ip["extra_dots"] + 1
    return Radar(
        conf=conf, num_p=num_p, num_s=num_s, num_c=num_c, num_b=num_b,
        num_v=num_v, num_g=num_g, wavelength=wavelength, tx=tx,
        p_signal=p_signal, segments=segments, mtd_win=_kaiser(num_p),
        range_axis=np.arange(num_g) * delta_r, velocity_axis=velocity_axis,
        delta_r=delta_r, delta_v=delta_v, dbf_w=w,
        beam_angles=BEAM_ANGLES_DEG, k_slopes=K_SLOPES,
        q_range=spline_matrix(n_st, ip["r_interp_times"]),
        q_vel=spline_matrix(n_st, ip["v_interp_times"]))
