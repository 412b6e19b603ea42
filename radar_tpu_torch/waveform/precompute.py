"""Tx waveform synthesis and per-config derived constants — port of
``radar_tpu/waveform/precompute.py``.

Host-side float64 numpy, run once per config, exactly as in the reference
(main_simulate_echoes_with_array_v8_3.m:86-190). ``from_numpy`` rebuilds a
``Precomputed`` from the JAX package's fields as plain arrays, so both
packages can be run on the very same constants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import assets
from ..config.params import RadarConfig
from ..doa.calibrate import calibrate_k_slopes
from ..doa.steering import default_synthetic_beam_angles, synthesize_dbf_bank
from ..utils.signal import (fir_group_delay_mean, kaiser_window, next_pow2,
                            spline_upsample_matrix)


class Precomputed(NamedTuple):
    """Derived-constant cache (reference ``precomputed_data``); same fields
    as ``radar_tpu.waveform.precompute.Precomputed``."""

    # waveform
    tx_pulse: np.ndarray            # [S] complex128
    p_signal_unscaled: float        # mean |tx|^2 over nonzero samples
    pulse_lengths: tuple            # (n1, n2, n3) samples
    # matched filters
    mf_narrow: np.ndarray           # [35] float64 FIR taps
    fir_delay: int
    mf_medium_win: np.ndarray       # [n2] complex time-domain MF
    mf_long_win: np.ndarray         # [n3] complex
    mf_medium_fft: np.ndarray       # [n_fft_med] complex
    mf_long_fft: np.ndarray         # [n_fft_long] complex
    n_fft_med: int
    n_fft_long: int
    # segmentation (0-based sample starts in the PRT)
    seg_start_narrow: int
    seg_start_medium: int
    seg_start_long: int
    gate_splits: tuple              # (n_gate_narrow, n_gate_medium, n_gate_long)
    n_total_gate: int
    # MTD
    mtd_win: np.ndarray             # [prt_num] float64 kaiser(4.5)
    # axes
    range_axis: np.ndarray          # [n_total_gate]
    velocity_axis: np.ndarray       # [prt_num]
    delta_r: float
    delta_v: float
    # beams
    dbf_w: np.ndarray               # [beams, channels] complex
    beam_angles_deg: np.ndarray     # [beams]
    k_slopes_lut: np.ndarray        # [beams-1]
    # spline peak-refinement stencil matrices (measure/)
    q_range: np.ndarray             # [(2*extra)*r_times+1, 2*extra+1]
    q_vel: np.ndarray               # [(2*extra)*v_times+1, 2*extra+1]


def from_numpy(fields: dict) -> Precomputed:
    """``Precomputed`` from a field dict of plain numpy arrays and scalars,
    e.g. ``jax_precomp._asdict()``. Every field must be present."""
    missing = set(Precomputed._fields) - set(fields)
    if missing:
        raise KeyError(f"missing Precomputed fields: {sorted(missing)}")
    out = {}
    for name in Precomputed._fields:
        v = fields[name]
        if isinstance(v, (tuple, list)):
            out[name] = tuple(int(x) for x in v)
        elif np.ndim(v) == 0 and not isinstance(v, np.ndarray):
            out[name] = v
        else:
            out[name] = np.array(v)
    return Precomputed(**out)


def build_tx_pulse(cfg: RadarConfig) -> tuple[np.ndarray, tuple]:
    sig = cfg.sig
    fs = sig.fs
    tau1, tau2, tau3 = sig.tau
    gap1, gap2 = sig.gap_duration[0], sig.gap_duration[1]
    n1 = round(tau1 * fs)
    n2 = round(tau2 * fs)
    n3 = round(tau3 * fs)
    k2 = -sig.bandwidth / tau2
    k3 = sig.bandwidth / tau3
    t2 = np.linspace(-tau2 / 2, tau2 / 2, n2)
    t3 = np.linspace(-tau3 / 2, tau3 / 2, n3)
    pulse2 = np.exp(1j * 2 * np.pi * (0.5 * k2 * t2**2))
    pulse3 = np.exp(1j * 2 * np.pi * (0.5 * k3 * t3**2))
    tx = np.zeros(sig.point_prt, dtype=np.complex128)
    tx[:n1] = np.ones(n1, dtype=np.complex128)
    off1 = round((tau1 + gap1) * fs)
    tx[off1:off1 + n2] = pulse2
    off2 = off1 + round((tau2 + gap2) * fs)
    tx[off2:off2 + n3] = pulse3
    return tx, (n1, n2, n3, pulse2, pulse3)


def build_dbf_bank(cfg: RadarConfig):
    """(dbf_w [B,C], beam_angles_deg [B], k_slopes [B-1]): the measured
    assets for the 16-channel/13-beam default, else a synthesized Hamming
    bank with self-calibrated K slopes."""
    sig, arr = cfg.sig, cfg.array
    if sig.channel_num == 16 and sig.beam_num == 13:
        return (assets.dbf_coeffs(), assets.BEAM_ANGLES_DEG_16CH,
                assets.K_SLOPES_LUT_16CH)
    angles = default_synthetic_beam_angles(sig.channel_num, sig.beam_num)
    dbf_w = synthesize_dbf_bank(angles, sig.channel_num, arr.element_spacing,
                                sig.wavelength)
    ks = calibrate_k_slopes(dbf_w, angles, arr.element_spacing,
                            sig.wavelength)
    return dbf_w, angles, ks


def precompute(cfg: RadarConfig) -> Precomputed:
    sig = cfg.sig
    fs = sig.fs
    tx, (n1, n2, n3, pulse2, pulse3) = build_tx_pulse(cfg)
    nz = tx[tx != 0]
    p_signal_unscaled = float(np.mean(np.abs(nz) ** 2))

    # matched filters (v8_3:141-161)
    mf_narrow = assets.fir_taps()
    fir_delay = fir_group_delay_mean(mf_narrow)
    mf_medium_win = np.conj(pulse2 * kaiser_window(n2, 4.5))[::-1]
    mf_long_win = np.conj(pulse3 * kaiser_window(n3, 4.5))[::-1]

    gap1_num = round(sig.gap_duration[0] * fs)
    gap2_num = round(sig.gap_duration[1] * fs)
    seg_start_narrow = n1                      # 0-based (ref 1-based: n1+1)
    seg_start_medium = n1 + gap1_num + n2
    seg_start_long = n1 + gap1_num + n2 + gap2_num + n3
    s_total = sig.point_prt
    n_fft_med = next_pow2(s_total - seg_start_medium + n2 - 1)
    n_fft_long = next_pow2(s_total - seg_start_long + n3 - 1)

    # axes (v8_3:170-177); delta_v = v_max/prt_num while the axis spacing
    # is v_max/(prt_num-1) — a reference quirk kept deliberately
    v_max = sig.v_max
    velocity_axis = np.linspace(-v_max / 2, v_max / 2, sig.prt_num)
    n_gate = sig.n_total_gate
    delta_r = sig.c * sig.ts / 2
    range_axis = np.arange(n_gate, dtype=np.float64) * delta_r

    dbf_w, beam_angles, k_slopes = build_dbf_bank(cfg)
    ip = cfg.interp
    return Precomputed(
        tx_pulse=tx,
        p_signal_unscaled=p_signal_unscaled,
        pulse_lengths=(n1, n2, n3),
        mf_narrow=mf_narrow,
        fir_delay=fir_delay,
        mf_medium_win=mf_medium_win,
        mf_long_win=mf_long_win,
        mf_medium_fft=np.fft.fft(mf_medium_win, n_fft_med),
        mf_long_fft=np.fft.fft(mf_long_win, n_fft_long),
        n_fft_med=n_fft_med,
        n_fft_long=n_fft_long,
        seg_start_narrow=seg_start_narrow,
        seg_start_medium=seg_start_medium,
        seg_start_long=seg_start_long,
        gate_splits=tuple(sig.point_prt_segments),
        n_total_gate=n_gate,
        mtd_win=kaiser_window(sig.prt_num, 4.5),
        range_axis=range_axis,
        velocity_axis=velocity_axis,
        delta_r=delta_r,
        delta_v=v_max / sig.prt_num,
        dbf_w=dbf_w,
        beam_angles_deg=np.asarray(beam_angles, np.float64),
        k_slopes_lut=np.asarray(k_slopes, np.float64),
        q_range=spline_upsample_matrix(2 * ip.extra_dots + 1,
                                       ip.r_interp_times),
        q_vel=spline_upsample_matrix(2 * ip.extra_dots + 1,
                                     ip.v_interp_times),
    )
