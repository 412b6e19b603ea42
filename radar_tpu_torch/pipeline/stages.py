"""Staged real-data processing pipeline — port of
``radar_tpu/pipeline/stages.py`` (SURVEY.md section 3.6; reference
main_test_with_simulated_data.m + process_stage2_mtd.m).

The reference's real-data adapter is a four-stage chain whose stage-3/4
functions are missing from its repository; the reference package rebuilt
them from the call sites and the inline copies in
debug_simulated_data_processing_v2.m (SURVEY.md section 2.4):

  stage 1  per-pulse DBF with the transposed (non-conjugated) coefficient
           matrix (main_test:210-214)
  stage 2  per-beam PC + MTD + zero-velocity clutter suppression
           (process_stage2_mtd.m:33-46 -> fun_MTD_produce, debug_v2:259-405);
           ``stage2_mtd`` is the committed single-frame form (a second frame
           is accepted and ignored), ``stage2_mtd_windowed`` the two-frame
           sliding CPI that the adapter's win_size=4 implies
  stage 3  sum-beam detection: adjacent-pair |MTD| sums through the
           segmented 1D CA-GO/SO CFAR (ops/cfar1d.py)
  stage 4  diff-beam measurement: spline range/velocity refinement +
           amplitude monopulse with the per-frequency-point K table indexed
           by the frame header's freq_no (main_test:219-221) and the
           site-corrected nominal beam angles (main_test:72-73)

The path works on already-gated 3404-sample IQ (point_PRT=3404,
main_test:52): pulse compression is segment-local with 'same'-aligned
matched filters (FFT products at a power-of-two length, cuFFT on the card,
where the reference package's CPU runs pocketfft), unlike the sim path's
full-PRT splice. Every stage runs on its input's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import assets
from ..config.params import RadarConfig
from ..measure.estimate import estimate_parameters
from ..ops.cfar import Detections, extract_detections, pair_sum_maps
from ..ops.cfar1d import segmented_cfar_1d, zero_velocity_mask
from ..ops.dbf import dbf
from ..ops.mtd import mtd
from ..utils.signal import kaiser_window, spline_upsample_matrix
from .frame import MeasureConsts


def realdata_beam_angles(cfg: RadarConfig) -> np.ndarray:
    """Nominal beam angles minus the elevation setting correction
    (main_test:72-73)."""
    return (assets.BEAM_ANGLES_DEG_REALDATA
            - cfg.corrected.elevation_setting_deg)


def _segment_pulses(cfg: RadarConfig):
    """The three reference pulses of the gated path: narrow sin pulse
    (v1-style, sin(2*pi*t+pi/2), debug_v2:316), medium/long LFM."""
    sig = cfg.sig
    fs, (tau1, tau2, tau3) = sig.fs, sig.tau
    ts = 1.0 / fs
    t1 = np.arange(-tau1 / 2, tau1 / 2 - ts / 2, ts)
    t2 = np.linspace(-tau2 / 2, tau2 / 2, round(tau2 * fs))
    t3 = np.linspace(-tau3 / 2, tau3 / 2, round(tau3 * fs))
    k2 = -sig.bandwidth / tau2
    k3 = sig.bandwidth / tau3
    p1 = np.sin(2 * np.pi * t1 + np.pi / 2).astype(np.complex128)
    p2 = np.exp(1j * 2 * np.pi * 0.5 * k2 * t2**2)
    p3 = np.exp(1j * 2 * np.pi * 0.5 * k3 * t3**2)
    return p1, p2, p3


def _stage2_pulse_compress(iq_beams: torch.Tensor, cfg: RadarConfig
                           ) -> torch.Tensor:
    """Segment-local matched filtering on gated [P, 3404, B] beam data,
    'same'-aligned (peak at the echo's gate), along the gate axis."""
    pieces = []
    start = 0
    for seg_i, (pulse, width) in enumerate(zip(_segment_pulses(cfg),
                                               cfg.sig.point_prt_segments)):
        seg = iq_beams[:, start:start + width]
        h = np.conj(pulse[::-1])
        if seg_i > 0:  # the medium/long LFM filters get the kaiser-4.5
            # window; the narrow sin pulse (segment 0) never does
            h = h * kaiser_window(len(pulse), 4.5)[::-1]
        lh = len(h)
        nfft = 1
        while nfft < width + lh - 1:
            nfft *= 2
        xf = torch.fft.fft(seg, n=nfft, dim=1)
        hf = torch.fft.fft(torch.as_tensor(np.ascontiguousarray(h),
                                           device=iq_beams.device).to(
            iq_beams.dtype), n=nfft)
        y = torch.fft.ifft(xf * hf[None, :, None], n=nfft, dim=1)
        pieces.append(y[:, lh - 1:lh - 1 + width])
        start += width
    return torch.cat(pieces, dim=1).to(iq_beams.dtype)


def _delta_v_bin(sig) -> float:
    """Velocity per Doppler bin: wavelength*prf/(2*prtNum)
    (main_test:120-122)."""
    return sig.wavelength * (1.0 / sig.prt) / (2.0 * sig.prt_num)


def _suppress_zero_velocity(rdm: torch.Tensor, cfg: RadarConfig,
                            dim: int = 0) -> torch.Tensor:
    """Zero the SAME Doppler index band the CFAR stage masks (center +/-
    MTD_0v_num) along ``dim``; an axis-based band would zero rows the CFAR
    mask does not cover, and every all-zero row would fire the ``>=``
    detector across all gates."""
    n0v = int(cfg.cfar1d.mtd_zero_vel_ms / _delta_v_bin(cfg.sig))
    band = ~zero_velocity_mask(cfg.sig.prt_num, n0v, rdm.device)
    band = band.reshape((-1,) + (1,) * (rdm.ndim - 1 - dim))
    return torch.where(band, torch.zeros((), dtype=rdm.dtype,
                                         device=rdm.device), rdm)


def stage2_mtd(iq_beams: torch.Tensor, cfg: RadarConfig,
               iq_beams_2: torch.Tensor | None = None,
               suppress_zero_vel: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """PC + MTD per beam on gated [P, 3404, B] beam data; returns
    (mtd_results, pc_results). A second frame is accepted for signature
    parity with the adapter and ignored; ``stage2_mtd_windowed`` is the
    sliding CPI."""
    del iq_beams_2
    pc = _stage2_pulse_compress(iq_beams, cfg)
    rdm = mtd(pc, kaiser_window(cfg.sig.prt_num, 4.5))
    if suppress_zero_vel:
        rdm = _suppress_zero_velocity(rdm, cfg)
    return rdm, pc


def stage2_mtd_windowed(iq_beams: torch.Tensor, iq_beams_2: torch.Tensor,
                        cfg: RadarConfig, win_size: int | None = None,
                        suppress_zero_vel: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-frame sliding-CPI MTD, the behavior the adapter's call signature
    implies (main_test_with_simulated_data.m:80,238; process_stage2_mtd.m
    takes one frame, SURVEY.md section 2.4): pulse-compress the 2P-pulse
    buffer once, then run a P-pulse MTD at ``win_size`` offsets hopping by
    P/win_size into frame 2. Slice 0 is the single-frame result; later
    slices straddle the frame boundary. The slices are overlapping strided
    views of the PC, transformed in one batched MTD.

    Returns ``(rdm_slices [win_size, P, 3404, B], pc [2P, 3404, B])``."""
    p = cfg.sig.prt_num
    if win_size is None:
        win_size = cfg.mtd_win_size
    if p % win_size != 0:
        raise ValueError(f"prt_num {p} is not divisible by win_size "
                         f"{win_size}")
    hop = p // win_size
    pc = _stage2_pulse_compress(torch.cat([iq_beams, iq_beams_2], dim=0),
                                cfg)
    s0, s1, s2 = pc.stride()
    slices = pc.as_strided((win_size, p) + tuple(pc.shape[1:]),
                           (hop * s0, s0, s1, s2))
    rdm = mtd(slices, kaiser_window(p, 4.5), dim=1)
    if suppress_zero_vel:
        rdm = _suppress_zero_velocity(rdm, cfg, dim=1)
    return rdm, pc


def pair_sum_maps_realdata(mtd_results: torch.Tensor) -> torch.Tensor:
    """Adjacent-beam amplitude sum maps [V, G, pairs] from the complex RDM,
    shared by stages 3 and 4."""
    return pair_sum_maps(mtd_results)


def stage3_detection(mtd_results: torch.Tensor, cfg: RadarConfig,
                     threshold_factor=None,
                     maps: torch.Tensor | None = None
                     ) -> tuple[Detections, torch.Tensor]:
    """Sum-beam segmented 1D CFAR; returns (preliminary detections in
    (pair, range, velocity) order, CFAR flag cube [V, G, pairs]).
    ``threshold_factor`` overrides the config value; pass
    ``maps=pair_sum_maps_realdata(mtd_results)`` to share the pair-sum
    cube with stage 4."""
    sig = cfg.sig
    if maps is None:
        maps = pair_sum_maps_realdata(mtd_results)
    flags, _ = segmented_cfar_1d(maps, cfg.cfar1d, sig.point_prt_segments,
                                 _delta_v_bin(sig),
                                 threshold_factor=threshold_factor)
    dets = extract_detections(flags, maps, cfg.cfar.max_detections,
                              layout="vgq")
    return dets, flags


class RealDataMeasurement(NamedTuple):
    """Stage-4 output rows (main_test:261-264 field names)."""

    range_m: torch.Tensor
    velocity_ms: torch.Tensor
    elevation_deg: torch.Tensor
    power: torch.Tensor
    pair_idx: torch.Tensor
    valid: torch.Tensor


def measure_consts(cfg: RadarConfig, freq_no: int, *,
                   device) -> MeasureConsts:
    """Stage-4 constants (axes, spline upsample matrices, the freq-point K
    row) as f32 tensors on ``device``. Hoist out of per-slice loops:
    nothing here depends on the data."""
    sig = cfg.sig
    ip = cfg.interp
    n = 2 * ip.extra_dots + 1
    angle_k = assets.angle_k_table()
    if not 0 <= freq_no < angle_k.shape[0]:
        # the reference indexes the 11x12 Angle_k CSV with the frame
        # header's frequency point, which is 1-BASED in MATLAB (1..11);
        # this API is 0-based — callers feeding .bin header values must
        # pass header_freq_no - 1 (SURVEY.md real-data adapter notes)
        raise ValueError(
            f"freq_no {freq_no} outside 0..{angle_k.shape[0] - 1} "
            "(0-based frequency-point index; a MATLAB-convention .bin "
            "header value is 1-based — pass header value minus 1)")
    k_row = -np.abs(angle_k[freq_no])  # slope sign: beam A below beam B
    v_max = sig.v_max
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return MeasureConsts(
        range_axis=t(np.arange(sig.n_total_gate, dtype=np.float64)
                     * (sig.c / (2 * sig.fs))),
        velocity_axis=t(np.linspace(-v_max / 2, v_max / 2, sig.prt_num)),
        delta_r=sig.c / (2 * sig.fs),
        delta_v=v_max / sig.prt_num,
        beam_angles_deg=t(realdata_beam_angles(cfg)),
        k_slopes_lut=t(k_row),
        q_range=t(spline_upsample_matrix(n, ip.r_interp_times)),
        q_vel=t(spline_upsample_matrix(n, ip.v_interp_times)))


def stage4_measurement(prelim: Detections, mtd_results: torch.Tensor,
                       cfg: RadarConfig, freq_no: int,
                       maps: torch.Tensor | None = None,
                       consts: MeasureConsts | None = None
                       ) -> RealDataMeasurement:
    """Spline refinement + monopulse with the freq-point K table row.
    ``maps``/``consts`` share the stage-3 pair-sum cube and the
    constants instead of recomputing them."""
    ip = cfg.interp
    mc = consts if consts is not None else measure_consts(
        cfg, freq_no, device=mtd_results.device)
    if maps is None:
        maps = pair_sum_maps_realdata(mtd_results)
    p = estimate_parameters(prelim, maps, mtd_results, mc, ip.extra_dots,
                            ip.r_interp_times, ip.v_interp_times,
                            monopulse_complex=cfg.monopulse_complex,
                            monopulse_refined=cfg.monopulse_refined)
    return RealDataMeasurement(
        range_m=p.range_m, velocity_ms=p.velocity_ms,
        elevation_deg=p.angle_deg, power=p.power, pair_idx=p.pair_idx,
        valid=p.valid)


def istc_compensate(iq: torch.Tensor, enable: bool = False) -> torch.Tensor:
    """Sensitivity-time-control (STC) compensation hook. The reference
    calls ``fun_iSTC`` before pulse compression, but the function is missing
    and the call commented out (debug_simulated_data_processing_v2.m:329):
    identity, kept as the place for a measured STC curve."""
    del enable
    return iq


def range_concat_dedup(pc: torch.Tensor) -> torch.Tensor:
    """Range de-duplication hook (``fun_lss_range_concate``), missing from
    the reference and commented out at its only call site
    (debug_simulated_data_processing_v2.m:337): identity, all 3404 gates
    kept."""
    return pc


def _dbf_realdata(raw_iq: torch.Tensor) -> torch.Tensor:
    return dbf(raw_iq, np.asarray(assets.dbf_coeffs()), "realdata")


def run_realdata_pipeline(raw_iq: torch.Tensor, cfg: RadarConfig,
                          freq_no: int = 6):
    """Full staged chain on gated raw IQ [P, 3404, C]; returns
    (measurements, detections, mtd_results)."""
    rdm, _pc = stage2_mtd(_dbf_realdata(raw_iq), cfg)
    maps = pair_sum_maps_realdata(rdm)   # shared by stages 3 + 4
    dets, _flags = stage3_detection(rdm, cfg, maps=maps)
    meas = stage4_measurement(dets, rdm, cfg, freq_no, maps=maps)
    return meas, dets, rdm


def run_realdata_pipeline_windowed(raw_iq: torch.Tensor,
                                   raw_iq_2: torch.Tensor, cfg: RadarConfig,
                                   freq_no: int = 6,
                                   win_size: int | None = None):
    """Two-frame sliding-CPI staged chain on gated raw IQ [P, 3404, C]
    pairs; stages 3-4 run per window slice, as the reference package runs
    them (the per-slice ``MTD_data_win`` layout of main_test:147). Returns
    ``(measurements [win_size], rdm_slices [win_size, P, 3404, B])``."""
    rdm_slices, _pc = stage2_mtd_windowed(
        _dbf_realdata(raw_iq), _dbf_realdata(raw_iq_2), cfg, win_size)
    mc = measure_consts(cfg, freq_no, device=raw_iq.device)   # once

    def per_slice(rdm):
        maps = pair_sum_maps_realdata(rdm)
        dets, _ = stage3_detection(rdm, cfg, maps=maps)
        return stage4_measurement(dets, rdm, cfg, freq_no, maps=maps,
                                  consts=mc)

    meas = [per_slice(rdm_slices[k]) for k in range(rdm_slices.shape[0])]
    return meas, rdm_slices
