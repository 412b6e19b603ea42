"""Kalman-filter track smoothing on top of the 5D associator — port of
``radar_tpu/pipeline/tracking.py`` (host numpy, as there).

Beyond-reference feature: the reference's inter-frame stage stops at BFS
association with a winner-take-all merge (main_simulate_echoes_with_array_
v8_3.m:253-335) — each track is summarized by its single strongest
detection. This module adds per-track state estimation: a forward Kalman
filter plus Rauch-Tung-Striebel backward smoother over the track's
detections, giving a full per-frame trajectory (range/velocity/elevation),
gap-bridging prediction, and innovation statistics.

Model: the scenario's kinematics are constant altitude + constant ground
speed (v8_3:100-117), so in radar coordinates the range rate equals the
measured closing velocity: dR/dt = -V (V > 0 closing, R shrinking — the
sim's convention). The filter state is x = [R, V] with transition
F = [[1, -T], [0, 1]], process noise from a white radial-acceleration
spectral density, and the coupled measurement z = [R_meas, V_meas], H = I.
Elevation runs through an independent [el, el_dot] constant-velocity
filter. All host-side numpy: tracks are tiny (tens of points) and the
associator is already a host stage.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..config.params import RadarConfig
from .driver import DetectionLog, Track


@dataclasses.dataclass(frozen=True)
class KalmanParams:
    """Noise model for the track smoother.

    ``sigma_*`` are measurement stds in the detection units (the defaults
    match the pipeline's single-cell quantization: delta_r ~ 6 m,
    delta_v ~ 0.4 m/s at the full config, monopulse angle ~ 0.5 deg);
    ``accel_psd`` is the white radial-acceleration spectral density
    (m^2/s^3) controlling how fast the radial velocity may drift —
    the constant-altitude flyby geometry bends V slowly, so the default
    is small."""

    sigma_r: float = 6.0
    sigma_v: float = 0.5
    sigma_el: float = 0.5
    accel_psd: float = 0.5
    el_rate_psd: float = 0.05


class SmoothedTrack(NamedTuple):
    """Per-frame smoothed trajectory of one associated track."""

    track: Track
    frames: np.ndarray          # int [n], measured frames (ascending)
    range_m: np.ndarray         # [n] RTS-smoothed
    velocity_ms: np.ndarray     # [n]
    elevation_deg: np.ndarray   # [n]
    elevation_rate_dps: np.ndarray  # [n] deg/s
    range_std_m: np.ndarray     # [n] posterior std
    velocity_std_ms: np.ndarray
    meas_range_m: np.ndarray    # the per-frame merged measurements
    meas_velocity_ms: np.ndarray
    meas_elevation_deg: np.ndarray
    innovation_nis: np.ndarray  # normalized innovation squared (R/V filter)

    def predict(self, frames_ahead: int, t_frame: float):
        """Extrapolate (range, velocity) ``frames_ahead`` frames past the
        last smoothed state under the constant-velocity model."""
        dt = frames_ahead * t_frame
        return (self.range_m[-1] - self.velocity_ms[-1] * dt,
                self.velocity_ms[-1])


def _merge_per_frame(log: DetectionLog, idx: np.ndarray):
    """One measurement per frame: power-weighted mean of same-frame rows
    (the stage-1 merge rule, fun_process_single_frame.m:344-349)."""
    frames = np.unique(log.frame[idx])
    r = np.empty(len(frames))
    v = np.empty(len(frames))
    el = np.empty(len(frames))
    for i, f in enumerate(frames):
        m = idx[log.frame[idx] == f]
        w = log.power[m]
        w = w / w.sum()
        r[i] = (log.range_m[m] * w).sum()
        v[i] = (log.velocity_ms[m] * w).sum()
        el[i] = (log.elevation_deg[m] * w).sum()
    return frames.astype(int), r, v, el


def _kf_rts(z: np.ndarray, dts: np.ndarray, f_of_dt, q_of_dt, h: np.ndarray,
            r_cov: np.ndarray, x0: np.ndarray, p0: np.ndarray):
    """Generic forward KF + RTS smoother.

    z [n, m] measurements; dts [n] time since previous measurement (dts[0]
    ignored); returns (xs [n, k] smoothed states, ps [n, k, k] smoothed
    covariances, nis [n])."""
    n, k = len(z), len(x0)
    xf = np.empty((n, k))
    pf = np.empty((n, k, k))
    xp = np.empty((n, k))
    pp = np.empty((n, k, k))
    nis = np.empty(n)
    x, p = x0.copy(), p0.copy()
    for i in range(n):
        if i > 0:
            f = f_of_dt(dts[i])
            x = f @ x
            p = f @ p @ f.T + q_of_dt(dts[i])
        xp[i], pp[i] = x, p
        innov = z[i] - h @ x
        s = h @ p @ h.T + r_cov
        sinv = np.linalg.inv(s)
        nis[i] = float(innov @ sinv @ innov)
        gain = p @ h.T @ sinv
        x = x + gain @ innov
        p = (np.eye(k) - gain @ h) @ p
        xf[i], pf[i] = x, p
    xs = xf.copy()
    ps = pf.copy()
    for i in range(n - 2, -1, -1):
        f = f_of_dt(dts[i + 1])
        c = pf[i] @ f.T @ np.linalg.inv(pp[i + 1])
        xs[i] = xf[i] + c @ (xs[i + 1] - xp[i + 1])
        ps[i] = pf[i] + c @ (ps[i + 1] - pp[i + 1]) @ c.T
    return xs, ps, nis


def smooth_track(log: DetectionLog, track: Track, cfg: RadarConfig,
                 params: KalmanParams | None = None) -> SmoothedTrack:
    """Kalman-smooth one associated track's detections."""
    if params is None:
        params = KalmanParams()
    t_frame = cfg.sig.frame_time
    frames, zr, zv, zel = _merge_per_frame(log, track.member_idx)
    dts = np.empty(len(frames))
    dts[0] = 0.0
    dts[1:] = np.diff(frames) * t_frame

    # range/velocity filter: dR/dt = -V
    def f_rv(dt):
        return np.array([[1.0, -dt], [0.0, 1.0]])

    def q_rv(dt):
        # white-acceleration CV process noise (with the R = -integral(V)
        # sign on the coupling terms)
        q = params.accel_psd
        return q * np.array([[dt**3 / 3.0, -dt**2 / 2.0],
                             [-dt**2 / 2.0, dt]])

    h = np.eye(2)
    r_cov = np.diag([params.sigma_r**2, params.sigma_v**2])
    x0 = np.array([zr[0], zv[0]])
    p0 = np.diag([params.sigma_r**2, params.sigma_v**2])
    xs, ps, nis = _kf_rts(np.stack([zr, zv], 1), dts, f_rv, q_rv, h, r_cov,
                          x0, p0)

    # elevation CV filter
    def f_el(dt):
        return np.array([[1.0, dt], [0.0, 1.0]])

    def q_el(dt):
        q = params.el_rate_psd
        return q * np.array([[dt**3 / 3.0, dt**2 / 2.0],
                             [dt**2 / 2.0, dt]])

    h_el = np.array([[1.0, 0.0]])
    xel, _, _ = _kf_rts(zel[:, None], dts, f_el, q_el, h_el,
                        np.array([[params.sigma_el**2]]),
                        np.array([zel[0], 0.0]),
                        np.diag([params.sigma_el**2, 1.0]))

    return SmoothedTrack(
        track=track, frames=frames,
        range_m=xs[:, 0], velocity_ms=xs[:, 1],
        elevation_deg=xel[:, 0], elevation_rate_dps=xel[:, 1],
        range_std_m=np.sqrt(ps[:, 0, 0]),
        velocity_std_ms=np.sqrt(ps[:, 1, 1]),
        meas_range_m=zr, meas_velocity_ms=zv, meas_elevation_deg=zel,
        innovation_nis=nis)


def smooth_tracks(log: DetectionLog, tracks: list[Track], cfg: RadarConfig,
                  params: KalmanParams | None = None,
                  min_points: int = 3) -> list[SmoothedTrack]:
    """Smooth every track with at least ``min_points`` measured frames
    (shorter tracks carry too little dynamics to estimate)."""
    out = []
    for t in tracks:
        frames = np.unique(log.frame[t.member_idx])
        if len(frames) >= min_points:
            out.append(smooth_track(log, t, cfg, params))
    return out
