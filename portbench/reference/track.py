"""The multi-frame run: the scene's motion, the seeds of its frames, and
the 5D association of its detection log into tracks.

After the upstream v8_3 driver (``main_simulate_echoes_with_array_v8_3.m
:100-117, 194-335``): each target flies level at constant ground speed
(altitude H = R0 sin El0, ground speed V0 / cos El0; per frame the ground
range falls by the ground speed times the frame time and slant range,
elevation and radial velocity follow); the servo azimuth advances rpm * 6
degrees a second, mod 360, before each frame. Log rows associate into
tracks by the closure of (range, velocity, azimuth, elevation, frame)
gates, components in the order of their first row, each merged
winner-take-all by power but for the power-weighted mean azimuth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .consts import Radar
from .detect import Targets, _adjacent, _components


def frame_seed(seed: int, frame: int) -> int:
    """The integer seed of frame ``frame`` (1-based) of a run with
    ``seed``: (seed mod 2^32) * 2^32 + frame."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(frame) & 0xFFFFFFFF)


def scene(r: Radar, initial, num_frames: int):
    """[(targets, azimuth_deg)] of frames 1 .. num_frames."""
    sig, scan = r.conf["sig"], r.conf["scan"]
    t_frame = sig["prt_num"] * sig["prt"]
    deg_per_frame = scan["rpm"] * 6.0 * t_frame
    rng, vel, el, snr = (np.asarray(f, np.float64) for f in initial)
    el0 = np.deg2rad(el)
    h, vg, rg = rng * np.sin(el0), vel / np.cos(el0), rng * np.cos(el0)
    az = scan["start_azimuth_deg"]
    out = []
    for _ in range(num_frames):
        az = float(np.mod(az + deg_per_frame, 360.0))
        rg = rg - vg * t_frame
        r_slant = np.sqrt(rg ** 2 + h ** 2)
        e = np.rad2deg(np.arcsin(h / r_slant))
        out.append(((r_slant, vg * np.cos(np.deg2rad(e)), e, snr), az))
    return out


class Track(NamedTuple):
    range_m: float
    velocity_ms: float
    elevation_deg: float
    azimuth_deg: float
    power: float
    frames: tuple          # the frames of its rows, in log order


def associate(r: Radar, frames: list[Targets], azimuths) -> list[Track]:
    """Tracks of the log of ``frames`` (frame i + 1 seen at
    ``azimuths[i]``)."""
    rows = [(t, i + 1, azimuths[i]) for i, f in enumerate(frames)
            for t in zip(f.range_m, f.velocity_ms, f.angle_deg, f.power)]
    if not rows:
        return []
    rng, vel, el, pw = np.array([x[0] for x in rows]).T
    frame = np.array([x[1] for x in rows])
    az = np.array([x[2] for x in rows], np.float64)
    ifc, cl = r.conf["inter_frame"], r.conf["cluster"]
    if ifc.get("wrap_azimuth"):
        raise NotImplementedError("the reference gates the plain azimuth")
    k = ifc["k"]
    lab = _components(_adjacent([
        (rng, cl["max_range_sep"] * k), (vel, cl["max_vel_sep"] * k),
        (az, ifc["gate_az_deg"]), (el, cl["max_angle_sep"] * k),
        (frame.astype(np.float64), float(ifc["max_frame_gap"]))]))
    tracks = []
    for i in np.nonzero(lab == np.arange(len(lab)))[0]:
        m = np.nonzero(lab == i)[0]
        w = m[np.argmax(pw[m])]
        tracks.append(Track(rng[w], vel[w], el[w],
                            float((az[m] * pw[m]).sum() / pw[m].sum()),
                            pw[w], tuple(int(f) for f in frame[m])))
    return tracks
