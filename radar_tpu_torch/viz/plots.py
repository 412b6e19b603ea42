"""Visualization layer (SURVEY.md L8) — port of ``radar_tpu/viz/plots.py``:
matplotlib equivalents of the reference's figures — PPI/RHI polar track
views, RDM heatmaps, PC/profile debug plots, track-history subplots,
pre/post-clustering comparison, beam patterns, sigma/Pd-vs-SNR curves.

References: main_simulate_echoes_with_array_v8_3.m:354-427 (PPI/RHI/track
history, cluster comparison), _v7_7.m:864-1674 (RDM/PC debug figures),
plot_beam_patterns.m (patterns), main_plot_snr_vs_angle_error.m:293-325
(sweep curves). All functions render to a file (Agg backend) and return the
path.

The functions take the port's types (``pipeline.driver.DetectionLog`` and
``Track``, ``pipeline.tracking.SmoothedTrack``, ``pipeline.montecarlo.
SweepResult``) and tensors on any device where JAX takes arrays. Matplotlib
is imported when a function draws, never when the module is imported: the
card's machine has none, and a call there exits naming it.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend; exits naming matplotlib
    where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"drawing a figure needs matplotlib, which is "
                         f"missing: {e}") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    """A host array of ``x`` (a tensor on any device, or array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save(fig, path: str) -> str:
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_ppi(tracks, path: str, title: str | None = None) -> str:
    """Range-vs-azimuth polar scatter, sized by track points, colored by
    velocity (v8_3:365-369)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="polar")
    if tracks:
        az = np.deg2rad([t.azimuth_deg for t in tracks])
        r = [t.range_m for t in tracks]
        s = [t.num_points * 10 + 20 for t in tracks]
        c = [t.velocity_ms for t in tracks]
        sc = ax.scatter(az, r, s=s, c=c, cmap="viridis")
        fig.colorbar(sc, label="velocity (m/s)")
    ax.set_title(title or f"Final tracks (PPI): {len(tracks)}")
    return _save(fig, path)


def plot_rhi(tracks, path: str) -> str:
    """Range-vs-elevation scatter (v8_3:372-379)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    if tracks:
        r = [t.range_m for t in tracks]
        el = [t.elevation_deg for t in tracks]
        s = [t.num_points * 10 + 20 for t in tracks]
        c = [t.velocity_ms for t in tracks]
        sc = ax.scatter(r, el, s=s, c=c, cmap="viridis")
        fig.colorbar(sc, label="velocity (m/s)")
    ax.set_xlabel("range (m)")
    ax.set_ylabel("elevation (deg)")
    ax.set_title(f"Final tracks (RHI): {len(tracks)}")
    ax.grid(True)
    return _save(fig, path)


def plot_rdm(rdm, range_axis, velocity_axis, path: str,
             truth_ranges=None, db_floor: float = -60.0) -> str:
    """Range-Doppler map heatmap in dB with optional truth-range markers
    (the xline truth overlay idiom, _v7_7.m:984-986)."""
    plt = _pyplot()
    range_axis, velocity_axis = _np(range_axis), _np(velocity_axis)
    mag = np.abs(_np(rdm))
    mag = 20 * np.log10(mag / (mag.max() + 1e-300) + 1e-300)
    fig, ax = plt.subplots(figsize=(9, 5))
    im = ax.imshow(np.maximum(mag, db_floor), aspect="auto", origin="lower",
                   extent=[range_axis[0], range_axis[-1], velocity_axis[0],
                           velocity_axis[-1]], cmap="inferno")
    fig.colorbar(im, label="dB")
    if truth_ranges is not None:
        for r in np.atleast_1d(_np(truth_ranges)):
            ax.axvline(r, color="cyan", ls="--", lw=1)
    ax.set_xlabel("range (m)")
    ax.set_ylabel("velocity (m/s)")
    ax.set_title("Range-Doppler map")
    return _save(fig, path)


def plot_pc_profile(pc_row, range_axis, path: str, truth_ranges=None) -> str:
    """Single-pulse PC magnitude profile with truth markers (debug Fig
    idiom, debug_simulated_data_processing.m:7-14)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    mag = np.abs(_np(pc_row))
    ax.plot(_np(range_axis), 20 * np.log10(mag + 1e-300))
    if truth_ranges is not None:
        for r in np.atleast_1d(_np(truth_ranges)):
            ax.axvline(r, color="r", ls="--", lw=1)
    ax.set_xlabel("range (m)")
    ax.set_ylabel("|PC| (dB)")
    ax.grid(True)
    return _save(fig, path)


def plot_track_history(log, tracks, path: str) -> str:
    """R/El/V vs frame for the longest track (v8_3:381-403)."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    if tracks:
        main = max(tracks, key=lambda t: t.num_points)
        m = _np(main.member_idx)
        frame = _np(log.frame)
        order = np.argsort(frame[m])
        f = frame[m][order]
        for ax, (vals, name, style) in zip(axes, [
                (_np(log.range_m)[m][order], "range (m)", "bo-"),
                (_np(log.elevation_deg)[m][order], "elevation (deg)", "ro-"),
                (_np(log.velocity_ms)[m][order], "velocity (m/s)", "go-")]):
            ax.plot(f, vals, style)
            ax.set_ylabel(name)
            ax.grid(True)
    axes[-1].set_xlabel("frame")
    axes[0].set_title("Main track state vs time")
    return _save(fig, path)


def plot_smoothed_tracks(smoothed, path: str) -> str:
    """Measured points vs Kalman/RTS-smoothed trajectories with a
    +/-2-sigma range band (pipeline/tracking.py; beyond-reference)."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    for st in smoothed:
        f = st.frames
        axes[0].plot(f, st.meas_range_m, "o", ms=4, alpha=0.5)
        line, = axes[0].plot(f, st.range_m, "-")
        axes[0].fill_between(f, st.range_m - 2 * st.range_std_m,
                             st.range_m + 2 * st.range_std_m,
                             color=line.get_color(), alpha=0.15)
        axes[1].plot(f, st.meas_velocity_ms, "o", ms=4, alpha=0.5)
        axes[1].plot(f, st.velocity_ms, "-", color=line.get_color())
        axes[2].plot(f, st.meas_elevation_deg, "o", ms=4, alpha=0.5)
        axes[2].plot(f, st.elevation_deg, "-", color=line.get_color())
    for ax, name in zip(axes, ["range (m)", "velocity (m/s)",
                               "elevation (deg)"]):
        ax.set_ylabel(name)
        ax.grid(True)
    axes[-1].set_xlabel("frame")
    axes[0].set_title("Kalman/RTS-smoothed tracks (dots = measurements)")
    return _save(fig, path)


def plot_cluster_comparison(log, tracks, path: str) -> str:
    """Pre- vs post-association PPI comparison (v8_3:409-427)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 5))
    ax1 = fig.add_subplot(121, projection="polar")
    ax1.scatter(np.deg2rad(_np(log.azimuth_deg)), _np(log.range_m), s=20,
                c="r", alpha=0.5)
    ax1.set_title(f"before association ({len(log)} detections)")
    ax2 = fig.add_subplot(122, projection="polar")
    if tracks:
        az = np.deg2rad([t.azimuth_deg for t in tracks])
        r = [t.range_m for t in tracks]
        s = [t.num_points * 5 + 20 for t in tracks]
        ax2.scatter(az, r, s=s, c="b")
    ax2.set_title(f"after association ({len(tracks)} tracks)")
    return _save(fig, path)


def plot_beam_patterns_fig(dbf_w, element_spacing, wavelength, path: str,
                           scan_deg=None) -> str:
    """All beams' patterns in dB with peak markers (plot_beam_patterns.m
    :42-95)."""
    from ..doa.calibrate import beam_patterns

    plt = _pyplot()
    scan, resp, peaks = beam_patterns(_np(dbf_w), element_spacing,
                                      wavelength, scan_deg)
    fig, ax = plt.subplots(figsize=(10, 5))
    for b in range(resp.shape[0]):
        db = 20 * np.log10(resp[b] / resp[b].max() + 1e-300)
        ax.plot(scan, db, lw=1)
        ax.axvline(peaks[b], color="gray", ls=":", lw=0.5)
    ax.set_ylim(-50, 2)
    ax.set_xlabel("elevation (deg)")
    ax.set_ylabel("normalized gain (dB)")
    ax.set_title(f"{resp.shape[0]}-beam DBF patterns "
                 f"(peaks: {np.round(peaks, 1)})")
    ax.grid(True)
    return _save(fig, path)


def plot_snr_sweep(sweep, path: str) -> str:
    """Angle-error sigma vs SNR with the analytic bound, and Pd vs SNR
    (main_plot_snr_vs_angle_error.m:293-325)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.plot(sweep.snr_db, sweep.angle_error_std, "bo-",
             label="simulated sigma")
    ax1.plot(sweep.snr_db, sweep.theory_bound, "r--",
             label="|k|*sqrt(2)/sqrt(SNR)")
    ax1.set_xlabel("SNR (dB)")
    ax1.set_ylabel("angle error std (deg)")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(sweep.snr_db, np.asarray(sweep.detection_probability) * 100,
             "ms-")
    ax2.set_xlabel("SNR (dB)")
    ax2.set_ylabel("Pd (%)")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    return _save(fig, path)
