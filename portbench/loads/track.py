"""Multi-frame runs with tracking, back to back in one process.

The system's default entry point (the v8_3 driver, the port's
``scripts/run_simulation.py``): runs of ``pipeline/driver.py::
run_multiframe`` over the mix file's scene, each with the frame processor
built once in set-up, wrapped by a timer. A frame's latency runs from one
processor call to the next; a run's last frame ends at
``run_multiframe``'s return, so it carries the association. Run ``j`` of
the window takes seed ``run_seed(seed, j)``; the warm-up run a seed no
window takes.

Judged: one of the window's runs, drawn from the seed. The reference moves
the scene (``reference/track.py``), forms every frame's map from its seed
(``reference/chain.py``), finds its targets (``reference/detect.py``) and
associates the log; the numbers are the median and the 90th percentile
of the angle gaps and of the relative power gaps over every target of
every frame, slot by slot, and every track. A target that lies in another
range or Doppler cell than the reference's, each target of a frame whose
target count differs, and each track where the tracks partition the log
otherwise count as mismatches.
"""

from __future__ import annotations

import time

import numpy as np

WARM_RUN = 0xFFFFF
MISMATCH = (180.0, 1.0)   # the gaps (deg, relative power) of a mismatch


def run_seed(seed: int, j: int) -> int:
    """The seed of run ``j`` of a window of seed ``seed``."""
    return (int(seed) * 0x9E3779B1 + j * 0x85EBCA77 + 1) & 0xFFFFFFFF


def scene(traffic: dict) -> tuple:
    t = traffic["targets"]
    f = lambda k: np.asarray(t[k], np.float64)
    return f("range_m"), f("velocity_ms"), f("elevation_deg"), f("snr_db")


def _run(run, seed: int, frames: int):
    """One run_multiframe: (log, tracks, the processor's call times, the
    return time)."""
    from radar_tpu_torch.pipeline.driver import run_multiframe
    from radar_tpu_torch.sim.scenario import TargetBatch
    from torch.profiler import record_function

    calls = []
    process = run.state["process"]

    def timed(frame_seed, targets):
        calls.append(time.perf_counter())
        with record_function("pb.frame"):
            return process(frame_seed, targets)

    log, tracks, _ = run_multiframe(run.cfg, TargetBatch(*scene(run.traffic)),
                                    frames, seed=seed, processor=timed,
                                    device=run.device)
    return log, tracks, calls, time.perf_counter()


def setup(run) -> None:
    from radar_tpu_torch.pipeline.frame import make_frame_processor

    run.state["process"] = make_frame_processor(run.cfg, device=run.device)
    # the processor, the host log and the native associator, once
    _run(run, run_seed(run.seed, WARM_RUN), run.traffic["warm_frames"])


def _counted_syncs(run, seed, frames):
    """A run with ``torch.cuda.set_sync_debug_mode`` counting the host's
    synchronisations (CUDA only)."""
    import warnings

    import torch

    if run.device.type != "cuda":
        return _run(run, seed, frames), 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = _run(run, seed, frames)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def window(run) -> dict:
    """Back-to-back runs until the deadline; frames a second over all the
    window's frames and time, and the 95th percentile of the frames'
    latencies. A traced run profiles ``trace_runs`` runs after the first
    ``trace_after_runs`` (or at the deadline), then counts the host syncs
    of one more run, outside the profile."""
    import torch

    frames = run.traffic["frames_per_run"]
    runs, lat = [], []
    traced = not run.trace
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    deadline = start + run.seconds
    while True:
        j = len(runs)
        if not traced and (j >= run.traffic["trace_after_runs"]
                           or time.perf_counter() >= deadline):
            traced = True
            with run.traced():
                for _ in range(run.traffic["trace_runs"]):
                    runs.append(_run(run, run_seed(run.seed, len(runs)),
                                     frames))
            out, syncs = _counted_syncs(run, run_seed(run.seed, len(runs)),
                                        frames)
            runs.append(out)
            run.counters["host_syncs"] = syncs
            run.counters["sync_frames"] = frames
            end = out[3]
        else:
            out = _run(run, run_seed(run.seed, j), frames)
            runs.append(out)
            calls, end = out[2], out[3]
            lat += list(np.diff(calls + [end]) * 1e3)
        if end >= deadline and traced:
            break
    run.state["runs"] = [(log, tracks) for log, tracks, *_ in runs]
    run.state["frame_ms"] = lat
    run.counters["attempted"] = frames * len(runs)
    run.counters["failed"] = 0
    return {"frames_per_s": frames * len(runs) / (end - start),
            "frame_ms_p95": float(np.percentile(lat, 95))}


def release(run) -> None:
    run.state.pop("process", None)


def reference_run(run, seed: int, prec: str = "f64"):
    """(per-frame Targets, tracks, azimuths) of one run by the reference."""
    from portbench.reference import chain, consts, detect, track

    if run.config["radar"]["fused_synth_dbf"]:
        raise NotImplementedError("the track reference runs the exact "
                                  "stream")
    r = consts.radar(run.config["radar"])
    frames, az = [], []
    for f, (targets, azimuth) in enumerate(
            track.scene(r, scene(run.traffic),
                        run.traffic["frames_per_run"]), start=1):
        rdm = chain.exact_rdm(r, targets, track.frame_seed(seed, f),
                              run.device, prec)
        frames.append(detect.estimate_and_cluster(r, rdm))
        az.append(azimuth)
        del rdm
    return frames, track.associate(r, frames, az), az


def log_frames(log, num_frames: int) -> list:
    """(ranges, velocities, angles, powers) of each frame of a program
    run's detection log."""
    return [tuple(getattr(log, k)[log.frame == f] for k in
                  ("range_m", "velocity_ms", "elevation_deg", "power"))
            for f in range(1, num_frames + 1)]


def track_rows(tracks) -> list:
    """(first frame, last frame, rows, elevation, power) of each track,
    in order: the program's tracks or the reference's."""
    return [(t.first_frame, t.last_frame, t.num_points, t.elevation_deg,
             t.power) if hasattr(t, "num_points") else
            (min(t.frames), max(t.frames), len(t.frames), t.elevation_deg,
             t.power) for t in tracks]


def cells(run) -> tuple:
    """(range cell m, Doppler cell m/s) of the run's configuration."""
    from portbench.reference import consts

    r = consts.radar(run.config["radar"])
    return r.delta_r, r.delta_v


def compare(frames, tracks, ref_frames, ref_tracks, cell: tuple) -> dict:
    """The numbers judged between one side's frames (``log_frames``) and
    tracks (``track_rows``) and the reference's: the median and the 90th
    percentile (``harness.gap_numbers``) of the angle gaps and of the
    relative power gaps over every target of every frame, slot by slot,
    and every track (its winning row's elevation and power). A target
    whose range or velocity lies half a cell (``cell``: range m, Doppler
    m/s) or more from the reference's, each target of a frame whose target
    count differs, and each track where the partitions differ, counts as a
    gap of ``MISMATCH``. (The largest gap is no number to judge: a cell on
    the CFAR's threshold that float32 and float64 put on two sides of it
    moves one cluster as far as the float32 program's whole error; see
    PERF.md.)"""
    from portbench.harness import gap_numbers

    ang, pw = [], []

    def mismatch(n):
        ang.extend([MISMATCH[0]] * n)
        pw.extend([MISMATCH[1]] * n)

    for prog, ref in zip(frames, ref_frames):
        if len(prog[0]) != len(ref.range_m):
            mismatch(max(len(prog[0]), len(ref.range_m)))
            continue
        off = ((np.abs(prog[0] - ref.range_m) >= cell[0] / 2)
               | (np.abs(prog[1] - ref.velocity_ms) >= cell[1] / 2))
        mismatch(int(off.sum()))
        ang.extend(np.abs(prog[2] - ref.angle_deg)[~off])
        pw.extend((np.abs(prog[3] - ref.power) / ref.power)[~off])
    if [t[:3] for t in tracks] != [t[:3] for t in ref_tracks]:
        mismatch(max(len(tracks), len(ref_tracks)))
    else:
        for t, rt in zip(tracks, ref_tracks):
            ang.append(abs(t[3] - rt[3]))
            pw.append(abs(t[4] - rt[4]) / rt[4])
    return {**gap_numbers("angle_gap_deg", ang),
            **gap_numbers("power_gap_rel", pw)}


def check(run, limits: dict) -> dict:
    rng = np.random.default_rng(int(run.seed) & 0xFFFFFFFFFFFFFFFF)
    j = int(rng.integers(len(run.state["runs"])))
    log, tracks = run.state["runs"][j]
    ref_frames, ref_tracks, _ = reference_run(run, run_seed(run.seed, j))
    got = compare(log_frames(log, len(ref_frames)), track_rows(tracks),
                  ref_frames, track_rows(ref_tracks), cells(run))
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
