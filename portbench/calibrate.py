"""The readings the comparison's limits are set from, on the card.

    python3 -m portbench.calibrate --workload exact16.sweep \\
        --seeds 101,102,... --out build/calib.jsonl

For each seed, the cell's judged answers as a run of that seed draws them
(sweep: ``check_trials`` trials drawn from the schedule's first pass;
track: one whole run) are made by the program's timed entry (the trial
function, or ``run_multiframe`` with the frame processor), by the plain
reference, and by the control: the reference a precision step below the
configuration's (float32 -> TF32), put in the program's place. Each
seed's line holds the numbers the comparison takes for the program and
for the control, against the reference, and the track's readings that it
does not judge (range and velocity gaps, mismatches). The program is set
up once; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import run as prun  # noqa: E402

CONTROL = {"float32": "tf32"}


def _sweep(run, load, seed: int) -> dict:
    import torch
    from radar_tpu_torch.sim.scenario import TargetBatch

    pts = load.snr_points(run.traffic)
    n = run.traffic["trials_per_point"]
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(pts) * n, run.traffic["check_trials"],
                              replace=False))
    trials = []
    for k in picks:
        i, t = divmod(int(k), n)
        s = load.trial_seed(seed, i, t)
        a, h = run.state["trials"](TargetBatch(*load.truth(run.traffic,
                                                           float(pts[i]))),
                                   [s])
        trials.append((s, float(pts[i]), float(a[0].cpu()), bool(h[0].cpu())))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = load.reference_answers(run, trials)
    t_ref = time.perf_counter() - t0
    ctl = load.reference_answers(run, trials,
                                 CONTROL[run.config["precision"]])
    prog = [(a, h) for *_, a, h in trials]
    return {"program": load.compare(prog, ref),
            "control": load.compare(ctl, ref), "reference_s": t_ref,
            "trials": [[s, snr, a, h, ra, rh, ca, ch] for (s, snr, a, h),
                       (ra, rh), (ca, ch) in zip(trials, ref, ctl)]}


def _track(run, load, seed: int) -> dict:
    from radar_tpu_torch.pipeline.driver import frame_seed
    from radar_tpu_torch.sim.scenario import Scenario, TargetBatch

    rs = load.run_seed(seed, 0)
    n = run.traffic["frames_per_run"]
    log, tracks, *_ = load._run(run, rs, n)
    # each frame's raw detections, by the processor alone
    scen = Scenario.from_initial(TargetBatch(*load.scene(run.traffic)),
                                 run.cfg)
    raw = [int(run.state["process"](frame_seed(rs, f),
                                    scen.step(run.cfg)).num_raw_detections)
           for f in range(1, n + 1)]
    t0 = time.perf_counter()
    ref_frames, ref_tracks, _ = load.reference_run(run, rs)
    t_ref = time.perf_counter() - t0
    ctl_frames, ctl_tracks, _ = load.reference_run(
        run, rs, CONTROL[run.config["precision"]])
    ref_rows = load.track_rows(ref_tracks)
    prog = load.log_frames(log, n)
    ctl = [tuple(f[:4]) for f in ctl_frames]
    cell = load.cells(run)
    per_frame = [[f + 1, raw[f], ref_frames[f].num_raw,
                  ctl_frames[f].num_raw,
                  load.compare([prog[f]], [], [ref_frames[f]], [], cell),
                  load.compare([ctl[f]], [], [ref_frames[f]], [], cell)]
                 for f in range(n)]
    sides = {"program": (prog, load.track_rows(tracks)),
             "control": (ctl, load.track_rows(ctl_tracks))}
    return {**{k: load.compare(f, t, ref_frames, ref_rows, cell)
               for k, (f, t) in sides.items()},
            "unjudged": {k: _unjudged(f, t, ref_frames, ref_rows, cell)
                         for k, (f, t) in sides.items()},
            "reference_s": t_ref, "frames": per_frame}


def _unjudged(frames, tracks, ref_frames, ref_rows, cell) -> dict:
    """A track side's readings that no limit holds: the median and widest
    range and velocity gaps over the targets of frames whose counts agree,
    frames whose counts differ, targets in another cell, whether the
    tracks partition the log otherwise."""
    dr, dv, counts, off = [], [], 0, 0
    for prog, ref in zip(frames, ref_frames):
        if len(prog[0]) != len(ref.range_m):
            counts += 1
            continue
        r = np.abs(np.asarray(prog[0]) - ref.range_m)
        v = np.abs(np.asarray(prog[1]) - ref.velocity_ms)
        off += int(((r >= cell[0] / 2) | (v >= cell[1] / 2)).sum())
        dr.extend(r)
        dv.extend(v)
    stat = lambda x: [float(np.median(x)), float(np.max(x))] if x else None
    return {"range_m": stat(dr), "velocity_ms": stat(dv),
            "count_frames": counts, "off_cell": off,
            "tracks_differ": [t[:3] for t in tracks]
            != [t[:3] for t in ref_rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    args = prun.parse(["--workload", a.workload, "--seed", "0",
                       "--seconds", "0", "--trace", "0"])
    _, _, run, load, _ = prun.prepare(args)
    load.setup(run)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    for seed in (int(s) for s in a.seeds.split(",")):
        run.seed = seed
        line = {"cell": a.workload, "seed": seed,
                **(_track if run.traffic["kind"] == "track" else _sweep)(
                    run, load, seed)}
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: line[k] for k in ("cell", "seed", "program",
                                                 "control", "unjudged",
                                                 "reference_s")
                          if k in line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
