"""The Monte-Carlo SNR sweep, a closed loop in one process.

The reference's study (``main_plot_snr_vs_angle_error.m``) as the port's
``snr_sweep`` schedules it: the SNR points in order, wrapping, each point's
trials in batches through ``pipeline/montecarlo.py::make_trial_fn``, each
batch's angles and hits copied to the host before the next starts. The
mix file gives the points, the trials a point, the batch, the truth target
and how many of the window's trials the reference judges.

Trial seeds: trial ``t`` of point ``i`` in pass ``k`` over the points
takes ``trial_seed(seed, k * points + i, t)``; the warm-up takes point
4095, which no window reaches.

Judged: ``check_trials`` of the window's trials drawn from the seed. The
reference forms each one's map anew from its seed (``reference/chain.py``),
finds its targets (``reference/detect.py``) and its first target's angle;
the numbers are the median and the 90th percentile of the angle gaps over
the judged trials, a trial that one side alone detects counting as
``MISMATCH_DEG``.
"""

from __future__ import annotations

import time

import numpy as np

WARM_POINT = 4095
MISMATCH_DEG = 180.0      # the gap of a trial one side alone detects


def trial_seed(seed: int, point: int, trial: int) -> int:
    """(seed mod 2^32) * 2^32 + point * 2^20 + trial, as the port keys a
    sweep's trials."""
    if not (0 <= point < 1 << 12 and 0 <= trial < 1 << 20):
        raise ValueError(f"no trial seed for ({point}, {trial})")
    return ((int(seed) & 0xFFFFFFFF) << 32) | (point << 20) | trial


def snr_points(traffic: dict) -> np.ndarray:
    s = traffic["snr_db"]
    return np.arange(s["start"], s["stop"] + 1e-9, s["step"])


def schedule(traffic: dict):
    """Endless (point, first trial, batch size, SNR dB): point ``k * points
    + i`` in pass ``k``."""
    pts = snr_points(traffic)
    n, b = traffic["trials_per_point"], traffic["batch"]
    k = 0
    while True:
        for i, snr in enumerate(pts):
            for t0 in range(0, n, b):
                yield k * len(pts) + i, t0, min(b, n - t0), float(snr)
        k += 1


def truth(traffic: dict, snr: float) -> tuple:
    """(ranges, velocities, elevations, SNRs) of the truth at ``snr``."""
    t = traffic["truth"]
    f = lambda x: np.asarray(x, np.float64)
    return (f(t["range_m"]), f(t["velocity_ms"]), f(t["elevation_deg"]),
            np.full(len(t["range_m"]), snr))


def _batch(run, point, t0, nb, snr):
    """One batch through the trial function: its seeds, its host answers
    and the host clock of its call and of its copy."""
    from radar_tpu_torch.sim.scenario import TargetBatch
    from torch.profiler import record_function

    seeds = [trial_seed(run.seed, point, t0 + t) for t in range(nb)]
    tb = TargetBatch(*truth(run.traffic, snr))
    a = time.perf_counter()
    with record_function("pb.batch"):
        angles, hits = run.state["trials"](tb, seeds)
    b = time.perf_counter()
    with record_function("pb.to_host"):
        angles = angles.cpu().numpy().astype(np.float64)
        hits = hits.cpu().numpy().astype(bool)
    c = time.perf_counter()
    return (seeds, snr, angles, hits), b - a, c


def setup(run) -> None:
    from radar_tpu_torch.pipeline.montecarlo import make_trial_fn

    run.state["trials"] = make_trial_fn(run.cfg, device=run.device)
    sizes = sorted({nb for *_, nb, _ in _one_pass(run.traffic)})
    snr = float(snr_points(run.traffic)[0])
    for nb in sizes:
        _batch(run, WARM_POINT, 0, nb, snr)


def _one_pass(traffic):
    pts = len(snr_points(traffic))
    out = []
    for item in schedule(traffic):
        if item[0] >= pts:
            return out
        out.append(item)


def window(run) -> dict:
    """The measured loop; its rate over all the window's trials and time.
    A traced run profiles ``trace_batches`` batches after the first
    ``trace_after_batches`` (or at the deadline, if that comes first)."""
    import torch

    sched = schedule(run.traffic)
    records = []
    traced = not run.trace
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    deadline = start + run.seconds
    while True:
        if not traced and (len(records) >= run.traffic["trace_after_batches"]
                           or time.perf_counter() >= deadline):
            traced = True
            with run.traced():
                for _ in range(run.traffic["trace_batches"]):
                    rec, _, end = _batch(run, *next(sched))
                    records.append(rec)
        else:
            rec, enq, end = _batch(run, *next(sched))
            records.append(rec)
            run.span("enqueue", enq, len(rec[0]))
        if end >= deadline and traced:
            break
    run.state["records"] = records
    run.counters["attempted"] = sum(len(r[0]) for r in records)
    run.counters["failed"] = 0
    return {"trials_per_s": run.counters["attempted"] / (end - start)}


def release(run) -> None:
    run.state.pop("trials", None)


def sample(run) -> list:
    """(seed, snr, angle, hit) of the judged trials, drawn from the seed."""
    flat = [(s, snr, a, h) for seeds, snr, angles, hits in
            run.state["records"]
            for s, a, h in zip(seeds, angles, hits)]
    rng = np.random.default_rng(int(run.seed) & 0xFFFFFFFFFFFFFFFF)
    n = min(run.traffic["check_trials"], len(flat))
    return [flat[i] for i in sorted(rng.choice(len(flat), n,
                                               replace=False))]


def reference_answers(run, trials, prec: str = "f64") -> list:
    """(angle, hit) of each (seed, snr) by the plain reference."""
    from portbench.reference import chain, consts, detect

    r = consts.radar(run.config["radar"])
    if run.config["radar"]["lowrank_rdm"]:
        raise NotImplementedError("the sweep reference runs the exact "
                                  "stream")
    out = []
    for seed, snr, *_ in trials:
        rdm = chain.exact_rdm(r, truth(run.traffic, snr), seed, run.device,
                              prec)
        t = detect.estimate_and_cluster(r, rdm)
        del rdm
        hit = len(t.angle_deg) > 0
        out.append((float(t.angle_deg[0]) if hit else float("nan"), hit))
    return out


def compare(program: list, reference: list) -> dict:
    """The numbers judged over the judged trials' angle gaps: their median
    and 90th percentile (``harness.gap_numbers``), a trial that one side
    alone detects counting as ``MISMATCH_DEG`` and one that neither
    detects left out. A fault in a tenth of the trials or more, a slot
    answered wrong, a detection lost or half a batch left out, reads
    ``MISMATCH_DEG`` or an angle apart in the 90th percentile."""
    from portbench.harness import gap_numbers

    gaps = []
    for (a, h), (ra, rh) in zip(program, reference):
        if h and rh:
            gaps.append(abs(float(a) - ra))
        elif bool(h) != bool(rh):
            gaps.append(MISMATCH_DEG)
    return gap_numbers("angle_gap_deg", gaps)


def check(run, limits: dict) -> dict:
    trials = sample(run)
    got = compare([(a, h) for *_, a, h in trials],
                  reference_answers(run, trials))
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
