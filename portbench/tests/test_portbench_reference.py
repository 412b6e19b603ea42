"""The plain reference: it imports nothing of the measured program, it
agrees with the port at a small size, its controls are a precision step
lower, and the roofline counts match shapes worked by hand."""

import ast
import glob
import os

import pytest
import torch

from conftest import ROOT

from portbench import roofline
from portbench.reference import chain, consts, detect

SEEDS = (5, 2**40 + 123)


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("radar_tpu_torch",
                                               "radar_tpu", "jax",
                                               "jaxlib"), (path, n)


def _trials(cfg, r, snr, prec="f64"):
    from radar_tpu_torch.pipeline.montecarlo import make_trial_fn
    from radar_tpu_torch.sim.scenario import TargetBatch

    tb = TargetBatch.make([10000.0], [20.0], [10.0], [snr])
    a, h = make_trial_fn(cfg, device="cpu")(tb, list(SEEDS))
    ref = [detect.estimate_and_cluster(r, chain.exact_rdm(r, tuple(tb), s,
                                                          "cpu", prec))
           for s in SEEDS]
    return a.numpy(), h.numpy(), ref


@pytest.mark.parametrize("snr", [-10.0, 20.0])
def test_reference_agrees_with_the_port(snr, small):
    from portbench.harness import radar_config

    tol = 1e-5
    radar = small("exact16")
    r = consts.radar(radar)
    a, h, ref = _trials(radar_config(radar), r, snr)
    for ai, hi, t in zip(a, h, ref):
        assert bool(hi) == (len(t.angle_deg) > 0)
        assert abs(ai - t.angle_deg[0]) < tol


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11, 300.0, -1e-3],
                     dtype=torch.float64)
    t = chain._round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 * 2 ** -10
    assert torch.all((t - x).abs() <= x.abs() * 2 ** -11)


def _run(config, traffic, small, **change):
    from portbench import harness

    conf = dict(harness.load_json("configs", config + ".json"),
                radar=small(config))
    run = harness.Run(cell=f"{config}.{traffic}", config=conf,
                      traffic=dict(harness.load_json("traffic",
                                                     traffic + ".json"),
                                   **change),
                      seed=3, seconds=0.0, trace=False,
                      device=torch.device("cpu"))
    run.cfg = harness.radar_config(conf["radar"])
    return run, harness.load_json("limits", run.cell + ".json")


def test_sweep_control_fails_the_limits(small):
    """The reference a precision step below the configuration's, put in
    the program's place, fails the sweep's limits."""
    from portbench.calibrate import CONTROL
    from portbench.loads import sweep

    run, limits = _run("exact16", "sweep", small)
    trials = [(sweep.trial_seed(9, i, 0), snr) for i, snr in
              ((0, -10.0), (10, 10.0), (20, 30.0))]
    ref = sweep.reference_answers(run, trials)
    ctl = sweep.reference_answers(run, trials, CONTROL[run.config[
        "precision"]])
    got = sweep.compare(ctl, ref)
    assert all(got[k] > limits[k] for k in limits), got


def test_track_control_fails_the_limits(small):
    from portbench.calibrate import CONTROL
    from portbench.loads import track

    run, limits = _run("exact16", "track", small, frames_per_run=3)
    ref_frames, ref_tracks, _ = track.reference_run(run, 11)
    ctl_frames, ctl_tracks, _ = track.reference_run(
        run, 11, CONTROL[run.config["precision"]])
    got = track.compare([tuple(f[:4]) for f in ctl_frames],
                        track.track_rows(ctl_tracks), ref_frames,
                        track.track_rows(ref_tracks), track.cells(run))
    assert all(got[k] > limits[k] for k in limits), got


def test_roofline_counts_by_hand():
    r = consts.radar(__import__("json").load(open(os.path.join(
        ROOT, "portbench", "configs", "exact16.json")))["radar"])
    # narrow 228 gates x 35 taps, medium 723 x 200, long 2453 x 700
    assert [len(s.h) for s in r.segments] == [35, 200, 700]
    per_row = 228 * 35 + 723 * 200 + 2453 * 700
    assert roofline.pc_macs(r) == per_row * 332 * 13
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    ops, which = roofline.pc_bound_s(r, peak, "fp32_flops")
    assert which == "operations"
    assert ops == pytest.approx(8 * per_row * 332 * 13 / 67e12)
    assert ops * 1e3 == pytest.approx(0.9635, abs=1e-3)
    assert roofline.peaks("Tesla V100") is None


def test_kernel_time_needs_the_card():
    with pytest.raises(RuntimeError):
        roofline.time_ms(lambda: None, torch.device("cpu"))


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    """A short window of each cell on the card, run by the benchmark's
    command."""
    import subprocess
    import sys

    from portbench import harness

    for cell in (w["name"] for w in harness.benchmark()["workloads"]):
        p = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", cell,
             "--seed", "424242", "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-2000:]
        out = __import__("json").loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
