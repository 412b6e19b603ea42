"""Each cell's traffic through a short window on the CPU (the port's plain
paths, a small radar), its result line, and faults planted in the timed
path that the comparison has to catch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

from portbench import harness, run as prun
from portbench.loads import sweep, track

CELLS = {"exact16.sweep": "exact16", "exact16.track": "exact16"}
SMALL_TRAFFIC = {"sweep": {"batch": 4, "trials_per_point": 8,
                           "check_trials": 3, "trace_after_batches": 1,
                           "trace_batches": 1},
                 "track": {"frames_per_run": 3, "warm_frames": 2,
                           "trace_after_runs": 1, "trace_runs": 1}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def execute(cell, small, *, trace=0, seed=2**33 + 5, seconds=0.5):
    kind = "track" if cell.endswith("track") else "sweep"
    args = prun.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    return prun.execute(args, time.time(), device=torch.device("cpu"),
                        radar=small(CELLS[cell]),
                        traffic=SMALL_TRAFFIC[kind])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_and_reports(cell, small):
    out = execute(cell, small)
    assert list(out)[:5] == KEYS and list(out)[-1] == "compared"
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = harness.benchmark()
    want = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    # a CPU run reports no device numbers
    assert out["device"]["platform"] == "cpu"
    assert "busy_s" not in out["device"]
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cpu_run_reports_no_device_metric(cell, small):
    out = execute(cell, small, trace=1)
    assert out["correct"] is True
    device_metrics = {m["name"] for m in harness.benchmark()["per_layer"]
                      if m["source"] == "device_trace"}
    assert not device_metrics & set(out["metrics"])
    assert "breakdown" not in out


@pytest.fixture(scope="module")
def memo():
    """The unbroken trial function's answers by (SNR, seeds) and the
    reference's by (seed, SNR): each fault test drives its own window
    over the same trials, so each side works a trial once a module."""
    return {}, {}


class _Clock:
    """A clock that moves one second a reading: a window of ``--seconds``
    s runs a fixed number of batches, whatever the CPU's speed."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _wrap_trials(monkeypatch, fault, memo):
    answers, reference = memo
    real = sweep.setup

    def setup(run):
        real(run)
        fn = run.state["trials"]

        def trials(targets, seeds):
            key = (float(targets.snr_db[0]), tuple(seeds))
            if key not in answers:
                answers[key] = fn(targets, seeds)
            return fault(*(x.clone() for x in answers[key]))
        run.state["trials"] = trials
    monkeypatch.setattr(sweep, "setup", setup)
    real_ref = sweep.reference_answers

    def reference_answers(run, trials, prec="f64"):
        todo = [t for t in trials if (t[0], t[1]) not in reference]
        for t, a in zip(todo, real_ref(run, todo, prec)):
            reference[(t[0], t[1])] = a
        return [reference[(t[0], t[1])] for t in trials]
    monkeypatch.setattr(sweep, "reference_answers", reference_answers)
    monkeypatch.setattr(sweep, "time", _Clock())


def _sound(angles, hits):
    return angles, hits


def _alter_answer(angles, hits):
    """Every answer altered where the trial function produces it."""
    return angles + 0.5, hits


def _drop_half(angles, hits):
    """Half the batch left out: those trials report nothing."""
    n = len(angles) // 2
    angles[n:], hits[n:] = float("nan"), False
    return angles, hits


def _drop_quarter(angles, hits):
    """A quarter of each batch left out."""
    n = len(angles) - len(angles) // 4
    angles[n:], hits[n:] = float("nan"), False
    return angles, hits


def _wrong_slot(angles, hits):
    """Each trial answered with its neighbour's answer."""
    return angles.roll(1), hits.roll(1)


@pytest.mark.parametrize("fault", [_sound, _alter_answer, _drop_half,
                                   _drop_quarter, _wrong_slot])
def test_sweep_fault_makes_run_incorrect(fault, small, monkeypatch, memo):
    """Each fault planted where the trial function answers is caught by
    the cell's own sample (``check_trials`` of the mix file, drawn from
    the seed out of a window of twice as many trials)."""
    _wrap_trials(monkeypatch, fault, memo)
    cell = harness.load_json("traffic", "sweep.json")
    # six batches of the cell's 16 at a second a clock reading
    traffic = dict(SMALL_TRAFFIC["sweep"], batch=cell["batch"],
                   trials_per_point=cell["trials_per_point"],
                   check_trials=cell["check_trials"])
    args = prun.parse(["--workload", "exact16.sweep", "--seed",
                       str(2**33 + 17), "--seconds", "17", "--trace", "0"])
    out = prun.execute(args, time.time(), device=torch.device("cpu"),
                       radar=small("exact16"), traffic=traffic)
    assert out["attempted"] == 96
    assert out["correct"] is (fault is _sound), out["compared"]


def _wrap_frames(monkeypatch, fault):
    real = track.setup

    def setup(run):
        real(run)
        process = run.state["process"]
        calls = []

        def broken(frame_seed, targets):
            calls.append(frame_seed)
            res = process(frame_seed, targets)
            return res._replace(targets=fault(res.targets, len(calls),
                                              run))
        run.state["process"] = broken
    monkeypatch.setattr(track, "setup", setup)


def _alter_angle(t, call, run):
    """Every target's angle altered where the frame processor makes it."""
    return t._replace(angle_deg=torch.where(t.valid, t.angle_deg + 0.5,
                                            t.angle_deg))


def _drop_half_frames(t, call, run):
    """Every other frame's targets left out."""
    return t._replace(valid=t.valid & (call % 2 == 0))


def _range_off_a_gate(t, call, run):
    """Every range one range cell out."""
    return t._replace(range_m=t.range_m + track.cells(run)[0])


def _velocity_off_a_cell(t, call, run):
    """Every velocity one Doppler cell out: a wrong velocity axis."""
    return t._replace(velocity_ms=t.velocity_ms + track.cells(run)[1])


@pytest.mark.parametrize("fault", [_alter_angle, _drop_half_frames,
                                   _range_off_a_gate, _velocity_off_a_cell])
def test_track_fault_makes_run_incorrect(fault, small, monkeypatch):
    _wrap_frames(monkeypatch, fault)
    args = prun.parse(["--workload", "exact16.track", "--seed",
                       str(2**33 + 5), "--seconds", "0.5", "--trace", "0"])
    out = prun.execute(args, time.time(), device=torch.device("cpu"),
                       radar=small("exact16"),
                       traffic=dict(SMALL_TRAFFIC["track"],
                                    frames_per_run=6))
    assert out["correct"] is False
    assert out["compared"]["angle_gap_p90_deg"]["value"] > 0.4


def test_no_card_exits_nonzero_without_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "exact16.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_only_benchmark_files_exit_nonzero(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "exact16.track", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_import_guard_names_whole_top_level_modules(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "radar_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "radar_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "radar_tpu.ops"]


def test_run_loads_no_jax(small):
    execute("exact16.track", small)
    assert harness.forbidden_modules() == []


def test_seeds_are_the_ports():
    from radar_tpu_torch.pipeline.driver import frame_seed, trial_seed
    from portbench.reference.track import frame_seed as ref_frame_seed

    for s in (0, 7, 2**31 + 3, 2**40 + 11):
        assert sweep.trial_seed(s, 20, 99) == trial_seed(s, 20, 99)
        assert ref_frame_seed(s, 50) == frame_seed(s, 50)
    assert len({track.run_seed(5, j) for j in range(1000)}) == 1000
