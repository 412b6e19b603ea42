"""The port's own spans (``utils/profiling.py::span``) on the CPU: none
entered without a profiler; under one, a frame's stages each once and in
order, flat, every name the port's, one ``rt.cfar`` a trial, and one
``rt.sync`` for each read of a device value on the host."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radar_tpu_torch.cluster import connected
from radar_tpu_torch.config.params import small_test_config
from radar_tpu_torch.pipeline import driver
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.montecarlo import make_trial_fn
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.utils import profiling

CFG = small_test_config()
TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
STAGES = ("rt.synth", "rt.noise", "rt.dbf", "rt.pc", "rt.mtd", "rt.cfar",
          "rt.extract", "rt.estimate", "rt.cluster1", "rt.cluster2")
WORK = ("frame", "trials", "run")


@pytest.fixture(scope="module")
def work():
    """Each kind of work on the CPU, its stages built once: one frame, a
    batch of three trials, a 2-frame ``run_multiframe``."""
    tb = TargetBatch.make(*TARGETS)
    process = make_frame_processor(CFG, device="cpu")
    trials = make_trial_fn(CFG, device="cpu")
    return {
        "frame": lambda: process(11, tb),
        "trials": lambda: trials(tb, [21, 22, 23]),
        "run": lambda: driver.run_multiframe(CFG, tb, 2, seed=31,
                                             processor=process,
                                             device="cpu"),
    }


def _spans(fn) -> list:
    """(name, start, end) of the ranges recorded around ``fn()``, in start
    order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.is_user_annotation),
                  key=lambda x: (x[1], -x[2]))


@pytest.fixture(scope="module")
def traced(work):
    return {k: _spans(fn) for k, fn in work.items()}


@pytest.mark.parametrize("kind", WORK)
def test_no_profiler_enters_no_span(kind, work, monkeypatch):
    def refuse(name):
        raise AssertionError(f"entered {name} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("cfar") is profiling.span("sync")
    work[kind]()


def test_frame_gives_each_stage_once_in_order(traced):
    stages = [n for n, *_ in traced["frame"] if n != "rt.sync"]
    assert tuple(stages) == STAGES


@pytest.mark.parametrize("kind", WORK)
def test_spans_are_flat_and_the_ports(kind, traced):
    """Every range is the port's (``rt.``); none holds another, but each
    ``rt.sync`` lies inside a stage."""
    spans = traced[kind]
    assert spans and all(n.startswith("rt.") for n, *_ in spans)
    stages = [s for s in spans if s[0] != "rt.sync"]
    for (_, s0, e0), (_, s1, _) in zip(stages, stages[1:]):
        assert e0 <= s1
    syncs = [s for s in spans if s[0] == "rt.sync"]
    assert syncs
    for _, s, e in syncs:
        inside = [n for n, a, b in stages if a <= s and e <= b]
        assert len(inside) == 1, (s, e)


def test_trial_batch_gives_one_cfar_span_a_trial(traced):
    names = [n for n, *_ in traced["trials"]]
    assert names.count("rt.cfar") == 3
    assert names.count("rt.synth") == 1
    assert names.count("rt.cluster2") == 3


def test_run_has_log_and_associate_spans(traced):
    names = [n for n, *_ in traced["run"]]
    assert names.count("rt.log") == names.count("rt.cfar") == 2
    assert names[-1] == "rt.associate"


@pytest.mark.parametrize("kind", WORK)
def test_sync_spans_count_the_host_reads(kind, work, monkeypatch):
    """The ``rt.sync`` ranges of a run equal its host reads counted apart:
    the detection log's copies (``driver._host``) and the clusterings'
    convergence checks (``connected._converged``); on the CPU no copy
    goes to a card."""
    reads = [0]

    def counting(fn):
        def wrapped(*a, **k):
            reads[0] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(driver, "_host", counting(driver._host))
    monkeypatch.setattr(connected, "_converged",
                        counting(connected._converged))
    spans = _spans(work[kind])
    assert reads[0] >= (2 if kind == "frame" else 6)
    assert sum(n == "rt.sync" for n, *_ in spans) == reads[0]
