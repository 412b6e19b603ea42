"""The frame-tail readers (``portbench/spans.py`` and its four metrics) on
hand-made traces whose numbers are worked out by hand, on a trace without
the program's spans, and in a traced CPU run of each cell."""

import pytest
import torch

from portbench import harness, spans
from test_portbench_runs import CELLS, execute

TAIL_METRICS = ("tail_idle_share.sweep", "tail_idle_share.track",
                "syncs_per_trial", "tail_host_ms_per_trial")

# a window of 100 us: the card busy over [0, 10], [30, 40] and [60, 100],
# so idle over [10, 30] and [40, 60] (40 us); two trials (two rt.cfar),
# the tail's union [5, 15] + [20, 35] + [45, 55] (35 us), of which idle
# [10, 15] + [20, 30] + [45, 55] (25 us); two syncs, [25, 28] inside
# rt.cluster1 and [2, 3] inside rt.synth, outside the tail
EVENTS = [
    ("cpu", "pb.traced", 0.0, 100.0),
    ("device", "gemm", 0.0, 10.0),
    ("device", "gemm", 30.0, 40.0),
    ("device", "cfar", 60.0, 100.0),
    ("cpu", "rt.synth", 0.0, 5.0),
    ("cpu", "rt.sync", 2.0, 3.0),
    ("cpu", "rt.cfar", 5.0, 15.0),
    ("cpu", "aten::where", 16.0, 18.0),
    ("cpu", "rt.cluster1", 20.0, 35.0),
    ("cpu", "rt.sync", 25.0, 28.0),
    ("cpu", "rt.pc", 38.0, 45.0),
    ("cpu", "rt.cfar", 45.0, 50.0),
    ("cpu", "rt.extract", 50.0, 55.0),
    ("cpu", "rt.cfar", 120.0, 130.0),      # after the window
    ("cpu", "rt.sync", 121.0, 122.0),
]


def _run(events, device="cuda"):
    run = harness.Run(cell="exact16.sweep", config={}, traffic={}, seed=1,
                      seconds=1.0, trace=True, device=torch.device(device))
    run.trace_events = events
    run.trace_window_us = (0.0, 100.0)
    return run


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_readers_on_a_hand_made_trace():
    run = _run(EVENTS)
    for name in ("tail_idle_share.sweep", "tail_idle_share.track"):
        assert _read(name, run) == pytest.approx(100.0 * 25.0 / 40.0)
    assert _read("syncs_per_trial", run) == pytest.approx(2 / 2)
    assert _read("tail_host_ms_per_trial", run) == pytest.approx(
        (35.0 - 3.0) / 1e3 / 2)


def test_interval_helpers():
    u = spans.union([(5, 15), (0, 2), (10, 20), (30, 30), (25, 26)])
    assert u == [[0, 2], [5, 20], [25, 26]]
    assert spans.length(u) == 18
    assert spans.overlap(u, [[1, 6], [19, 40]]) == 1 + 1 + 1 + 1


def test_readers_give_nothing_without_the_programs_spans():
    """A program that records no span (the benchmark laid over an older
    checkout) and a run with no trace: every reader gives nothing."""
    bare = [e for e in EVENTS if not e[1].startswith("rt.")]
    for run in (_run(bare), _run(None)):
        for name in TAIL_METRICS:
            assert _read(name, run) is None


def test_idle_share_needs_a_cuda_trace():
    run = _run(EVENTS, device="cpu")
    assert _read("tail_idle_share.sweep", run) is None
    assert _read("syncs_per_trial", run) == pytest.approx(1.0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cpu_run_reports_the_tails_counters(cell, small):
    out = execute(cell, small, trace=1)
    assert out["correct"] is True
    got = out["metrics"]
    assert not {"tail_idle_share.sweep", "tail_idle_share.track"} & set(got)
    if cell == "exact16.sweep":
        assert got["syncs_per_trial"]["value"] > 0
        assert got["tail_host_ms_per_trial"]["value"] > 0
    else:
        assert not {"syncs_per_trial", "tail_host_ms_per_trial"} & set(got)
