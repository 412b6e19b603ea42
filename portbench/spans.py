"""What the frame-tail readers share: the program's own spans in the
traced window.

``radar_tpu_torch.utils.profiling.span`` records each stage of a frame or
trial as one flat ``rt.<stage>`` range on the profiler's clock, and each
wait of the host on the card as one ``rt.sync`` inside its stage. A run
of a program that records none gives no spans, and the readers then give
nothing.
"""

from __future__ import annotations

from portbench.harness import busy_intervals

# the frame tail's stages: the CFAR, extraction, estimation, both
# clusterings (``pipeline/frame.py::detection_tail``)
TAIL = ("rt.cfar", "rt.extract", "rt.estimate", "rt.cluster1",
        "rt.cluster2")
SYNC = "rt.sync"
COUNTED = "rt.cfar"     # one a trial and one a frame


def program_spans(run, names) -> list:
    """(start_us, end_us) of the host spans named in ``names`` that start
    in the traced window, clipped to it."""
    if run.trace_events is None:
        return []
    lo, hi = run.trace_window_us
    return [(s, min(e, hi)) for k, n, s, e in run.trace_events
            if k == "cpu" and n in names and lo <= s <= hi]


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> float:
    """The length of the intersection of two unions of disjoint sorted
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def counted(run) -> int:
    """The trials or frames in the window: its ``rt.cfar`` spans."""
    return len(program_spans(run, (COUNTED,)))


def tail_idle_percent(run) -> float | None:
    """The share of the window's device-idle time in which the host was
    inside a tail stage, in percent; nothing without a CUDA trace, a
    tail span or any idle time."""
    if run.trace_events is None or run.device.type != "cuda":
        return None
    tail = union(program_spans(run, TAIL))
    if not tail:
        return None
    lo, hi = run.trace_window_us
    busy = busy_intervals(run.trace_events, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_us = length(idle)
    if idle_us <= 0:
        return None
    return 100.0 * overlap(idle, tail) / idle_us
