"""tail_host_ms_per_trial: the host's dispatch time in the frame tail a
sweep trial: the time inside the union of the program's ``rt.cfar``,
``rt.extract``, ``rt.estimate``, ``rt.cluster1`` and ``rt.cluster2``
spans in the traced window, less the part its ``rt.sync`` spans cover
(waiting, not dispatch), over its ``rt.cfar`` spans there (one a trial).
Host clock of the profiler. Moves ``trials_per_s``."""

from portbench.spans import (SYNC, TAIL, counted, length, overlap,
                             program_spans, union)


def read(run):
    n = counted(run)
    if not n:
        return None
    tail = union(program_spans(run, TAIL))
    waits = union(program_spans(run, (SYNC,)))
    return (length(tail) - overlap(tail, waits)) / 1e3 / n
