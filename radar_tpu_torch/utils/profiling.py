"""Tracing / profiling utilities — port of ``radar_tpu/utils/profiling.py``
(SURVEY.md section 5.1).

The reference's only instrumentation is tic/toc around the frame loop and
fprintf stage banners (main_simulate_echoes_with_array_v8_3.m:195,249;
fun_process_single_frame.m:46-153). The framework replaces that with:

  - ``StageTimer``: per-stage wall-clock accumulation; with a value to wait
    on, the clock stops after the value's card has finished its work
    (``torch.cuda.synchronize``; nothing for CPU tensors), so device time
    is charged to the stage that queued it;
  - ``trace``: context manager around ``torch.profiler`` (CPU and, where
    there is a card, CUDA activities) that writes a Chrome trace into a
    directory;
  - ``span``: the program's own ranges. Each stage of a frame or trial
    (``rt.synth``, ``rt.noise``, ``rt.dbf``, ``rt.pc``, ``rt.mtd``,
    ``rt.cfar``, ``rt.extract``, ``rt.estimate``, ``rt.cluster1``,
    ``rt.cluster2``; a multi-frame run's ``rt.log`` and ``rt.associate``)
    is one flat range at its call site, and each wait of the host on the
    card (a copy between host and card, a read of a device value) is one
    ``rt.sync`` inside its stage. They are
    ``torch.profiler.record_function`` ranges, recorded exactly when a
    profiler records (``trace``, any ``torch.profiler.profile``), on the
    profiler's own clock beside the CUDA activity, and kept in the
    profiler's memory for its owner to read or export. With no profiler a
    span costs one flag check and enters nothing;
  - ``FrameMetrics``: structured per-frame records (the system-of-record
    detection-count log, ref :156, v8_3:236-246).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict

import torch


def _sync(value) -> None:
    """Wait for every card that holds a tensor of ``value`` (a tensor or a
    nest of tuples, lists and dicts of them); CPU tensors need nothing."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(value)
    for dev in devices:
        torch.cuda.synchronize(dev)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The range ``"rt." + name`` (``torch.profiler.record_function``)
    while a profiler records; else one shared do-nothing context. Stages
    are siblings, never nested, so a profile's idle gap takes the name of
    the stage the host was in; ``span("sync")`` marks one wait of the host
    on the card, inside its stage."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("rt." + name)
    return _NO_SPAN


def host_to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``. A copy from the
    host to a card waits on the card's stream, so there it is one
    ``rt.sync``; on the CPU nothing moves and nothing is recorded."""
    device = torch.device(device)
    if device.type == "cuda" and not (torch.is_tensor(x) and x.is_cuda):
        with span("sync"):
            return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


class StageTimer:
    """Accumulates per-stage wall time; a ``sync_value`` is waited on
    before the clock stops, to charge device time to the right stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _sync(sync_value)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time_stage(self, name: str, fn, *args, **kw):
        with self.stage(name):
            out = fn(*args, **kw)
            _sync(out)
        return out

    def report(self) -> dict[str, dict]:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in sorted(self.totals)}

    def samples_per_second(self, name: str, samples_per_call: int) -> float:
        t = self.totals.get(name, 0.0)
        return samples_per_call * self.counts[name] / t if t else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, written into ``log_dir`` as
    a Chrome trace (``trace_<pid>_<ns>.json``; chrome://tracing or
    Perfetto). Yields the profiler, whose ``key_averages()`` tabulates the
    recorded operations and kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclasses.dataclass
class FrameMetrics:
    """Structured per-frame observability record."""

    frame_idx: int
    azimuth_deg: float
    num_raw_detections: int
    num_final_targets: int
    wall_ms: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class MetricsLog:
    def __init__(self):
        self.records: list[FrameMetrics] = []

    def record(self, m: FrameMetrics) -> None:
        self.records.append(m)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for m in self.records:
                f.write(m.to_json() + "\n")

    def summary(self) -> dict:
        if not self.records:
            return {"frames": 0}
        import numpy as np

        walls = np.array([m.wall_ms for m in self.records])
        return {
            "frames": len(self.records),
            "total_detections": sum(m.num_raw_detections
                                    for m in self.records),
            "total_final_targets": sum(m.num_final_targets
                                       for m in self.records),
            "mean_frame_ms": float(walls.mean()),
            "p50_frame_ms": float(np.percentile(walls, 50)),
            "p99_frame_ms": float(np.percentile(walls, 99)),
        }
