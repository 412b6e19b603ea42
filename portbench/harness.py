"""What every cell shares: finding its files by name, the run's context,
the profiler's reading, the import guard and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<config>.json`` (the port's ``RadarConfig`` tree
under "radar"), the mix ``traffic/<traffic>.json``, whose "kind" names the
load generator ``loads/<kind>.py``; each per-layer metric is read by
``metrics/<metric>.py``; the limits of the cell's comparison are in
``limits/<cell>.json``. Adding any of them adds a file and an entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run (whole names:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "radar_tpu")
# fixed build and kernel cache directories inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": "build/portbench/triton",
             "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
             "CUDA_CACHE_PATH": "build/portbench/nv"}
# the host's thread pools, fixed before torch and numpy load them
THREADS = 4
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


class CellError(Exception):
    """The cell cannot run here (no card, files missing): exit non-zero
    and print no result."""


def process_start_time() -> float:
    """The wall-clock time this process started, from ``/proc``; the
    module's import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(*parts):
    path = os.path.join(HERE, *parts)
    if not os.path.exists(path):
        raise CellError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, by file path (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise CellError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise CellError("no BENCHMARK.json at the checkout's root")
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise CellError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those listing it, or listing no
    cells and moving an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def radar_config(tree: dict):
    """The port's ``RadarConfig`` of a configuration file's "radar" tree
    (every field given; lists become tuples)."""
    from radar_tpu_torch.config import params

    def build(cls, d):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                raise CellError(f"configuration lacks {cls.__name__}."
                                f"{f.name}")
            v = d[f.name]
            sub = getattr(params, type(f.default).__name__, None)
            if isinstance(v, dict) and dataclasses.is_dataclass(sub):
                v = build(sub, v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        extra = set(d) - {f.name for f in dataclasses.fields(cls)}
        if extra:
            raise CellError(f"configuration keys the program lacks: "
                            f"{sorted(extra)}")
        return cls(**kw)

    return build(params.RadarConfig, tree)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the load generator, the metric readers
    and the comparison share."""

    cell: str
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    device: object = None        # torch.device
    cfg: object = None           # the port's RadarConfig
    state: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace_events: list | None = None   # (kind, name, start_us, end_us)
    trace_window_us: tuple | None = None

    def span(self, name: str, seconds: float, count: int = 1) -> None:
        self.spans.setdefault(name, []).append((seconds, count))

    @contextlib.contextmanager
    def traced(self):
        """Profile the block (CPU and CUDA activity) when the run traces;
        keep its events in memory."""
        if not self.trace:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("pb.traced"):
                yield
                if cuda:
                    torch.cuda.synchronize()
        self.trace_events = read_events(prof)
        span = [e for e in self.trace_events if e[1] == "pb.traced"]
        self.trace_window_us = (span[0][2], span[0][3])


def read_events(prof) -> list:
    """(kind, name, start_us, end_us) of the profile: kind "device" for an
    operation on the card, "cpu" otherwise."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        kind = "device" if e.device_type == DeviceType.CUDA else "cpu"
        if kind == "device" and (e.name.startswith("pb.") or getattr(
                e, "is_user_annotation", False)):
            continue      # the harness's own spans, mirrored on the card
        out.append((kind, e.name, float(e.time_range.start),
                    float(e.time_range.end)))
    return out


def busy_intervals(events, lo: float, hi: float) -> list:
    """The union of the device operations' intervals within [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for k, _, s, e in events
                if k == "device" and e > lo and s < hi)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_reading(run: Run) -> dict | None:
    """busy_s, window_s, the idle share, the launches recorded and those
    the host made, and the breakdown of the traced window."""
    if run.trace_events is None or run.device.type != "cuda":
        return None
    lo, hi = run.trace_window_us
    ev = run.trace_events
    busy = busy_intervals(ev, lo, hi)
    busy_us = sum(e - s for s, e in busy)
    launches = sum(1 for k, n, s, _ in ev if k == "cpu" and lo <= s <= hi
                   and "LaunchKernel" in n)
    kernels = sum(1 for k, n, s, _ in ev if k == "device" and lo <= s <= hi
                  and not n.startswith("Memcpy") and not n.startswith("Memset"))
    by_name: dict = {}
    for k, n, s, e in ev:
        if k == "device" and lo <= s <= hi:
            by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - s) / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    gaps = []
    edges = [lo] + [x for se in busy for x in se] + [hi]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            gaps.append((s, e))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [(n, s, e) for k, n, s, e in ev if k == "cpu"]

    def what(s, e):
        """The harness span and the host operation that overlap the gap
        most."""
        best = {"span": ("outside any span", 0.0),
                "op": ("no host operation", 0.0)}
        for n, a, b in host:
            ov = min(b, e) - max(a, s)
            key = "span" if n.startswith("pb.") else "op"
            if ov > best[key][1] and n != "pb.traced":
                best[key] = (n, ov)
        return f"{best['span'][0]} / {best['op'][0]}"

    window_us = hi - lo
    return {
        "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
        "idle_share": 1.0 - busy_us / window_us,
        "kernels_recorded": kernels, "launches_by_host": launches,
        "breakdown": {
            "device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[what(s, e), (e - s) / 1e6] for s, e in gaps]}}


def idle_percent(run: Run) -> float | None:
    """The traced window's share with no device operation, in percent;
    nothing without a device trace."""
    d = device_reading(run)
    return None if d is None else 100.0 * d["idle_share"]


def gap_numbers(name: str, gaps) -> dict:
    """The judged statistics of a population of gaps: its median and its
    90th percentile (numpy's, linear), under ``<name>_median`` and
    ``<name>_p90`` with the unit kept last in the name. The median reads
    the bulk; the 90th percentile a fault in a tenth of the answers or
    more, while one or two answers that a cell on the CFAR's threshold
    moves (PERF.md) leave both as they are."""
    import numpy as np

    stem, unit = name.rsplit("_", 1)
    x = np.asarray(gaps, np.float64)
    if not len(x):
        return {f"{stem}_median_{unit}": 0.0, f"{stem}_p90_{unit}": 0.0}
    return {f"{stem}_median_{unit}": float(np.median(x)),
            f"{stem}_p90_{unit}": float(np.percentile(x, 90))}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})
