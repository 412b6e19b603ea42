"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload exact16.sweep --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout that holds the port (``radar_tpu_torch``).
Set-up (imports, CUDA, the kernels' libraries, the program's plans and a
warm-up of the cell's own shapes) counts from the process's start to the
window's. The window runs the cell's traffic for ``--seconds``; with
``--trace 1`` a steady part of it is profiled and the per-layer metrics
are read instead of the end-to-end ones. Then the peak memory is read, the
program's state freed, and the plain reference judges a sample of the
window's answers, drawn from the seed. The last line of standard output
is one JSON object; the numbers compared, each beside its limit, close
standard error and the line. No card, too few cards, a module of JAX or of
the JAX package loaded, or a missing file: exit non-zero, no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(args, device=None, radar=None, traffic=None):
    """The run's context, its cell's metrics and load generator; checks
    the card before anything is built. Tests alone pass ``device`` (the
    CPU, the kernels' plain versions), ``radar`` (a small configuration
    tree in place of the cell's) and ``traffic`` (keys of the mix to
    change)."""
    bench = harness.benchmark()
    cell = harness.find_cell(bench, args.workload)
    for k, v in harness.CACHE_ENV.items():
        os.environ[k] = os.path.join(harness.ROOT, v)
    for k in harness.THREAD_ENV:
        os.environ[k] = str(harness.THREADS)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise harness.CellError("no CUDA device: this benchmark "
                                    "measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise harness.CellError(
                f"{cell['name']} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(harness.THREADS)
    config = harness.load_json("configs", cell["config"] + ".json")
    if radar is not None:
        config = dict(config, radar=radar)
    traffic = dict(harness.load_json("traffic", cell["traffic"] + ".json"),
                   **(traffic or {}))
    run = harness.Run(cell=cell["name"], config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device(device))
    run.cfg = harness.radar_config(config["radar"])
    load = importlib.import_module(f"portbench.loads.{traffic['kind']}")
    limits = harness.load_json("limits", cell["name"] + ".json")
    return bench, cell, run, load, limits


def execute(args, started: float, device=None, radar=None,
            traffic=None) -> dict:
    """One run; returns the result object (raises ``CellError`` where the
    cell cannot run)."""
    bench, cell, run, load, limits = prepare(args, device, radar,
                                             traffic)
    import torch

    cuda = run.device.type == "cuda"
    load.setup(run)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - started
    e2e = load.window(run)
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    leaked = harness.forbidden_modules()
    if leaked:
        raise harness.CellError("loaded in this process: "
                                + ", ".join(leaked))
    metrics = {}
    wanted = harness.cell_metrics(bench, cell["name"], run.trace)
    dev_read = harness.device_reading(run) if run.trace else None
    for m in wanted:
        if run.trace:
            value = harness.load_module("metrics", m["name"]).read(run)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    load.release(run)
    if cuda:
        torch.cuda.empty_cache()
    compared = load.check(run, limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device) if cuda
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": peak if cuda else 0}
    if dev_read is not None:
        device_info["busy_s"] = dev_read["busy_s"]
        device_info["window_s"] = dev_read["window_s"]
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in compared.values()),
           "attempted": run.counters.get("attempted", 0),
           "failed": run.counters.get("failed", 0),
           "metrics": metrics, "device": device_info}
    if dev_read is not None:
        out["breakdown"] = dev_read["breakdown"]
        out["launches"] = {"recorded": dev_read["kernels_recorded"],
                           "by_host": dev_read["launches_by_host"]}
    rooflines = {k: v for k, v in run.counters.items()
                 if k.endswith("_roofline")}
    if rooflines:
        out["rooflines"] = rooflines
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    started = harness.process_start_time()
    args = parse(argv)
    try:
        out = execute(args, started)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    leaked = harness.forbidden_modules()
    if leaked:
        print("portbench: loaded in this process: " + ", ".join(leaked),
              file=sys.stderr)
        return 2
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
