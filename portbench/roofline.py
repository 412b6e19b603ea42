"""The yardstick of the kernels' roofline shares: the card's published
peaks (``peaks.json``), the operations and bytes a function needs,
counted from the configuration's shapes whatever implements it, and a
kernel's time on a busy card by CUDA events.

A roofline share is the least time the card could take (the larger of the
operations over the peak rate of the configuration's precision and the
bytes, each input read once and each output written once, over the memory
bandwidth) over the time measured. It needs the card: ``time_ms`` raises
without one, and an unknown card has no peaks, so no share.
"""

from __future__ import annotations

import json
import os
import statistics

from .reference.consts import Radar

_HERE = os.path.dirname(os.path.abspath(__file__))
SLEEP_CYCLES = 2_000_000     # ~1 ms of GPU sleep ahead of each timed run
REPS = 20
C64 = 8                      # bytes of a complex64 value


def peaks(device_name: str) -> dict | None:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)["devices"]
    for prefix, p in table.items():
        if device_name.startswith(prefix):
            return p
    return None


def time_ms(fn, device) -> float:
    """Median ms a call of ``fn`` over 5 runs of ``REPS`` calls, CUDA
    events behind a sleep kernel (a busy card), after two warm-up calls."""
    import torch

    if device.type != "cuda":
        raise RuntimeError("a kernel's time is read on the card only")
    fn(), fn()
    runs = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / REPS)
    return statistics.median(runs)


def pc_macs(r: Radar) -> int:
    """Complex multiply-adds of the three segments' direct matched
    filters over every pulse and beam."""
    per_row = sum((s.hi - s.lo) * len(s.h) for s in r.segments)
    return per_row * r.num_p * r.num_b


def pc_bound_s(r: Radar, peak: dict, precision: str) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of the chain's PC: beams
    [P, S, B] complex64 in, gates [P, G, B] out."""
    ops = 8.0 * pc_macs(r) / peak[precision]
    nbytes = C64 * r.num_p * r.num_b * (r.num_s + r.num_g)
    by = nbytes / peak["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= by else (by, "bytes")


PRECISION_PEAK = {"float32": "fp32_flops"}
