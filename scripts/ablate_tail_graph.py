"""The frame tail on one NVIDIA GPU, eager against its CUDA graph, and the
connected-labels kernel against the eager labels loop it replaced (one
JSON line).

    python3 scripts/ablate_tail_graph.py [--reps 20] [--rounds 5]

At ``full_config()``, the exact stream (RDM [332, 3404, 13] complex64,
512 detection slots):

- ``labels``: clustering labels at n = 512 on three inputs: one trial's
  stage-1 detections at 30 dB (``frame``), 512 random valid slots in
  clusters (``random``) and a 512-slot path of diameter 511 in a random
  slot order (``path``). ``kernel_ms``: ``gated_labels`` (the kernel), CUDA
  events around ``--reps`` calls behind a sleep kernel (a busy card;
  median of ``--rounds``). ``eager_ms``: ``connected_labels(gate_adjacency
  (.))``, the loop that reads a device flag every ``CHECK_EVERY`` steps,
  on the host's clock from its call to its return (its last read is its
  end), median of ``--reps``. Each held equal bit for bit; ``valid`` the
  slots in use.
- ``tail``: one trial's RDM through ``FrameStages.detect``: eager (a stage
  set with no graphs) and replayed (copy-in, replay, clones). ``*_enqueue_
  ms``: the host's clock over a call; ``*_ms``: the host's clock from the
  call to a synchronize after it, a call (median of ``--reps``);
  ``graph_busy_ms``: CUDA events around ``--reps`` replays behind a sleep
  kernel; ``capture_s``: the first call (warm-up and capture); held equal
  bit for bit.

Prints the card's name and power limit in the line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

SLEEP_CYCLES = 4_000_000     # torch.cuda._sleep ahead of a timed call: ~2 ms


def _card() -> dict:
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": out}


def _busy_ms(fn, reps: int, rounds: int) -> float:
    import torch

    fn()
    runs = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return statistics.median(runs)


def _host_ms(fn, reps: int, sync: bool) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return statistics.median(runs)


def _label_inputs(d, cp, dev):
    """(name, fields, valid) at n = 512: the frame's stage-1 input (``d``
    under the gates of ``cp``), random clusters, a path of diameter
    511."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    n = d.valid.shape[0]
    out = [("frame", [(d.range_m, cp.max_range_sep),
                      (d.velocity_ms, cp.max_vel_sep),
                      (d.angle_deg, cp.max_angle_sep)], d.valid)]
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    centres = rng.random((40, 2)) * 400
    pts = centres[rng.integers(0, 40, n)] + rng.standard_normal((n, 2)) * 2
    out.append(("random", [(t(pts[:, 0]), 3.0), (t(pts[:, 1]), 3.0)],
                torch.ones(n, dtype=torch.bool, device=dev)))
    x = np.empty(n, np.float32)
    x[rng.permutation(n)] = np.arange(n)
    out.append(("path", [(t(x), 1.0)],
                torch.ones(n, dtype=torch.bool, device=dev)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from radar_tpu_torch.cluster import connected as cc
    from radar_tpu_torch.config.params import full_config
    from radar_tpu_torch.pipeline import frame
    from radar_tpu_torch.sim.scenario import TargetBatch

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = full_config()
    st = frame.make_frame_stages(cfg, device=dev, trials=True)
    eager = st._replace(graphs=None)
    tb = TargetBatch.make([10000.0], [20.0], [10.0], [30.0])
    rdm = st.chain(st.synth(tb), 11, kernel_noise=False)[-1]
    _, _, params, _, ref = eager.detect(rdm, "vgb")
    line = {"what": "ablate_tail_graph", **_card(),
            "torch": torch.__version__, "cuda": torch.version.cuda}

    labels = {}
    for name, fields, valid in _label_inputs(params, cfg.cluster, dev):
        got = cc.gated_labels(fields, valid)
        want = cc.connected_labels(cc.gate_adjacency(fields, valid), valid)
        labels[name] = {
            "valid": int(valid.sum()),
            "components": int(torch.unique(got[valid]).numel()),
            "equal": bool(torch.equal(got, want)),
            "kernel_ms": _busy_ms(lambda: cc.gated_labels(fields, valid),
                                  args.reps, args.rounds),
            "eager_ms": _host_ms(lambda: cc.connected_labels(
                cc.gate_adjacency(fields, valid), valid), args.reps, False)}
    line["labels"] = labels

    t0 = time.perf_counter()
    res = st.detect(rdm, "vgb")[-1]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    line["tail"] = {
        "equal": all(torch.equal(a, b) for a, b in zip(
            (*res.targets[:5], res.num_raw_detections, res.num_final),
            (*ref.targets[:5], ref.num_raw_detections, ref.num_final))),
        "num_final": int(res.num_final),
        "capture_s": capture_s,
        "eager_enqueue_ms": _host_ms(lambda: eager.detect(rdm, "vgb"),
                                     args.reps, False),
        "eager_ms": _host_ms(lambda: eager.detect(rdm, "vgb"), args.reps,
                             True),
        "graph_enqueue_ms": _host_ms(lambda: st.detect(rdm, "vgb"),
                                     args.reps, False),
        "graph_ms": _host_ms(lambda: st.detect(rdm, "vgb"), args.reps, True),
        "graph_busy_ms": _busy_ms(lambda: st.detect(rdm, "vgb"), args.reps,
                                  args.rounds),
        "captures": frame.tail_graph_captures,
        "replays": frame.tail_graph_replays}
    line["ok"] = (all(v["equal"] for v in labels.values())
                  and line["tail"]["equal"])
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
