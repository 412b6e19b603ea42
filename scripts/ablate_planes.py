"""Where the time of K1c goes: ablations of ``planes_kernel``
(``radar_tpu_torch/csrc/noise_rdm.cu``, the port's ``gen_noise_planes``,
draw mode's white planes) on one NVIDIA GPU, at the perf configuration's
full plan (13 beams x 332 pulses, three segments, 20.4 M complex samples,
163.5 MB written).

    python3 scripts/ablate_planes.py [--rounds 3]

Builds copies of the source into ``build/ablate_planes/`` with parts of
the kernel taken out: the Philox rounds (``no_philox``: a multiply and an
XOR of the counters stand in for the draw), the stores (``no_store``: each
16-byte store runs only for one NaN pattern that never comes, so the draws
still count), and the streaming stores' evict-first hint (``wb_store``:
plain write-back stores). Each copy runs ``gen_noise_planes`` in turns with
the others and with ``torch.rand`` of the same bytes; the times are CUDA
events around one call with the card kept busy by a sleep kernel ahead
(device time; median over the rounds of the median of 10 calls). The
ablated copies compute wrong values (timing only). Prints one JSON line
with the card's name and power limit. Needs the CUDA toolkit and a card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

PHILOX = """      const uint4 w = philox4x32_10(
          make_uint4((unsigned)(n0 + k), p, b, seg), key);
"""
NO_PHILOX = """      const uint4 w = make_uint4(((unsigned)(n0 + k) * 2654435761u) ^ p,
                                 (b * 40503u) ^ seg ^ key.x, 0u, 0u);
"""
STORE_R = "      __stcs(reinterpret_cast<float4*>(xr + n0),"
STORE_I = "      __stcs(reinterpret_cast<float4*>(xi + n0),"
NEVER = ("      if (__float_as_uint(vr[0] + vr[1] + vr[2] + vr[3] + vi[0] + "
         "vi[1] + vi[2] + vi[3]) == 0x7fc00001u) ")
# (text, replacement, occurrences)
CUTS = {"philox": (PHILOX, NO_PHILOX, 1),
        "store_r": (STORE_R, NEVER + STORE_R.lstrip(), 1),
        "store_i": (STORE_I, NEVER + STORE_I.lstrip(), 1),
        "wb": ("__stcs(reinterpret_cast<float4*>", "__stwb(reinterpret_cast"
               "<float4*>", 2)}
VARIANTS = {"full": (), "no_philox": ("philox",),
            "no_store": ("store_r", "store_i"), "wb_store": ("wb",)}


def _sources(src: str) -> dict:
    for old, _, n in CUTS.values():
        if src.count(old) != n:
            raise RuntimeError(f"the kernel no longer has the text to cut: "
                               f"{old.strip()[:60]!r}")
    out = {}
    for name, cuts in VARIANTS.items():
        s = src
        for c in cuts:
            s = s.replace(*CUTS[c][:2])
        out[name] = s
    return out


def main() -> int:
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.waveform.precompute import precompute

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_planes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_build._CSRC, "noise_rdm.cu")) as f:
        sources = _sources(f.read())
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR),
                           "ablate_planes")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, "-I", _build._CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, argtypes in _build._SIGNATURES["noise_rdm"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.radar_error_string.argtypes = [ctypes.c_int]
        lib.radar_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device="cuda")
    plan, num_b = lr.rplan, lr.l_factor.shape[0]
    n_planes = sum(num_b * plan.n_pulses * sg.xlen for sg in plan.segments)

    def busy_ms(fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            torch.cuda._sleep(4_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    times = {name: [] for name in [*libs, "torch_rand"]}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            _build._libs["noise_rdm"] = lib
            times[name].append(busy_ms(
                lambda: nr.gen_noise_planes(plan, (3, 5), num_b,
                                            device="cuda")))
        times["torch_rand"].append(busy_ms(
            lambda: torch.rand(2 * n_planes, device="cuda")))
    _build._libs.pop("noise_rdm")
    print(json.dumps({"card": card, "samples": n_planes,
                      "bytes": 8 * n_planes,
                      "ms": {k: statistics.median(v)
                             for k, v in times.items()},
                      "rounds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
