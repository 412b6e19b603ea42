"""Where the time of the strip GEMM goes: ablations of ``strip_pc_kernel``
(``radar_tpu_torch/csrc/band_pc_sm90.cu``, the bf16 pulse compression of
the port's K8, K7 and K9) on one NVIDIA GPU, at K8's full width.

    python3 scripts/ablate_strip_pc.py [--rounds 3]

Builds copies of the source into ``build/ablate_strip_pc/`` with parts of
the kernel taken out: the epilogue's stores to device memory
(``no_store``; the tile still goes to shared memory), the
wgmma instructions (``no_mma``), the TMA loads (``no_load``: the producer
only arrives on the stage's barrier), and pairs of these. Each copy runs
``studies.pallas_pc.pulse_compress_noise`` (bf16) on a full_config() cube
(13 beams x 332 pulses) in turns with the others, and the GEMM's device time
comes from torch.profiler (median over the rounds of the mean of 10 calls).
The ablated copies compute wrong values by design: timing only. Prints one
JSON line with the card's name and power limit. Needs the CUDA toolkit and
a card; imports no JAX.
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

MMA = """      wgmma_m64n128k16<1>(accr, dxr, dsr);
      wgmma_m64n128k16<-1>(accr, dxi, dsi);
      wgmma_m64n128k16<1>(acci, dxr, dsi);
      wgmma_m64n128k16<1>(acci, dxi, dsr);
"""
LOAD = """        mbar_expect_tx(full(st), kDraw ? 2 * kTileB : kStageBytes);
        if (!kDraw) {
          tma_load(base, mxr, j0 + kt * kBK, m0, full(st));
          tma_load(base + kTileA, mxi, j0 + kt * kBK, m0, full(st));
        }
        tma_load(base + 2 * kTileA, msr, kt * kBK, 0, full(st));
        tma_load(base + 2 * kTileA + kTileB, msi, kt * kBK, 0, full(st));
"""
STORE = "  if (j >= sg.j_len) return;\n"
CUTS = {"no_store": (STORE, "  if (j >= sg.j_len || a.num_g > 0) return;\n"),
        "no_mma": (MMA, ""),
        "no_load": (LOAD, "        mbar_arrive(full(st));\n")}
VARIANTS = {"full": (), "no_store": ("no_store",), "no_mma": ("no_mma",),
            "no_load": ("no_load",), "mma_only": ("no_load", "no_store"),
            "loads_only": ("no_mma", "no_store"),
            "store_only": ("no_load", "no_mma")}


def _sources(src: str) -> dict:
    for old, _ in CUTS.values():
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has the text to cut: "
                               f"{old.strip()[:60]!r}")
    out = {}
    for name, cuts in VARIANTS.items():
        s = src
        for c in cuts:
            s = s.replace(*CUTS[c])
        out[name] = s
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import full_config
    from radar_tpu_torch.studies import pallas_pc as ppc
    from radar_tpu_torch.waveform.precompute import precompute

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_strip_pc: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_build._CSRC, "band_pc_sm90.cu")) as f:
        sources = _sources(f.read())
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR),
                           "ablate_strip_pc")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        with open(os.path.join(out_dir, f"{name}.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, "-I", _build._CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"),
             os.path.join(out_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, argtypes in _build._SIGNATURES["band_pc_sm90"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.radar_error_string.argtypes = [ctypes.c_int]
        lib.radar_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    cfg = full_config()
    plan = ppc.make_pallas_pc_plan(precompute(cfg), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (cfg.sig.beam_num, cfg.sig.prt_num, plan.s_compact)
    z = torch.complex(torch.randn(shape, generator=g, device="cuda"),
                      torch.randn(shape, generator=g, device="cuda"))
    times = {name: [] for name in libs}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            _build._libs["band_pc_sm90"] = lib
            for _ in range(3):
                ppc.pulse_compress_noise(z, plan)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    ppc.pulse_compress_noise(z, plan)
                torch.cuda.synchronize()
            dev_t = lambda e: getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0))
            times[name].append(sum(dev_t(e) for e in prof.key_averages()
                                   if "strip_pc_kernel" in e.key) / 1e4)
    _build._libs.pop("band_pc_sm90")
    print(json.dumps({"card": card, "strip_gemm_ms": {
        k: statistics.median(v) for k, v in times.items()}, "rounds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
