"""K1 before and after its tensor-core redesign, and where the new K1's
time goes, on one NVIDIA GPU at the perf config's full shape (13 beams,
332 pulses, 3404 gates, filters of 35/200/700 taps, the rank-K signal of
bench.py's two targets).

    python3 scripts/ablate_k1.py [--reps 10]

The old K1 ran on the CUDA cores in f32: per segment ``pc_kernel`` (Philox
draws or given planes staged in shared memory, a register-window causal
convolution, the un-mixed pc [B, P, G] complex64), then ``k1_mix`` and the
tiled DFT ``k1_mtd`` of the first K4. Its convolution kernel lives only
here (``OLD_PC``), appended with the first K4's source (kept in
``scripts/ablate_k4_k9.py``) to a copy of
``radar_tpu_torch/csrc/noise_rdm.cu`` built into ``build/ablate_k1/``. The new K1 is the port's
``noise_rdm`` (``csrc/noise_rdm_sm90.cu``: K1c's planes in draw mode, the
3xTF32 strip-GEMM PC, the planar mix, the 3xTF32 DFT GEMM). Both run in
draw mode through the entry point ``noise_rdm`` (the old one in place of
``_k1_cuda``) in turns (old, new, new, old), timed with CUDA events on an
idle card and on a card kept busy by a sleep kernel ahead of the call,
with the host's time a call on the busy card, and split by kernel with
torch.profiler; the new K1 also in planes mode. Each is held against the
plain version (RMS of the difference over the RMS).

Then copies of ``noise_rdm_sm90.cu`` with parts changed, built into the
same directory and timed in turns (draw mode, noise only, the profiler's
kernels a call) beside the shipped source (``full``: the hi*hi pass, then
the correction pass), each with its map's RMS error against the plain
version: ``hi_hi_only`` (the correction passes do not run: what the hi*hi
GEMMs cost alone; wrong values), ``corr_rs`` (the correction pass takes
the data's hi from registers too, four A parts a k8 step, which ptxas
serializes) and ``one_pass`` (the first design: all three products in one
accumulator, no correction pass; less accurate, as each wgmma rounds its
sum toward zero); and, timing only, the correction pass without its SS
products (``corr_lo_only``) or its products with the data's lo
(``corr_ss_only``); and ``no_map_cache``, which encodes its 9 TMA tensor
maps on every call (its host ms against ``full``'s is what the cache of
encoded maps saves).
Prints one JSON line with the card's name and power limit. Needs the CUDA
toolkit and a card; imports no JAX.
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

SLEEP_CYCLES = 4_000_000     # torch.cuda._sleep ahead of a timed call: ~2 ms

# The old K1's convolution: one block per (128-gate tile, 8 pulse rows,
# beam), the noise window staged in shared memory, 4 output gates a lane.
OLD_PC = r"""
namespace {
template <bool kDraw>
__global__ void __launch_bounds__(kThreads)
pc_kernel(const float2* __restrict__ taps, int lh, int pad_front, int j_len,
          int g0, unsigned seg, uint2 key, float scale,
          const float* __restrict__ xr, const float* __restrict__ xi,
          long long x_len, int num_p, int num_g, float2* __restrict__ pc) {
  extern __shared__ float smem[];
  const int wl = kTile + lh - 1;            // window samples per row
  const int wlp = padded(wl - 1) + 1;       // padded row stride (words)
  float* sw_r = smem;
  float* sw_i = sw_r + kRows * wlp;
  float* th_r = sw_i + kRows * wlp;         // reversed taps: h[lh-1-k]
  float* th_i = th_r + lh;

  const int p0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * kTile;        // first buffer sample read

  load_reversed_taps(taps, lh, th_r, th_i);
  stage_window<kDraw>(sw_r, sw_i, wl, wlp, p0, b, n0, pad_front, seg, key,
                      scale, xr, xi, x_len, num_p);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int p = p0 + warp;
  if (p >= num_p) return;
  const int t0 = (threadIdx.x & 31) * kOuts;
  float ar[kOuts], ai[kOuts];
  conv_row(sw_r + warp * wlp, sw_i + warp * wlp, th_r, th_i, lh, t0, ar, ai);
  float2* row = pc + ((long long)b * num_p + p) * num_g + g0;
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int j = n0 + t0 + o;
    if (j < j_len) row[j] = make_float2(ar[o], ai[o]);
  }
}

}  // namespace

extern "C" {
// One segment's convolution into pc [B, P, G] at gate offset g0. Planes
// mode when xr/xi are given ([B, P, x_len] f32, x_len >= samples read),
// draw mode (Philox keyed by (s0, s1), counter (n, p, b, seg)) otherwise.
int k1_pc(const void* taps, int lh, int pad_front, int j_len, int g0,
          int seg, unsigned s0, unsigned s1, float scale, const void* xr,
          const void* xi, long long x_len, int num_b, int num_p, int num_g,
          void* pc, void* stream) {
  const int wl = kTile + lh - 1;
  const int wlp = padded(wl - 1) + 1;
  const size_t smem = (2 * (size_t)kRows * wlp + 2 * (size_t)lh) * sizeof(float);
  const dim3 grid((j_len + kTile - 1) / kTile, (num_p + kRows - 1) / kRows,
                  num_b);
  const uint2 key = make_uint2(s0, s1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xr == nullptr) {
    cudaFuncSetAttribute(pc_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    pc_kernel<true><<<grid, kThreads, smem, st>>>(
        static_cast<const float2*>(taps), lh, pad_front, j_len, g0,
        (unsigned)seg, key, scale, nullptr, nullptr, 0, num_p, num_g,
        static_cast<float2*>(pc));
  } else {
    cudaFuncSetAttribute(pc_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    pc_kernel<false><<<grid, kThreads, smem, st>>>(
        static_cast<const float2*>(taps), lh, pad_front, j_len, g0,
        (unsigned)seg, key, scale, static_cast<const float*>(xr),
        static_cast<const float*>(xi), x_len, num_p, num_g,
        static_cast<float2*>(pc));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
"""
OLD_PC_SIGNATURE = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p]


PASS0 = """      wgmma_tf32<1>(accr, rh, brh);
      wgmma_tf32<-1>(accr, ih, bih);
      wgmma_tf32<1>(acci, rh, bih);
      wgmma_tf32<1>(acci, ih, brh);
"""
# the correction pass's products with the constant's lo: the data's hi
# straight from the stage (SS)
CORR_SS = """      wgmma_tf32_ss<1>(accr, dar, brl);
      wgmma_tf32_ss<-1>(accr, dai, bil);
      wgmma_tf32_ss<1>(acci, dar, bil);
      wgmma_tf32_ss<1>(acci, dai, brl);
"""
CORR_RS = CORR_SS.replace("_ss", "").replace("dar", "rh").replace("dai", "ih")
CORR_LO = """      wgmma_tf32<1>(accr, rl, brh);
      wgmma_tf32<-1>(accr, il, bih);
      wgmma_tf32<1>(acci, rl, bih);
      wgmma_tf32<1>(acci, il, brh);
"""
PLANES = "constexpr int plane_step(bool corr) { return corr ? 1 : 2; }"
# without the correction passes: their launches, and the mix's and the
# add's reads of their results
SKIP = tuple((f"if (err == cudaSuccess) {k}_gemm_kernel<true>",
              f"if (false) {k}_gemm_kernel<true>") for k in ("pc", "dft")) + (
    ("pr[c * n + i] + cr[c * n + i]", "pr[c * n + i]"),
    ("pi[c * n + i] + ci[c * n + i]", "pi[c * n + i]"),
    ("  add_kernel<<<", "  if (false) add_kernel<<<"))
VARIANTS = {
    "hi_hi_only": SKIP,
    "corr_rs": ((CORR_SS, CORR_RS),),
    "one_pass": ((PLANES, "constexpr int plane_step(bool corr) { return 1; }"),
                 (PASS0, PASS0 + CORR_RS + CORR_LO)) + SKIP,
    # the correction pass without its SS products or without its products
    # with the data's lo (timing only)
    "corr_lo_only": ((CORR_SS, ""),),
    "corr_ss_only": ((CORR_SS + CORR_LO, CORR_SS),),
    # every call encodes its maps (timing only)
    "no_map_cache": (("    if (memcmp(g_maps[i].key, key, sizeof key) == 0) {",
                      "    if (false) {"),),
}


def _compile(sources: dict, build_dir: str) -> dict:
    """nvcc each .cu text of ``sources`` (name -> text) with the port's
    flags into lib<name>.so, all at once; name -> library path."""
    from radar_tpu_torch import _build

    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(build_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(build_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, "-I", _build._CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


def _load(so: str, lib_name: str) -> ctypes.CDLL:
    from radar_tpu_torch import _build

    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES[lib_name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.radar_error_string.argtypes = [ctypes.c_int]
    lib.radar_error_string.restype = ctypes.c_char_p
    return lib


def build_variants(build_dir: str) -> dict:
    """The shipped noise_rdm_sm90.cu and the VARIANTS copies, loaded."""
    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "noise_rdm_sm90.cu")) as f:
        full = f.read()
    sources = {"full": full}
    for name, cuts in VARIANTS.items():
        src = full
        for old, new in cuts:
            if src.count(old) != 1:
                raise RuntimeError(f"noise_rdm_sm90.cu no longer has the "
                                   f"text {name} changes: {old[:60]!r}")
            src = src.replace(old, new)
        sources[name] = src
    return {name: _load(so, "noise_rdm_sm90")
            for name, so in _compile(sources, build_dir).items()}


def variants(plan, lmat, seed, reps: int = 10) -> dict:
    """Each VARIANTS copy beside the shipped K1 (draw mode, noise only):
    busy-card events and host ms a call in turns, the profiler's kernels,
    the RMS error against the plain version."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "ablate_k1"))
    shipped = _build.load("noise_rdm_sm90")
    planes = nr.philox_planes(plan, seed, lmat.shape[0], device=lmat.device)
    ref = nr.noise_rdm_plain(plan, lmat, planes)
    rms = float(ref.abs().pow(2).mean().sqrt())
    call = lambda: nr.noise_rdm(plan, lmat, seed=seed, layout="bvg")
    out = {name: {"busy": [], "host": []} for name in libs}
    try:
        for name, lib in libs.items():
            _build._libs["noise_rdm_sm90"] = lib
            y = call()
            out[name]["rms_err_over_rms"] = float(
                (y - ref).abs().pow(2).mean().sqrt()) / rms
            out[name]["profile_ms"] = _profile(call)
        del ref, y
        for _ in range(reps):
            for name in list(libs) + list(libs)[::-1]:
                _build._libs["noise_rdm_sm90"] = libs[name]
                dev_ms, host_ms = _events(call, True)
                out[name]["busy"].append(dev_ms)
                out[name]["host"].append(host_ms)
    finally:
        _build._libs["noise_rdm_sm90"] = shipped
    for v in out.values():
        v["busy_ms"] = statistics.median(v.pop("busy"))
        v["host_ms"] = statistics.median(v.pop("host"))
    return out


def build_old(build_dir: str) -> ctypes.CDLL:
    """noise_rdm.cu with the first K4's source (its window staging,
    convolution, mix and tiled DFT, from scripts/ablate_k4_k9.py) and
    OLD_PC appended, built and loaded."""
    from ablate_k4_k9 import OLD_K4, OLD_K4_SIGNATURES

    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "noise_rdm.cu")) as f:
        so = _compile({"old_k1": f.read() + OLD_K4 + OLD_PC},
                      build_dir)["old_k1"]
    lib = _load(so, "noise_rdm")
    for fn, argtypes in {**OLD_K4_SIGNATURES,
                         "k1_pc": OLD_PC_SIGNATURE}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def old_k1(lib, plan, lmat, signal, seed):
    """The old K1 in draw mode: three pc_kernel launches, the in-place mix
    and the tiled DFT with the rank-K signal (all f32, CUDA cores)."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    dev = lmat.device
    num_b, num_p = lmat.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    num_k, sig_ptrs, _keep = nr._signal_args(signal, dev, num_b, num_v,
                                             num_g)
    pc = torch.empty((num_b, num_p, num_g), dtype=torch.complex64,
                     device=dev)
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for si, seg in enumerate(plan.segments):
        taps = seg.taps.contiguous()
        _build.check(lib, lib.k1_pc(
            taps.data_ptr(), taps.shape[0], seg.pad_front, seg.j_len, seg.g0,
            si, seed[0], seed[1], ctypes.c_float(nr.U_SCALE), None, None, 0,
            num_b, num_p, num_g, pc.data_ptr(), stream), "k1_pc")
    lmat = lmat.contiguous()
    _build.check(lib, lib.k1_mix(pc.data_ptr(), lmat.data_ptr(), num_b,
                                 num_p * num_g, stream), "k1_mix")
    d = plan.d.contiguous()
    _build.check(lib, lib.k1_mtd(d.data_ptr(), pc.data_ptr(), num_b, num_v,
                                 num_p, num_g, *sig_ptrs, num_k,
                                 out.data_ptr(), stream), "k1_mtd")
    return out


def _events(fn, busy: bool) -> tuple:
    """(CUDA-event ms, host ms) of one call of ``fn``; ``busy`` puts a sleep
    kernel ahead of it, so the events hold device time only."""
    import time

    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if busy:
        torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    return a.elapsed_time(b), host


def _profile(fn, reps: int = 5) -> dict:
    """Device ms a call by kernel name (torch.profiler): a kernel's mean
    over the launches recorded times its launches a call (the recorded
    ones over ``reps``, rounded), as ``chip_smoke.py::_kernel_profile``, so
    that a launch the profiler missed does not lower it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and dev_t(e) > 0:
            seen = e.count / reps
            calls = round(seen) if seen >= 0.5 else seen
            out[e.key[:60]] = (out.get(e.key[:60], 0.0)
                               + dev_t(e) / e.count / 1000.0 * calls)
    return out


def measure(plan, lmat, signal, seed, reps: int = 10) -> dict:
    """The old and the new K1 in draw mode at the given plan, both through
    ``noise_rdm``: events in turns on an idle and a busy card and the
    host's time a call on the busy card (medians, ms), the profiler's
    split, and each one's RMS error against the plain version."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    lib = build_old(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                 "ablate_k1"))
    num_b = lmat.shape[0]
    planes = nr.philox_planes(plan, seed, num_b, device=lmat.device)
    new_route = nr._k1_cuda
    old_route = lambda plan_, l_, signal_, seed_, planes_: old_k1(
        lib, plan_, l_, signal_, seed_)

    def old_call():
        nr._k1_cuda = old_route
        try:
            return nr.noise_rdm(plan, lmat, signal, seed=seed, layout="bvg")
        finally:
            nr._k1_cuda = new_route

    calls = {
        "old": old_call,
        "new": lambda: nr.noise_rdm(plan, lmat, signal, seed=seed,
                                    layout="bvg"),
        "new_planes_mode": lambda: nr.noise_rdm(plan, lmat, signal,
                                                planes=planes, layout="bvg"),
    }
    ref = nr.noise_rdm_plain(plan, lmat, planes, signal)
    rms = float(ref.abs().pow(2).mean().sqrt())
    err = {k: float((fn() - ref).abs().pow(2).mean().sqrt()) / rms
           for k, fn in calls.items()}
    del ref
    times = {k: {"idle": [], "busy": [], "host": []} for k in calls}
    for k in calls:
        calls[k]()
    torch.cuda.synchronize()
    for _ in range(reps):
        for k in ("old", "new", "new_planes_mode", "new_planes_mode", "new",
                  "old"):
            for mode in ("idle", "busy"):
                dev_ms, host_ms = _events(calls[k], mode == "busy")
                times[k][mode].append(dev_ms)
                if mode == "busy":
                    times[k]["host"].append(host_ms)
    return {
        "ms_idle": {k: statistics.median(v["idle"]) for k, v in times.items()},
        "ms_busy": {k: statistics.median(v["busy"]) for k, v in times.items()},
        "host_ms": {k: statistics.median(v["host"]) for k, v in times.items()},
        "profile_ms": {k: _profile(fn) for k, fn in calls.items()},
        "rms_err_over_rms": err,
    }


def main() -> int:
    import torch

    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.sim.scenario import TargetBatch
    from radar_tpu_torch.waveform.precompute import precompute

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = perf_config()
    pre = precompute(cfg)
    lr = make_lowrank_stages(cfg, pre, device="cuda")
    truth = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                             [10.0, 15.0])
    seed = nr.seed_words(20261016)
    res = measure(lr.rplan, lr.l_factor, lr.signal_factors(truth), seed,
                  args.reps)
    res["variants"] = variants(lr.rplan, lr.l_factor, seed, args.reps)
    print(json.dumps({"card": card, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
