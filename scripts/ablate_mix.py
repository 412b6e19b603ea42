"""The bf16 beam mix before and after its redesign for Hopper, on one
NVIDIA GPU at the perf configuration's full shape (13 beams x 332 Doppler
bins x 3404 gates; one JSON line).

    python3 scripts/ablate_mix.py [--reps 20] [--rounds 3]

``old`` is the first mix (``OLD_SOURCE``: ``radar_tpu_torch/csrc/
rdm_variants.cu`` as it was before the redesign, kept only here and built
into ``build/ablate_mix/``): one thread a (v, g) cell, 2-byte loads of the
26 bf16 planes, L read from shared memory for every cell, the rank-K
signal's outer products formed again for every beam. ``new`` is the port's
mix (``csrc/rdm_variants.cu``: a thread owns a run of cells of a row, two
without the signal, 4-byte plane loads and 16-byte map stores, L read two
columns at a time for the run, the beam count compiled in, the outer
products formed once a cell, with K > 2 every beam held and st staged in
shared memory). Both are called through their C entry ``rv_mix`` on the
same random bf16 planes, L and signal factors of the perf configuration
(K = 2: the benchmark's two targets; K = 40: forty targets,
``run_streaming_mc``'s scene), in turns (old, new, ..., then backwards),
each timed by CUDA events around ``--reps`` launches behind a sleep kernel
(device time; the median over ``--rounds``), in these variants: no
signal, no signal with bf16 output (the trials' map), K = 2, K = 2 with
the pair maps, K = 40, K = 40 with the maps. Each variant's bound is the
larger of its bytes (the planes read, the map and the maps written, each
once, at 3.35 TB/s) and its FP32 operations (the mix's 4B^2 FFMAs and 2B
adds a cell, the signal's 6K + 8BK, the maps' 5B; each its own
instruction, as the file is built with -fmad=false) at 128 lanes an SM
and clock on every SM at the top SM clock nvidia-smi reads. Beside them,
copies of the new source, timing only, that say what holds it: ``run1``
(every shape through the one-cell instances), ``no_store`` (the map's and
the maps' stores made only for a NaN pattern that never comes),
``no_load`` (the planes' values made from the cell index, no load) and
``compute`` (neither loads nor stores: the FP32 work alone); and ``copy``
(a kernel that reads the same planes and writes the same map bytes with
no arithmetic). The new mix is held bit for bit against the old one in
every variant: K of 0, 2 and 40, with and without the maps, with and
without bf16 output. Prints the card's name and power limit in the line.
Needs the CUDA toolkit and a card; imports no JAX. Nothing of the port
calls the old copy.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "ablate_mix")
SLEEP_CYCLES = 4_000_000     # torch.cuda._sleep ahead of a timed call: ~2 ms
PEAK_HBM = 3.35e12           # H100 SXM HBM bytes/s
LANES_PER_SM = 128           # FP32 operations an SM issues a clock

# csrc/rdm_variants.cu before the redesign (its mix_kernel, rv_mix)
OLD_SOURCE = r"""// K10, K7, K9: the beam mix of the noise-RDM kernel studies' bf16 path
// for NVIDIA Hopper (sm_90a).
//
// The TPU kernels behind radar_tpu/ops/pallas_rdm.py::noise_rdm_pallas(z,
// plan, L, mul_dtype=, variant=) (K10 variant="resident",
// noise_rdm_pallas_planes, pallas_call :789; K7 "stacked", _call_stacked
// :627, and the stacked=True products of the rolling draw kernel :980; K9
// "allbeams", _call_allbeams :1088) compute per segment, with x the white
// planes, M the banded filter [W, T], D the MTD DFT [V, P] and L the 13x13
// Cholesky factor,
//
//   rdm[b] = sum_c L[b,c] * D @ PC_seg(x_c)   (+ the rank-K signal)
//
// in the TPU's arithmetic for a multiply type T (float, or bf16 as the TPU
// runs it), the beam mix AFTER the DFT. What runs where:
//   f32 (K10, K7, K9 and K7's draw mode): K1's 3xTF32 tensor-core GEMMs of
//       noise_rdm_sm90.cu (strip-GEMM PC, DFT GEMM, then its mix-after
//       epilogue), one sequence for the three schedules;
//   bf16 (K10, K7, K9, and K7's draw mode): the strip GEMM of
//       band_pc_sm90.cu (in draw mode its producers draw the data), the
//       wgmma DFT GEMM of rdm_sm90.cu, then mix_kernel (here).
// At bf16 every operand is a bf16 value, products accumulate in f32, and
// the PC and MTD results are rounded to bf16; rounding is to nearest even
// (__float2bfloat16_rn), as torch's .to(torch.bfloat16) and JAX's astype.
//
// mix_kernel: a thread owns one (v, g) of every beam, L in shared memory; it
// reads the bf16 mt planes and writes the f32 map once, so bytes bound it.
// It is also the tail of K1's (and K4's) bf16 path (ops/noise_rdm.py::
// _bf16_chain; radar_tpu/ops/pallas_rdm.py::noise_rdm_pallas_gen at its
// default bf16 mul_dtype, whose rolling kernel mixes after the DFT too,
// _mix_vals :159-172, then adds the signal, :447-468). For the kernel-maps
// tail it writes, as the TPU kernel does from its resident f32 tiles
// (:469-478), the adjacent-beam pair maps |y_b| + |y_b+1| of the UNROUNDED
// f32 map (after the signal) into K2's padded qvg buffer: the thread walks
// the beams in order and keeps the previous beam's magnitude in a register,
// so the maps cost their own bytes written and no second pass over the map
// (the f32 path's add_maps_kernel reads the map again). The magnitude is
// sqrt(re*re + im*im) rounded at each step, as the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 16;     // beams a mix holds in registers

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float f32(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

// x rounded to T (nearest even) and widened back to f32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::f32(Num<T>::from(x));
}

// ------------------------------------------------------------ the mix

struct Signal {
  const float2* dv;      // [K, V]
  const float2* pb;      // [K, G]
  const float2* st;      // [K, B]
  int num_k;
};

// y[b] = sum_c L[b,c] x[c] as the TPU's two real contractions (lr.x and
// li.x, combined once), plus the rank-K signal; unrounded.
__device__ __forceinline__ float2 mix_out(const float2* sl, int num_b, int b,
                                          const float2 (&x)[kMaxB], int v,
                                          int g, int num_v, int num_g,
                                          const Signal& s) {
  float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxB; ++c) {
    if (c < num_b) {
      const float2 l = sl[b * num_b + c];
      rr = fmaf(l.x, x[c].x, rr);
      ii = fmaf(l.y, x[c].y, ii);
      ri = fmaf(l.x, x[c].y, ri);
      ir = fmaf(l.y, x[c].x, ir);
    }
  }
  float yr = rr - ii, yi = ri + ir;
  for (int k = 0; k < s.num_k; ++k) {
    const float2 a = s.dv[k * num_v + v], c = s.pb[k * num_g + g];
    const float2 st = s.st[k * num_b + b];
    const float orr = a.x * c.x - a.y * c.y, oi = a.x * c.y + a.y * c.x;
    yr += st.x * orr - st.y * oi;
    yi += st.x * oi + st.y * orr;
  }
  return make_float2(yr, yi);
}

// The pair maps' destination: column 0 of pair 0's interior in K2's padded
// qvg layout (row stride ld, plane stride plane), or none.
struct Maps {
  float* m;
  long long ld, plane;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ mtr, const T* __restrict__ mti,
           const float2* __restrict__ lmat, int num_b, int num_v, int num_g,
           Signal s, int round_out, Maps maps, float2* __restrict__ out) {
  __shared__ float2 sl[kMaxB * kMaxB];
  for (int i = threadIdx.x; i < num_b * num_b; i += blockDim.x) sl[i] = lmat[i];
  __syncthreads();
  const long long pg = (long long)num_v * num_g;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pg;
       i += stride) {
    float2 x[kMaxB];
#pragma unroll
    for (int c = 0; c < kMaxB; ++c)
      x[c] = c < num_b ? make_float2(Num<T>::f32(mtr[c * pg + i]),
                                     Num<T>::f32(mti[c * pg + i]))
                       : make_float2(0.f, 0.f);
    const int v = (int)(i / num_g), g = (int)(i - (long long)v * num_g);
    float* m =
        maps.m == nullptr ? nullptr : maps.m + (long long)v * maps.ld + g;
    float prev = 0.f;
    for (int b = 0; b < num_b; ++b) {
      float2 y = mix_out(sl, num_b, b, x, v, g, num_v, num_g, s);
      if (m != nullptr) {
        const float mag = __fsqrt_rn(
            __fadd_rn(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)));
        if (b > 0) m[(long long)(b - 1) * maps.plane] = __fadd_rn(prev, mag);
        prev = mag;
      }
      if (round_out) {
        y.x = rnd<__nv_bfloat16>(y.x);
        y.y = rnd<__nv_bfloat16>(y.y);
      }
      out[b * pg + i] = y;
    }
  }
}

template <typename T>
int launch_mix(const void* mtr, const void* mti, const void* lmat, int num_b,
               int num_v, int num_g, Signal s, int round_out, Maps maps,
               void* out, cudaStream_t st) {
  long long blocks = ((long long)num_v * num_g + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  mix_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(mtr), static_cast<const T*>(mti),
      static_cast<const float2*>(lmat), num_b, num_v, num_g, s, round_out,
      maps, static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

Signal make_signal(const void* dv, const void* pb, const void* st, int num_k) {
  return Signal{static_cast<const float2*>(dv), static_cast<const float2*>(pb),
                static_cast<const float2*>(st), num_k};
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The bf16 schedules' mix: out [B, V, G] complex64 = L mt (+ sum_k st[k,b]
// dv[k,v] pb[k,g]) of the bf16 planes mtr, mti [B, V, G]; with round_out
// the output values are rounded to bf16; with maps (not null) also the
// pair maps of the unrounded map at maps[q * plane + v * ld + g].
int rv_mix(const void* mtr, const void* mti, const void* lmat, int num_b,
           int num_v, int num_g, const void* dv, const void* pb,
           const void* st_, int num_k, int round_out, void* maps,
           long long ld, long long plane, void* out, void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  return launch_mix<__nv_bfloat16>(
      mtr, mti, lmat, num_b, num_v, num_g, make_signal(dv, pb, st_, num_k),
      round_out, Maps{static_cast<float*>(maps), ld, plane}, out,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
"""

# the same bytes with no arithmetic: every bf16 plane pair read once, the
# complex64 map written once (two cells a thread, as the new mix)
COPY_SOURCE = r"""
#include <cuda_runtime.h>

namespace {
__global__ void copy_kernel(const unsigned* __restrict__ mtr,
                            const unsigned* __restrict__ mti, int num_b,
                            int pairs, float4* __restrict__ out) {
  const int p = blockIdx.x * 256 + threadIdx.x;
  if (p >= pairs) return;
  for (int b = 0; b < num_b; ++b) {
    const unsigned u = __ldcs(mtr + b * pairs + p);
    const unsigned w = __ldcs(mti + b * pairs + p);
    out[b * pairs + p] = make_float4(__uint_as_float(u << 16),
                                     __uint_as_float(w << 16),
                                     __uint_as_float(u & 0xffff0000u),
                                     __uint_as_float(w & 0xffff0000u));
  }
}
}  // namespace

extern "C" int rv_copy(const void* mtr, const void* mti, int num_b,
                       int pairs, void* out, void* stream) {
  copy_kernel<<<(pairs + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const unsigned*)mtr, (const unsigned*)mti, num_b, pairs,
      (float4*)out);
  return (int)cudaGetLastError();
}
"""

# copies of the new source, timing only: (text, replacement)
NEVER = "if (__float_as_uint(y[0].x) == 0x7fc00001u) "
NO_STORE = (("  Run<R>::store(o, y);", "  " + NEVER + "Run<R>::store(o, y);"),
            ("    if (b > 0) Run<R>::store(m + (b - 1) * plane, pair);",
             "    if (b > 0 && __float_as_uint(pair[0]) == 0x7fc00001u) "
             "Run<R>::store(m + (b - 1) * plane, pair);"))
NO_LOAD = ((
    "      Run<R>::widen(Run<R>::fetch(mtr + c * pg + i), xr[c]);\n"
    "      Run<R>::widen(Run<R>::fetch(mti + c * pg + i), xi[c]);",
    "      Run<R>::widen((i * 2654435761u + c * 40503u) & 0x3fffffffu, "
    "xr[c]);\n"
    "      Run<R>::widen((i * 40503u + c * 2654435761u) & 0x3fffffffu, "
    "xi[c]);"),)
NEW_CUTS = {
    "run1": (("constexpr int kRun = 2, kSigRun = 1, kHeldRun = 2;",
              "constexpr int kRun = 1, kSigRun = 1, kHeldRun = 1;"),),
    "no_store": NO_STORE, "no_load": NO_LOAD, "compute": NO_STORE + NO_LOAD,
}

# (K, pair maps, bf16 output) of each timed variant
TIMED = {"no_signal": (0, False, False), "noise_bf16_out": (0, False, True),
         "k2": (2, False, False), "k2_maps": (2, True, False),
         "k40": (40, False, False), "k40_maps": (40, True, False)}
CHECKED = [(k, m, r) for k in (0, 2, 40) for m in (False, True)
           for r in (False, True)]


build_logs: dict = {}        # name -> nvcc's output (ptxas -v)


def _flags() -> list:
    from radar_tpu_torch import _build

    return _build._COMMON + _build._EXTRA["rdm_variants"]


def start_build(sources: dict) -> dict:
    """Start one nvcc a source (name -> text) with the mix's flags into
    ``BUILD_DIR``, each library named by a hash of its text and flags (an
    unchanged one is reused); finish with ``finish_build``."""
    from radar_tpu_torch import _build

    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name, src in sources.items():
        digest = hashlib.sha256((" ".join(_flags()) + src).encode())
        so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
        proc = None
        if not os.path.exists(so):
            cu = os.path.join(BUILD_DIR, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(src)
            proc = subprocess.Popen(
                [_build._nvcc(), *_flags(), "-o", f"{so}.{os.getpid()}.tmp",
                 cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        started[name] = (so, proc)
    return started


def finish_build(started: dict) -> dict:
    """Wait for ``start_build``'s compilers; name -> loaded library (the
    mix's entry ``rv_mix`` typed as the port's; ``rv_copy`` where built).
    Raises with nvcc's output if a build failed."""
    from radar_tpu_torch import _build

    failed = []
    for name, (so, proc) in started.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}:\n{log}")
        else:
            os.replace(f"{so}.{os.getpid()}.tmp", so)
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {}
    for name, (so, _) in started.items():
        lib = ctypes.CDLL(so)
        if hasattr(lib, "rv_mix"):
            lib.rv_mix.argtypes = _build._SIGNATURES["rdm_variants"]["rv_mix"]
            lib.rv_mix.restype = ctypes.c_int
        if hasattr(lib, "rv_copy"):
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.rv_copy.argtypes = [P, P, I, I, P, P]
            lib.rv_copy.restype = ctypes.c_int
        if hasattr(lib, "radar_error_string"):
            lib.radar_error_string.argtypes = [ctypes.c_int]
            lib.radar_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def start_old_build() -> dict:
    """Start the build of the old mix (``OLD_SOURCE``)."""
    return start_build({"old": OLD_SOURCE})


def build_old() -> ctypes.CDLL:
    """The old mix's library, built if needed."""
    return finish_build(start_old_build())["old"]


def run_mix(lib, mtr, mti, lmat, signal=None, *, round_out: bool = False,
            emit_maps: bool = False):
    """(map, maps or None) of the library ``lib``'s ``rv_mix`` (the old
    copy's, or any build's) on the card, as ``ops/noise_rdm.py::mix``
    computes them."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    num_b, num_v, num_g = mtr.shape
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=mtr.device)
    maps = (nr.maps_buffer(num_b - 1, num_v, num_g, mtr.device)
            if emit_maps else None)
    args, _keep = nr.mix_args(mtr, mti, lmat, signal, round_out, out, maps)
    rc = lib.rv_mix(*args)
    if rc != 0:
        raise RuntimeError(f"rv_mix: CUDA error {rc} "
                           f"({lib.radar_error_string(rc).decode()})")
    return out, maps


def random_targets(n: int, seed: int):
    """``n`` targets spread over the perf configuration's scene (numpy
    seed)."""
    import numpy as np

    from radar_tpu_torch.sim.scenario import TargetBatch

    rng = np.random.default_rng(seed)
    return TargetBatch.make(rng.uniform(1000.0, 15000.0, n),
                            rng.uniform(-30.0, 30.0, n),
                            rng.uniform(-20.0, 20.0, n),
                            rng.uniform(0.0, 20.0, n))


def full_inputs(device, seed: int = 19, lr=None):
    """The perf configuration's L (rounded to bf16 values), random bf16
    planes [13, 332, 3404] and the signal factors of K = 0, 2 (the
    benchmark's two targets) and 40 (``random_targets``); ``lr``: the perf
    configuration's rank-K stages, if built already."""
    import torch

    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.sim.scenario import TargetBatch
    from radar_tpu_torch.waveform.precompute import precompute

    if lr is None:
        cfg = perf_config()
        lr = make_lowrank_stages(cfg, precompute(cfg), device=device)
    num_b, num_v, num_g = (lr.l_factor.shape[0], lr.rplan.n_dop,
                           lr.rplan.n_gates)
    gen = torch.Generator(device=device).manual_seed(seed)
    planes = [torch.randn((num_b, num_v, num_g), generator=gen,
                          device=device).to(torch.bfloat16)
              for _ in range(2)]
    signals = {0: None,
               2: lr.signal_factors(TargetBatch.make(
                   [3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                   [10.0, 15.0])),
               40: lr.signal_factors(random_targets(40, seed))}
    return (*planes, nr.round_mul(lr.l_factor, torch.bfloat16).contiguous(),
            signals)


def bound(num_b: int, num_v: int, num_g: int, num_k: int, maps: bool,
          sm_max_mhz: float, sms: int) -> dict:
    """The variant's bytes and FP32 operations, their least times (ms) and
    which bounds it."""
    cells = num_v * num_g
    nbytes = (2 * num_b * cells * 2 + num_b * cells * 8
              + (num_b - 1) * cells * 4 * maps
              + num_k * (num_v + num_g + num_b) * 8)
    ops = cells * (4 * num_b * num_b + 2 * num_b
                   + num_k * (6 + 8 * num_b) + 5 * num_b * maps)
    bytes_ms = nbytes / PEAK_HBM * 1e3
    ops_ms = ops / (sms * LANES_PER_SM * sm_max_mhz * 1e6) * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def sm_max_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def busy_ms(fn, reps: int) -> float:
    """CUDA-event ms a call of ``reps`` calls of ``fn`` behind a sleep
    kernel (device time)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(fns: dict, reps: int, rounds: int) -> dict:
    """Median ms a call of each of ``fns`` (name -> call), run in turns
    (forwards, then backwards) ``rounds`` times after a warm-up."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order + order[::-1]:
            times[name].append(busy_ms(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def time_variants(libs: dict, mtr, mti, lmat, signals: dict,
                  variants: dict = TIMED, reps: int = 20,
                  rounds: int = 3) -> dict:
    """Each variant's ms a call for every library of ``libs`` (name ->
    library with ``rv_mix``), in turns, on the same inputs and buffers."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    num_b, num_v, num_g = mtr.shape
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=mtr.device)
    maps = nr.maps_buffer(num_b - 1, num_v, num_g, mtr.device)
    res = {}
    for label, (k, with_maps, round_out) in variants.items():
        args, keep = nr.mix_args(mtr, mti, lmat, signals[k], round_out,
                                 out, maps if with_maps else None)
        fns = {name: (lambda lib=lib: lib.rv_mix(*args))
               for name, lib in libs.items()}
        res[label] = in_turns(fns, reps, rounds)
        del keep
    return res


def bit_checks(old_lib, mtr, mti, lmat, signals: dict) -> dict:
    """Whether the port's ``mix`` equals the old mix bit for bit (map and
    maps) in each variant of ``CHECKED``."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    same = {}
    for k, with_maps, round_out in CHECKED:
        new, new_maps = nr.mix(mtr, mti, lmat, signals[k],
                               round_out=round_out, emit_maps=with_maps)
        old, old_maps = run_mix(old_lib, mtr, mti, lmat, signals[k],
                                round_out=round_out, emit_maps=with_maps)
        torch.cuda.synchronize()
        same[f"k{k}{'_maps' if with_maps else ''}"
             f"{'_bf16_out' if round_out else ''}"] = bool(
            torch.equal(new, old) and (not with_maps
                                       or torch.equal(new_maps, old_maps)))
    return same


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_mix: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from radar_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(_build._CSRC, "rdm_variants.cu")) as f:
        new_src = f.read()
    sources = {"old": OLD_SOURCE, "copy": COPY_SOURCE}
    for name, cuts in NEW_CUTS.items():
        src = new_src
        for a, b in cuts:
            if src.count(a) != 1:
                raise RuntimeError(f"rdm_variants.cu no longer has the text "
                                   f"{name} changes: {a!r}")
            src = src.replace(a, b)
        sources[name] = src
    started = start_build(sources)
    _build.build_all(["rdm_variants"])
    libs = finish_build(started)
    libs["new"] = _build.load("rdm_variants")
    dev = torch.device("cuda")
    mtr, mti, lmat, signals = full_inputs(dev)
    num_b, num_v, num_g = mtr.shape
    same = bit_checks(libs["old"], mtr, mti, lmat, signals)
    timed = time_variants({n: libs[n] for n in ("old", "new", *NEW_CUTS)},
                          mtr, mti, lmat, signals, reps=args.reps,
                          rounds=args.rounds)
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pairs = num_v * num_g // 2
    copy_ms = in_turns({"copy": lambda: libs["copy"].rv_copy(
        mtr.data_ptr(), mti.data_ptr(), num_b, pairs, out.data_ptr(),
        stream)}, args.reps, args.rounds)["copy"]
    copy_bytes = 2 * num_b * num_v * num_g * 2 + num_b * num_v * num_g * 8
    mhz = sm_max_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = {}
    for label, (k, with_maps, _) in TIMED.items():
        bd = bound(num_b, num_v, num_g, k, with_maps, mhz, sms)
        t = timed[label]
        variants[label] = {
            **{f"{n}_ms": t[n] for n in t}, **bd,
            "new_bytes_per_s": bd["bytes"] / (t["new"] * 1e-3),
            "old_bytes_per_s": bd["bytes"] / (t["old"] * 1e-3),
            "new_share_of_bound": bd["bound_ms"] / t["new"],
            "old_share_of_bound": bd["bound_ms"] / t["old"],
            "new_over_old": t["new"] / t["old"]}
    ok = all(same.values())
    print(json.dumps({
        "card": smi, "shape": [num_b, num_v, num_g], "sm_max_mhz": mhz,
        "sms": sms, "ms_is": f"CUDA events around {args.reps} launches "
        f"behind a sleep kernel, median of {args.rounds} rounds in turns",
        "bit_for_bit_new_vs_old": same, "variants": variants,
        "copy_ms": copy_ms, "copy_bytes": copy_bytes,
        "copy_bytes_per_s": copy_bytes / (copy_ms * 1e-3),
        "ptxas": [ln.strip() for info in [_build.build_info.get(
            "rdm_variants", {})] for ln in info.get("log", "").splitlines()
            if "Used" in ln or "spill" in ln]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
