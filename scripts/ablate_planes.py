"""What holds K1c, and K1c before and after its redesign: ablations of
``planes_kernel`` (``radar_tpu_torch/csrc/noise_rdm.cu``, the port's
``gen_noise_planes``, draw mode's white planes) on one NVIDIA GPU, at the
perf configuration's full plan (13 beams x 332 pulses, three segments,
20.4 M complex samples; 163.5 MB written in f32, 81.8 MB in bf16 rows).

    python3 scripts/ablate_planes.py [--rounds 3]

Builds into ``build/ablate_planes/`` (one nvcc a source, all at once):

- ``old``: K1c before its redesign (``OLD_SOURCE``, kept only here): one
  Philox4x32-10 block a sample, words 0 and 1 kept (counter (n, p, b,
  seg)), a warp a row, a segment a ``blockIdx.y``. Its stream is not the
  port's: it is held against its own plain version (``old_planes_plain``).
- ``new``: the shipped source, two samples a block (all four words), a
  persistent grid over every segment's rows.
- ``*_compute``: copies of either with the stores cut (``COMPUTE_CUTS``):
  each 16-byte vector is XORed into one word a thread, written once at the
  thread's end, so the draws stay alive and the bytes go.
- ``new_no_philox``: the shipped source with the Philox rounds replaced by
  a multiply and XORs of the counter (the stores and the grid alone).
- ``new_tight_edges``: the shipped source with its edge items only the
  vectors that hold a masked sample (``TIGHT_EDGE_CUTS``), where the
  shipped one takes whole 128-byte lines.
- ``new_split`` (and ``new_split_compute``): the shipped source with each
  Philox product's high word an IMAD.HI on a multiplier in constant memory
  and its low word an IMAD (``SPLIT_PHILOX``), where the shipped one takes
  both words from one IMAD.WIDE.U32.
- ``probe``: ``PROBE_SOURCE``, chains of one instruction each (IMAD.WIDE.U32,
  IMAD.HI.U32, IMAD, I2FP.F32.U32, F2FP.BF16.F32.PACK_AB) on every SM, each
  block's SM and ``clock64`` stamps recorded: each instruction's rate in
  lanes an SM and clock, free of the clock the SM ran at.

Each copy runs ``gen_noise_planes`` in turns (forwards, then backwards)
with the others and with ``torch.rand`` of the same values; the times are
CUDA events around one call with the card kept busy by a sleep kernel
ahead (device time; median over the rounds of the median of 10 calls).
The SASS of each loop is read by ``chip_smoke.py::_loop_sass`` (cuobjdump)
and costed at the probe's rates. The ablated copies compute wrong values
(timing only); ``old`` and ``new`` are checked bit for bit against their
plain versions first. Prints one JSON line with the card's name and power
limit. Needs the CUDA toolkit and a card; imports no JAX.
``chip_smoke.py`` (phase ``k1_bf16``) builds the same copies through
``start_build``/``finish_build`` and times old and new through
``k1c_turns``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)

BUILD_DIR = os.path.join(_ROOT, "build", "ablate_planes")
SLEEP_CYCLES = 4_000_000

# K1c before its redesign (the port's csrc/noise_rdm.cu until then): one
# Philox block a complex sample, words 0 and 1 of it; a warp a row, each
# lane 16 bytes of consecutive samples a step, a segment a blockIdx.y.
OLD_SOURCE = r"""#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// K1c: the per-segment white planes [B, P, xlen] that draw mode draws
// (same Philox counters, key and rails; zeros before pad_front), every
// segment in one launch: blockIdx.y is the segment, each warp one (beam,
// pulse) row, each lane kVec consecutive samples a step (16 bytes of T),
// stored with one 16-byte store to each plane when every row length is a
// multiple of kVec (kAligned; the plan's rows are 128-sample multiples, and
// bf16 rows are padded to 8), one value at a time otherwise. The samples
// before pad_front and the pad columns from xlen to ld are drawn too and
// masked to zeros (at most a few percent of a row): the loop body stays
// one straight run of kVec Philox blocks without branches, so the SASS
// count of its integer instructions is the work of a sample.
constexpr int kMaxSeg = 4;

struct PlaneSeg {
  long long off_r, off_i;   // offsets of the planes in `out`, in T's
  int pad_front, xlen;
  int ld;                   // a row's values: xlen, or in bf16 xlen -> 8
};

struct PlaneTable {
  PlaneSeg seg[kMaxSeg];
};

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const PlaneTable t, uint2 key, float scale, int num_p,
              int rows, T* __restrict__ out) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const unsigned seg = blockIdx.y;
  PlaneSeg g = t.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i)
    if (seg == i) g = t.seg[i];
  const unsigned b = (unsigned)row / (unsigned)num_p;
  const unsigned p = (unsigned)row - b * (unsigned)num_p;
  T* xr = out + g.off_r + (long long)row * g.ld;
  T* xi = out + g.off_i + (long long)row * g.ld;
  for (int n0 = (threadIdx.x & 31) * kVec; n0 < g.ld; n0 += 32 * kVec) {
    float vr[kVec], vi[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint4 w = philox4x32_10(
          make_uint4((unsigned)(n0 + k), p, b, seg), key);
      // zero before pad_front and from xlen on by a mask, not a branch
      // (+0.0, as plain)
      const unsigned keep =
          n0 + k >= g.pad_front && n0 + k < g.xlen ? ~0u : 0u;
      vr[k] = __uint_as_float(__float_as_uint(uniform_rail(w.x, scale)) &
                              keep);
      vi[k] = __uint_as_float(__float_as_uint(uniform_rail(w.y, scale)) &
                              keep);
    }
    if constexpr (sizeof(T) == 2) {
      // bf16 rows (always aligned): nearest even, two values a word
      __stcs(reinterpret_cast<uint4*>(xr + n0),
             make_uint4(bf16_pair(vr[0], vr[1]), bf16_pair(vr[2], vr[3]),
                        bf16_pair(vr[4], vr[5]), bf16_pair(vr[6], vr[7])));
      __stcs(reinterpret_cast<uint4*>(xi + n0),
             make_uint4(bf16_pair(vi[0], vi[1]), bf16_pair(vi[2], vi[3]),
                        bf16_pair(vi[4], vi[5]), bf16_pair(vi[6], vi[7])));
    } else if (kAligned) {
      // streaming stores: the planes are written once and read later
      __stcs(reinterpret_cast<float4*>(xr + n0),
             make_float4(vr[0], vr[1], vr[2], vr[3]));
      __stcs(reinterpret_cast<float4*>(xi + n0),
             make_float4(vi[0], vi[1], vi[2], vi[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (n0 + k < g.xlen) {
          xr[n0 + k] = vr[k];
          xi[n0 + k] = vi[k];
        }
    }
  }
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1c: every segment's draw-mode planes in one launch. table holds, per
// segment, pad_front, xlen and the offsets of its re and im planes
// [num_b, num_p, ld] in `out` (in values of the output type: f32, or bf16
// with `bf16`; multiples of 4 f32 or 8 bf16; out 16-byte aligned). ld is
// xlen in f32 and xlen rounded up to 8 in bf16 (its pad columns zero).
int k1c_planes(const long long* table, int n_seg, unsigned s0, unsigned s1,
               float scale, int num_b, int num_p, int bf16, void* out,
               void* stream) {
  const long long rows = (long long)num_b * num_p;
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int vec = bf16 ? 8 : 4;
  PlaneTable t = {};
  bool aligned = true;
  for (int s = 0; s < n_seg; ++s) {
    const long long* e = table + 4 * s;
    if (e[1] < 1 || e[1] >= (1LL << 30) || e[2] % vec || e[3] % vec)
      return (int)cudaErrorInvalidValue;
    const int ld = bf16 ? (int)((e[1] + 7) / 8 * 8) : (int)e[1];
    t.seg[s] = {e[2], e[3], (int)e[0], (int)e[1], ld};
    aligned = aligned && ld % vec == 0;
  }
  const dim3 grid((unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                  n_seg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    planes_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, st>>>(
        t, make_uint2(s0, s1), scale, num_p, (int)rows,
        static_cast<__nv_bfloat16*>(out));
  } else {
    auto kernel = aligned ? planes_kernel<float, true>
                          : planes_kernel<float, false>;
    kernel<<<grid, kThreads, 0, st>>>(t, make_uint2(s0, s1), scale, num_p,
                                      (int)rows, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
"""

# a 16-byte vector into the thread's word instead of into memory; the word
# is written once, when the thread ends (Sink's destructor)
SINK = """
struct Sink {
  unsigned v;
  unsigned* at;
  __device__ ~Sink() { *at = v; }
};
__device__ __forceinline__ void sink_store(Sink& s, uint4 x) {
  s.v ^= x.x ^ x.y ^ x.z ^ x.w;
}
__device__ __forceinline__ void sink_store(Sink& s, float4 x) {
  s.v ^= __float_as_uint(x.x) ^ __float_as_uint(x.y) ^
         __float_as_uint(x.z) ^ __float_as_uint(x.w);
}

"""
_KERNEL = "template <typename T, bool kAligned>\n__global__"
_STORE_VEC = "// An item's kVec samples of each plane at xr, xi"
_VEC = "  constexpr int kVec = 16 / (int)sizeof(T);\n"
_SINK_AT = (_VEC + "  Sink sink{0u, reinterpret_cast<unsigned*>(out) + "
            "((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + "
            "threadIdx.x};\n")
# (text, replacement, occurrences) of each source's compute-only copy
COMPUTE_CUTS = {
    "old": [(_KERNEL, SINK + _KERNEL, 1), (_VEC, _SINK_AT, 1),
            ("__stcs(reinterpret_cast<uint4*>(xr + n0),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<uint4*>(xi + n0),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<float4*>(xr + n0),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<float4*>(xi + n0),", "sink_store(sink,", 1)],
    "new": [(_STORE_VEC, SINK + _STORE_VEC, 1), (_VEC, _SINK_AT, 1),
            ("void store_vec(T* xr,", "void store_vec(Sink& sink, T* xr,", 1),
            ("store_vec<T, kAligned>(out", "store_vec<T, kAligned>(sink, out",
             2),
            ("__stcs(reinterpret_cast<uint4*>(xr),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<uint4*>(xi),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<float4*>(xr),", "sink_store(sink,", 1),
            ("__stcs(reinterpret_cast<float4*>(xi),", "sink_store(sink,", 1)],
}
NO_PHILOX_CUT = (
    "      philox_lanes(m, (unsigned)p, (unsigned)b, (unsigned)seg, key, w);\n",
    "#pragma unroll\n      for (int j = 0; j < kBlocks; ++j)\n"
    "        w[j] = make_uint4((m[j] * 2654435761u) ^ (unsigned)p,\n"
    "                          ((unsigned)b * 40503u) ^ key.x, m[j] ^ key.y,\n"
    "                          (unsigned)p ^ (unsigned)seg);\n", 1)

# Philox with each product's high word from a multiplier in constant memory
# (an IMAD.HI) and its low word from the immediate (an IMAD): the compiler
# cannot fuse them into one IMAD.WIDE.U32
SPLIT_PHILOX = """
__constant__ unsigned kPhiloxMulHi[2] = {0xD2511F53u, 0xCD9E8D57u};

template <int kLanes>
__device__ __forceinline__ void philox_lanes_split(
    const unsigned (&m)[kLanes], unsigned p, unsigned b, unsigned seg,
    uint2 k, uint4 (&w)[kLanes]) {
  unsigned c0[kLanes], c1[kLanes], c2[kLanes], c3[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    c0[i] = m[i];
    c1[i] = p;
    c2[i] = b;
    c3[i] = seg;
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const unsigned lo0 = 0xD2511F53u * c0[i];
      const unsigned hi0 = __umulhi(kPhiloxMulHi[0], c0[i]);
      const unsigned lo1 = 0xCD9E8D57u * c2[i];
      const unsigned hi1 = __umulhi(kPhiloxMulHi[1], c2[i]);
      c0[i] = hi1 ^ c1[i] ^ k.x;
      c1[i] = lo1;
      c2[i] = hi0 ^ c3[i] ^ k.y;
      c3[i] = lo0;
    }
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) w[i] = make_uint4(c0[i], c1[i], c2[i], c3[i]);
}

"""
_CALL = "      philox_lanes(m, (unsigned)p, (unsigned)b, (unsigned)seg, key, w);\n"
# the edge items only the vectors that hold a masked sample, not whole
# 128-byte lines: a line at a row's start written partly by each loop
TIGHT_EDGE_CUTS = [
    ("    const int c_lo = (int)((e[0] + 8 * vec - 1) / (8 * vec)) * 8;\n",
     "    const int c_lo = (int)((e[0] + vec - 1) / vec);\n", 1),
    ("    const int c_hi = (int)(e[1] / (8 * vec)) * 8;\n",
     "    const int c_hi = (int)(e[1] / vec);\n", 1)]
SPLIT_CUTS = [(_KERNEL, SPLIT_PHILOX + _KERNEL, 1),
              (_CALL, _CALL.replace("philox_lanes(", "philox_lanes_split("), 1)]
# chains of one instruction on every SM; k1c_probe(op, ...): op 0
# IMAD.WIDE.U32 (mul.wide.u32, each step on the last one's high word), 1 IMAD.HI.U32 (mad.hi.u32), 2 IMAD
# (mad.lo.u32), 3 I2FP.F32.U32 (cvt.rn.f32.u32), 4 F2FP.BF16.F32.PACK_AB
# (cvt.rn.bf16x2.f32), 5 a 32x32->64 product as IMAD.HI.U32 + IMAD
# (the two words apart, joined by a XOR); kChains independent chains a
# thread, kUnroll steps
# of each a loop pass; thread 0 of each block stamps its SM and clock64 at
# the start and the end (after a barrier)
PROBE_OPS = ("IMAD.WIDE", "IMAD.HI", "IMAD", "I2FP", "F2FP", "HI+LO")
PROBE_CHAINS, PROBE_UNROLL = 8, 16
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kChains = %d, kUnroll = %d;
// a multiplier the compiler cannot see equals the immediate one, so it
// keeps a product's high and low words as two instructions
__constant__ unsigned kMulHi = 0xD2511F53u;

template <int kOp>
__global__ void __launch_bounds__(kThreads)
probe_kernel(unsigned k, int iters, unsigned* sink, long long* stamps) {
  unsigned long long x[kChains];
  unsigned y[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    x[i] = threadIdx.x * 0x9E3779B97F4A7C15ull + i;
    y[i] = threadIdx.x * 0x85EBCA6Bu + i;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        if (kOp == 0) {   // through the high word: the whole product
          asm volatile("mul.wide.u32 %%0, %%1, %%2;"
                       : "=l"(x[i]) : "r"((unsigned)(x[i] >> 32)), "r"(k));
        } else if (kOp == 1) {
          asm volatile("mad.hi.u32 %%0, %%0, %%1, %%0;" : "+r"(y[i]) : "r"(k));
        } else if (kOp == 2) {
          asm volatile("mad.lo.u32 %%0, %%0, %%1, %%0;" : "+r"(y[i]) : "r"(k));
        } else if (kOp == 3) {
          float f;
          asm volatile("cvt.rn.f32.u32 %%0, %%1;" : "=f"(f) : "r"(y[i]));
          y[i] = __float_as_uint(f);
        } else if (kOp == 4) {
          unsigned d;
          asm volatile("cvt.rn.bf16x2.f32 %%0, %%1, %%2;"
                       : "=r"(d) : "f"(__uint_as_float(y[i])),
                         "f"(__uint_as_float(k)));
          y[i] = d;
        } else {          // a product's two words apart: IMAD.HI + IMAD
          const unsigned hi = __umulhi(y[i], kMulHi);
          y[i] = hi ^ (y[i] * 0xD2511F53u);
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc ^= (unsigned)x[i] ^ y[i];
  sink[blockIdx.x * kThreads + threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(smid));
    stamps[3 * blockIdx.x] = smid;
    stamps[3 * blockIdx.x + 1] = t0;
    stamps[3 * blockIdx.x + 2] = t1;
  }
}

template <int kOp>
int launch(unsigned k, int iters, void* sink, void* stamps, int max_blocks,
           int* blocks, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel<kOp>,
                                                kThreads, 0);
  *blocks = sms * per_sm;
  if (*blocks < 1 || *blocks > max_blocks) return (int)cudaErrorInvalidValue;
  probe_kernel<kOp><<<*blocks, kThreads, 0, st>>>(
      k, iters, static_cast<unsigned*>(sink), static_cast<long long*>(stamps));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int k1c_probe(int op, unsigned k, int iters, void* sink, void* stamps,
              int max_blocks, int* blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch<0>(k, iters, sink, stamps, max_blocks, blocks, st);
    case 1: return launch<1>(k, iters, sink, stamps, max_blocks, blocks, st);
    case 2: return launch<2>(k, iters, sink, stamps, max_blocks, blocks, st);
    case 3: return launch<3>(k, iters, sink, stamps, max_blocks, blocks, st);
    case 4: return launch<4>(k, iters, sink, stamps, max_blocks, blocks, st);
    case 5: return launch<5>(k, iters, sink, stamps, max_blocks, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
""" % (PROBE_CHAINS, PROBE_UNROLL)

# the SASS name of each copy's K1c instance (cuobjdump's mangled names)
SASS_NAMES = {"bf16": "planes_kernelI13__nv_bfloat16Lb1E",
              "f32": "planes_kernelIfLb1E"}

build_logs: dict = {}        # name -> nvcc's output (ptxas -v)


def _cut(src: str, cuts) -> str:
    for old, new, n in cuts:
        if src.count(old) != n:
            raise RuntimeError(f"the kernel no longer has the text to cut: "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def sources() -> dict:
    """name -> CUDA source of every copy this script builds."""
    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "noise_rdm.cu")) as f:
        new = f.read()
    return {"old": OLD_SOURCE,
            "old_compute": _cut(OLD_SOURCE, COMPUTE_CUTS["old"]),
            "new_compute": _cut(new, COMPUTE_CUTS["new"]),
            "new_no_philox": _cut(new, [NO_PHILOX_CUT]),
            "new_tight_edges": _cut(new, TIGHT_EDGE_CUTS),
            "new_split": _cut(new, SPLIT_CUTS),
            "new_split_compute": _cut(_cut(new, SPLIT_CUTS),
                                      COMPUTE_CUTS["new"]),
            "probe": PROBE_SOURCE}


def _flags() -> list:
    from radar_tpu_torch import _build

    return [*_build._COMMON, *_build._EXTRA["noise_rdm"], "-I", _build._CSRC]


def start_build() -> dict:
    """Start one nvcc a copy (``sources``) with K1c's flags into
    ``BUILD_DIR``, each library named by a hash of its text and flags (an
    unchanged one is reused); finish with ``finish_build``."""
    from radar_tpu_torch import _build

    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    with open(os.path.join(_build._CSRC, "philox.cuh")) as f:
        header = f.read()
    for name, src in sources().items():
        digest = hashlib.sha256((" ".join(_flags()) + header + src).encode())
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
    """Wait for ``start_build``'s compilers; name -> (loaded library, its
    path), K1c's entry ``k1c_planes`` typed as the port's. Raises with
    nvcc's output if a build failed."""
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
        if hasattr(lib, "k1c_planes"):
            lib.k1c_planes.argtypes = _build._SIGNATURES["noise_rdm"][
                "k1c_planes"]
            lib.k1c_planes.restype = ctypes.c_int
        if hasattr(lib, "k1c_probe"):
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.k1c_probe.argtypes = [I, ctypes.c_uint, I, P, P, I, P, P]
            lib.k1c_probe.restype = ctypes.c_int
        lib.radar_error_string.argtypes = [ctypes.c_int]
        lib.radar_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, so)
    return libs


def chip_smoke():
    """The module ``chip_smoke.py`` of this checkout (its SASS reader)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_rates(lib, iters: int = 200) -> dict:
    """Each ``PROBE_OPS`` instruction's rate, lanes an SM and clock: on
    each SM the lanes it ran (its blocks' threads x iters x chains x
    unroll) over the clocks from its first block's start to its last
    block's end; the median over the SMs, with the least and the most."""
    import torch

    out = {}
    max_blocks = 4096
    sink = torch.empty(max_blocks * 256, dtype=torch.int32, device="cuda")
    stamps = torch.zeros(3 * max_blocks, dtype=torch.int64, device="cuda")
    blocks = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    for op, name in enumerate(PROBE_OPS):
        for _ in range(2):          # the first call warms up
            rc = lib.k1c_probe(op, 0x9E3779B9, iters, sink.data_ptr(),
                               stamps.data_ptr(), max_blocks,
                               ctypes.byref(blocks), stream)
            if rc != 0:
                raise RuntimeError(f"k1c_probe: CUDA error {rc} "
                                   f"({lib.radar_error_string(rc).decode()})")
        torch.cuda.synchronize()
        st = stamps[:3 * blocks.value].view(-1, 3).cpu().tolist()
        per_sm = {}
        for sm, t0, t1 in st:
            lo, hi, n = per_sm.get(sm, (t0, t1, 0))
            per_sm[sm] = (min(lo, t0), max(hi, t1), n + 1)
        lanes = 256 * iters * PROBE_CHAINS * PROBE_UNROLL
        rates = sorted(n * lanes / (hi - lo) for lo, hi, n in per_sm.values())
        out[name] = {"per_sm_clock": statistics.median(rates),
                     "least": rates[0], "most": rates[-1],
                     "sms": len(rates), "blocks": blocks.value}
    return out


def probe_sass(lib_path: str) -> dict:
    """Each probe instance's loop SASS (opcode counts a pass), to show the
    chain is the one instruction."""
    cs = chip_smoke()
    return {name: cs._loop_sass(lib_path, f"probe_kernelILi{op}E",
                                samples=1)["ops"]
            for op, name in enumerate(PROBE_OPS)}


def old_planes_plain(plan, seed, num_b: int, *, device):
    """The old K1c's planes (f32): one Philox block a sample, counter (n,
    p, b, seg), words 0 and 1 (the stream before the redesign)."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    i64 = torch.int64
    p = torch.arange(plan.n_pulses, dtype=i64, device=device)[None, :, None]
    b = torch.arange(num_b, dtype=i64, device=device)[:, None, None]
    out = []
    for si, seg in enumerate(plan.segments):
        n = torch.arange(seg.xlen, dtype=i64, device=device)[None, None, :]
        w0, w1, _, _ = nr.philox4x32_10(
            n, p, b, torch.full((), si, dtype=i64, device=device), *seed)
        keep = n >= seg.pad_front
        zero = torch.zeros((), dtype=torch.float32, device=device)
        out.append((torch.where(keep, nr._uniform_rail(w0), zero),
                    torch.where(keep, nr._uniform_rail(w1), zero)))
    return out


def swapped(lib, fn):
    """``fn`` with ``lib`` as the port's noise_rdm library for its call."""
    from radar_tpu_torch import _build

    def call():
        keep = _build._libs.get("noise_rdm")
        _build._libs["noise_rdm"] = lib
        try:
            return fn()
        finally:
            if keep is None:
                _build._libs.pop("noise_rdm")
            else:
                _build._libs["noise_rdm"] = keep
    return call


def busy_ms(fn, reps: int = 10) -> tuple:
    """(median CUDA-event ms, median host ms) of one call of ``fn``, each
    behind a sleep kernel (device time; the host's time to return from the
    call, the card still busy)."""
    import time

    import torch

    ts, hs = [], []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        hs.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), statistics.median(hs)


def idle_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event ms of one call of ``fn`` on an idle card (the
    host's launch inside the events)."""
    import torch

    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def in_turns(fns: dict, rounds: int = 3) -> dict:
    """name -> {busy, idle, host} ms: the median over ``rounds`` rounds of
    each of ``fns`` (name -> call), run in turns (forwards, then backwards)
    after a warm-up."""
    for fn in fns.values():
        fn()
    times = {name: {"busy": [], "idle": [], "host": []} for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            busy, host = busy_ms(fns[name])
            times[name]["busy"].append(busy)
            times[name]["host"].append(host)
            times[name]["idle"].append(idle_ms(fns[name]))
    return {name: {k: statistics.median(v) for k, v in t.items()}
            for name, t in times.items()}


def k1c_calls(libs: dict, plan, seed, num_b: int, dtype) -> dict:
    """name -> call of K1c at ``dtype`` for the shipped library (``new``)
    and each of ``libs`` (name -> (library, path)) swapped in, and
    ``torch.rand`` of the same values (``rand``)."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    gen = lambda: nr.gen_noise_planes(plan, seed, num_b, device="cuda",
                                      dtype=dtype)
    values = 2 * sum(num_b * plan.n_pulses * nr.k1c_row_len(sg.xlen, dtype)
                     for sg in plan.segments)
    calls = {"new": gen}
    calls.update({name: swapped(lib, gen) for name, (lib, _) in libs.items()})
    calls["rand"] = lambda: torch.rand(values, device="cuda", dtype=dtype)
    return calls


def k1c_turns(libs: dict, plan, seed, num_b: int, dtype,
              rounds: int = 3) -> dict:
    """K1c (new, and each of ``libs`` swapped in) and ``torch.rand`` of
    the same values at ``dtype``, in turns: name -> {busy, idle, host}
    ms."""
    return in_turns(k1c_calls(libs, plan, seed, num_b, dtype), rounds)


def old_matches_plain(old_lib, plan, seed, num_b: int) -> dict:
    """The old K1c's f32 planes and bf16 rows against ``old_planes_plain``
    (rounded for bf16), bit for bit, per segment."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    want = old_planes_plain(plan, seed, num_b, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = swapped(old_lib, lambda: nr.gen_noise_planes(
            plan, seed, num_b, device="cuda", dtype=dtype))()
        out[str(dtype)[6:]] = [bool(torch.equal(a, c.to(dtype))
                                    and torch.equal(b, d.to(dtype)))
                               for (a, b), (c, d) in zip(got, want)]
    return out


def loop_sass(libs: dict, rates: dict) -> dict:
    """Each K1c copy's loop SASS at each dtype (``chip_smoke._loop_sass``:
    instructions a sample per pipe, the clocks a sample at the probe's
    ``rates``), the shipped library's as ``new``."""
    from radar_tpu_torch import _build

    cs = chip_smoke()
    cs.IMAD_RATES.update({k: v["per_sm_clock"] for k, v in rates.items()})
    paths = {"new": _build._library_path("noise_rdm")[1],
             **{n: p for n, (_, p) in libs.items() if n != "probe"}}
    out = {}
    for name, path in paths.items():
        for dt, kernel in SASS_NAMES.items():
            # the loop of the 16-byte stores; in a copy without them, the
            # loop of the Philox rounds' XORs (the edge loop has one block)
            compute = name.endswith("_compute")
            out[f"{name}_{dt}"] = cs._loop_sass(
                path, kernel, per_store=4 if dt == "bf16" else 2,
                innermost=not compute, loop_with="LOP3" if compute else None,
                samples=(8 if dt == "bf16" else 4) if compute else None)
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
    started = start_build()
    _build.build_all(["noise_rdm"])
    libs = finish_build(started)
    probe = libs.pop("probe")
    rates = probe_rates(probe[0])

    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device="cuda")
    plan, num_b = lr.rplan, lr.l_factor.shape[0]
    seed = (3, 5)
    new_same = {}
    want = nr.philox_planes(plan, seed, num_b, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        got = nr.gen_noise_planes(plan, seed, num_b, device="cuda",
                                  dtype=dtype)
        new_same[str(dtype)[6:]] = [
            bool(torch.equal(a, c.to(dtype)) and torch.equal(b, d.to(dtype)))
            for (a, b), (c, d) in zip(got, want)]
    del want, got
    old_same = old_matches_plain(libs["old"][0], plan, seed, num_b)
    samples = sum(num_b * plan.n_pulses * sg.xlen for sg in plan.segments)
    times = {str(dt)[6:]: k1c_turns(libs, plan, seed, num_b, dt, args.rounds)
             for dt in (torch.bfloat16, torch.float32)}
    print(json.dumps({"card": card, "samples": samples,
                      "bytes": {"f32": 8 * samples, "bf16": 4 * samples},
                      "new_equals_philox_planes": new_same,
                      "old_equals_old_plain": old_same,
                      "probe_rates_per_sm_clock": rates,
                      "probe_sass": probe_sass(probe[1]),
                      "loop_sass": loop_sass(libs, rates),
                      "ptxas": {name: [ln.split(":", 1)[-1].strip()
                                       for ln in log.splitlines()
                                       if "Used" in ln or "spill" in ln]
                                for name, log in [
                                    ("new", _build.build_info.get(
                                        "noise_rdm", {}).get("log", "")),
                                    *build_logs.items()]},
                      "ms": times}))
    ok = all(all(v) for v in (*new_same.values(), *old_same.values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
