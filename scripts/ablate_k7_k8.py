"""K7's bf16 draw-mode PC and K8's f32 PC before and after their move onto
the strip GEMMs, on one NVIDIA GPU at full size (one JSON line).

    python3 scripts/ablate_k7_k8.py [--reps 10]

``new`` is the port: ``noise_rdm(plan, L, seed=, stacked=True,
mul_dtype=torch.bfloat16)`` (K7's draw mode: the strip GEMM of
``csrc/band_pc_sm90.cu`` whose two producer warpgroups draw the data's
stages, then the wgmma DFT GEMM and the mix) and
``pulse_compress_noise(z, plan, mul_dtype=torch.float32)`` (K8 at f32: the
staging kernel's f32 planes, then K1's 3xTF32 strip GEMM with both passes
in one launch, ``k8_pc_kernel`` of ``csrc/noise_rdm_sm90.cu``). ``old`` is
what they ran before, kept only here (``OLD_HELPERS`` and ``OLD_PC``,
appended to a copy of ``radar_tpu_torch/csrc/rdm_variants.cu`` built into
``build/ablate_k7_k8/``): ``band_pc_tc_kernel`` (mma.sync m16n8k16, 64 x 64
tiles, the draws made in synchronous scalar loads, a launch a segment)
before the same DFT GEMM and mix, and ``band_pc_kernel`` (the CUDA cores,
4 x 4 register tiles, a launch a segment). ``OLD_HELPERS`` (the CUDA-core
and mma.sync GEMM helpers) also serves the old kernels of
``ablate_f32_schedules.py``, ``ablate_k4_k9.py`` and ``ablate_k3_k10.py``.

Copies of band_pc_sm90.cu with a part of the drawing producer changed
(``DRAW_VARIANTS``; the last two are timing only, their maps wrong by
design) are
swapped in for the port's library: ``lanes_8`` (eight Philox chains a
thread at once instead of four), ``one_drawing_warpgroup`` (128 drawing
threads, 384 in the block, no ``setmaxnreg``), ``trap_in_loop`` (the
bounded wait's trap inside its loop: ptxas then spills the consumers'
accumulators), ``no_draw`` (the producers store nothing: the MMAs and the
barriers alone) and ``no_philox`` (a multiply and a xor in place of
Philox's ten rounds).

Each route is held against its plain version (RMS of the difference over
the RMS), the new draw mode and its variants (but the two timing-only ones) also
against K7's bf16 planes mode on K1c's planes (bit for bit). Then old and new are timed in turns (old, new, new,
old) with CUDA events on a card kept busy by a sleep kernel and on an idle
one, with the host's ms a call, and split by torch.profiler's kernel
names; each draw-mode copy with ptxas's register and spill lines for its
kernel.

Prints the card's name and power limit in the line. Needs the CUDA toolkit
and a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ablate_k1 import _compile, _load, _profile  # noqa: E402
from ablate_k4_k9 import _rel_rms, in_turns, swapped  # noqa: E402

# The CUDA-core and mma.sync GEMM helpers of the first K7-K10 kernels,
# appended after a copy of csrc/rdm_variants.cu (its kThreads)
OLD_HELPERS = r"""
#include "philox.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;   // GEMM block tile

// The four real accumulators of a kTM x kTN register tile of a complex
// product: rr = sum ar*br, ii = sum ai*bi, ri = sum ar*bi, ir = sum ai*br.
template <int kTM, int kTN>
struct Acc {
  float rr[kTM][kTN], ii[kTM][kTN], ri[kTM][kTN], ir[kTM][kTN];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) rr[i][j] = ii[i][j] = ri[i][j] = ir[i][j] = 0.f;
  }
  // one kBK-deep step from shared A [kBK][lda] (rows ty + 16 i) and B
  // [kBK][ldb] (columns tx + 16 j)
  __device__ __forceinline__ void step(const float* ar, const float* ai, int lda,
                                       const float* br, const float* bi, int ldb,
                                       int tx, int ty) {
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float xr[kTM], xi[kTM], yr[kTN], yi[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        xr[i] = ar[kk * lda + ty + 16 * i];
        xi[i] = ai[kk * lda + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        yr[j] = br[kk * ldb + tx + 16 * j];
        yi[j] = bi[kk * ldb + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          rr[i][j] = fmaf(xr[i], yr[j], rr[i][j]);
          ii[i][j] = fmaf(xi[i], yi[j], ii[i][j]);
          ri[i][j] = fmaf(xr[i], yi[j], ri[i][j]);
          ir[i][j] = fmaf(xi[i], yr[j], ir[i][j]);
        }
    }
  }
};


// K7's draw-mode PC at bf16 runs on the tensor cores: mma.sync
// m16n8k16, bf16 x bf16 products (exact) accumulated in f32, the MXU's
// arithmetic. A block computes a 64 x 64 complex tile with 8 warps, each a
// 32 x 16 tile as 2 x 2 m16n8 fragments, each with the four real
// accumulators of the stacked product (rr, ii, ri, ir). Operands are
// staged in shared memory as bf16, k contiguous, rows padded to 40
// elements (20 words: the fragment loads of a warp hit 32 banks).
constexpr int kTK = 32;           // k depth of a staged step
constexpr int kLdk = kTK + 8;     // shared row stride, bf16 elements

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct TcAcc {
  float rr[2][2][4], ii[2][2][4], ri[2][2][4], ir[2][2][4];
};

// The 64 x 64 complex tile over k in [k_lo, k_hi): load_a(m, k) and
// load_b(k, n) give block-local rows m / columns n as float2 (T values);
// beyond k_hi the operands are 0.
template <typename LoadA, typename LoadB>
__device__ __forceinline__ void tc_gemm(int k_lo, int k_hi, LoadA load_a,
                                        LoadB load_b, TcAcc& c) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kBM * kLdk];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBN * kLdk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c.rr[mi][ni][e] = c.ii[mi][ni][e] = c.ri[mi][ni][e] = c.ir[mi][ni][e] = 0.f;
  auto ld32 = [](const __nv_bfloat16* s, int row, int col) {
    return *reinterpret_cast<const uint32_t*>(s + row * kLdk + col);
  };
  for (int k0 = k_lo; k0 < k_hi; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < (kBM * kTK) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int m = e / kTK, kk = e % kTK;
      const float2 v = k0 + kk < k_hi ? load_a(m, k0 + kk) : make_float2(0.f, 0.f);
      sa[0][m * kLdk + kk] = __float2bfloat16_rn(v.x);
      sa[1][m * kLdk + kk] = __float2bfloat16_rn(v.y);
    }
#pragma unroll
    for (int i = 0; i < (kBN * kTK) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int kk = e / kBN, n = e % kBN;
      const float2 v = k0 + kk < k_hi ? load_b(k0 + kk, n) : make_float2(0.f, 0.f);
      sb[0][n * kLdk + kk] = __float2bfloat16_rn(v.x);
      sb[1][n * kLdk + kk] = __float2bfloat16_rn(v.y);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t xr[2][4], xi[2][4], yr[2][2], yi[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        const int col = kk + 2 * q;
        xr[mi][0] = ld32(sa[0], r, col);
        xr[mi][1] = ld32(sa[0], r + 8, col);
        xr[mi][2] = ld32(sa[0], r, col + 8);
        xr[mi][3] = ld32(sa[0], r + 8, col + 8);
        xi[mi][0] = ld32(sa[1], r, col);
        xi[mi][1] = ld32(sa[1], r + 8, col);
        xi[mi][2] = ld32(sa[1], r, col + 8);
        xi[mi][3] = ld32(sa[1], r + 8, col + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = wn + ni * 8 + g;
        const int col = kk + 2 * q;
        yr[ni][0] = ld32(sb[0], n, col);
        yr[ni][1] = ld32(sb[0], n, col + 8);
        yi[ni][0] = ld32(sb[1], n, col);
        yi[ni][1] = ld32(sb[1], n, col + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          mma_bf16(c.rr[mi][ni], xr[mi], yr[ni]);
          mma_bf16(c.ii[mi][ni], xi[mi], yi[ni]);
          mma_bf16(c.ri[mi][ni], xr[mi], yi[ni]);
          mma_bf16(c.ir[mi][ni], xi[mi], yr[ni]);
        }
    }
    __syncthreads();
  }
}

// store(m, n, re, im) for every element of this thread's fragments
// (block-local row m, column n), re = rr - ii, im = ri + ir.
template <typename Store>
__device__ __forceinline__ void tc_store(const TcAcc& c, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(wm + mi * 16 + g + (e >> 1) * 8, wn + ni * 8 + 2 * q + (e & 1),
              c.rr[mi][ni][e] - c.ii[mi][ni][e], c.ri[mi][ni][e] + c.ir[mi][ni][e]);
}

}  // namespace
"""

# K8's f32 PC on the CUDA cores and K7's bf16 draw-mode PC on mma.sync, as
# they ran before the strip GEMMs took them; appended after OLD_HELPERS
OLD_PC = r"""
namespace {

enum Src { kCompact = 1, kDraw = 2 };

struct PcArgs {
  const float2* z;       // kCompact: complex64 [B, P, x_len] (s_compact)
  long long x_len;
  int c0, r_len, pad_front;     // compact slice; zero causal history
  unsigned seg;                 // kDraw: Philox counter word 3
  uint2 key;
  float scale;
  const float* mr;       // banded filter planes [window, tile], T values
  const float* mi;
  int window, tile, lh;
  int num_p, j_len, g0, num_g;
  void* outr;            // kDraw: rounded bf16 planes [B, P, num_g]
  void* outi;
  float2* out;           // kCompact: complex64 [B, P, num_g] (K8)
};

// Sample n of the segment buffer of (beam b, pulse p) as T values.
template <typename T, int kSrc>
__device__ __forceinline__ float2 load_sample(const PcArgs& a, int b, int p,
                                              int n) {
  const long long row = (long long)b * a.num_p + p;
  if (kSrc == kCompact) {
    if (n < a.pad_front || n >= a.pad_front + a.r_len) return make_float2(0.f, 0.f);
    const float2 v = a.z[row * a.x_len + a.c0 + (n - a.pad_front)];
    return make_float2(rnd<T>(v.x), rnd<T>(v.y));
  }
  if (n < a.pad_front) return make_float2(0.f, 0.f);
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)n, (unsigned)p, (unsigned)b, a.seg), a.key);
  return make_float2(rnd<T>(uniform_rail(w.x, a.scale)),
                     rnd<T>(uniform_rail(w.y, a.scale)));
}

// One 64-pulse x 64-gate block of K8's f32 PC of beam blockIdx.z on the
// compact cube: the stacked product of the window of its tile with the
// columns n0 .. n0+63 of M, over M's rows n0 .. n0+63+lh-2 only (the rest
// of those columns is 0), complex64 out. bf16 runs band_pc_sm90.cu.
__global__ void __launch_bounds__(kThreads) band_pc_kernel(PcArgs a) {
  __shared__ float ar_s[kBK * (kBM + 1)], ai_s[kBK * (kBM + 1)];
  __shared__ float br_s[kBK * kBN], bi_s[kBK * kBN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int per_tile = a.tile / kBN;
  const int t = blockIdx.x / per_tile;
  const int n0 = (blockIdx.x - t * per_tile) * kBN;
  const int col0 = t * a.tile;              // window start in the buffer
  const int k_hi = min(a.window, n0 + kBN + a.lh - 1);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  Acc<4, 4> acc;
  acc.zero();
  for (int k0 = n0; k0 < k_hi; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int m = e / kBK, kk = e % kBK;
      const int p = m0 + m, k = k0 + kk;
      float2 v = make_float2(0.f, 0.f);
      if (p < a.num_p && k < k_hi) v = load_sample<float, kCompact>(a, b, p, col0 + k);
      ar_s[kk * (kBM + 1) + m] = v.x;
      ai_s[kk * (kBM + 1) + m] = v.y;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int kk = e / kBN, n = e % kBN;
      const int k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (k < k_hi) {
        vr = a.mr[(long long)k * a.tile + n0 + n];
        vi = a.mi[(long long)k * a.tile + n0 + n];
      }
      br_s[kk * kBN + n] = vr;
      bi_s[kk * kBN + n] = vi;
    }
    __syncthreads();
    acc.step(ar_s, ai_s, kBM + 1, br_s, bi_s, kBN, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty + 16 * i;
    if (p >= a.num_p) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jg = col0 + n0 + tx + 16 * j;
      if (jg >= a.j_len) continue;
      const long long off = ((long long)b * a.num_p + p) * a.num_g + a.g0 + jg;
      a.out[off] = make_float2(acc.rr[i][j] - acc.ii[i][j],
                               acc.ri[i][j] + acc.ir[i][j]);
    }
  }
}

// K7's draw-mode PC at bf16: a 64-pulse x 64-gate block of beam
// blockIdx.z as band_pc_kernel's, its samples drawn (K1's Philox keying)
// and its products on the tensor cores, rounded bf16 planes out.
__global__ void __launch_bounds__(kThreads) band_pc_tc_kernel(PcArgs a) {
  using T = __nv_bfloat16;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int per_tile = a.tile / kBN;
  const int t = blockIdx.x / per_tile;
  const int n0 = (blockIdx.x - t * per_tile) * kBN;
  const int col0 = t * a.tile;
  TcAcc acc;
  tc_gemm(
      n0, min(a.window, n0 + kBN + a.lh - 1),
      [&](int m, int k) {
        return m0 + m < a.num_p ? load_sample<T, kDraw>(a, b, m0 + m, col0 + k)
                                : make_float2(0.f, 0.f);
      },
      [&](int k, int n) {
        const long long off = (long long)k * a.tile + n0 + n;
        return make_float2(a.mr[off], a.mi[off]);
      },
      acc);
  tc_store(acc, [&](int m, int n, float cr, float ci) {
    const int p = m0 + m, jg = col0 + n0 + n;
    if (p >= a.num_p || jg >= a.j_len) return;
    const long long off = ((long long)b * a.num_p + p) * a.num_g + a.g0 + jg;
    static_cast<T*>(a.outr)[off] = __float2bfloat16_rn(cr);
    static_cast<T*>(a.outi)[off] = __float2bfloat16_rn(ci);
  });
}


// K7's draw mode at bf16 on the tensor cores, K8 at f32 (the compact
// cube) on the CUDA cores
int launch_band_pc(int src, const PcArgs& a, int num_b, cudaStream_t st) {
  const dim3 grid(((a.j_len + a.tile - 1) / a.tile) * (a.tile / kBN),
                  (a.num_p + kBM - 1) / kBM, num_b);
  if (src == kDraw)
    band_pc_tc_kernel<<<grid, kThreads, 0, st>>>(a);
  else if (src == kCompact)
    band_pc_kernel<<<grid, kThreads, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Banded PC of one segment, src 1 or 2. src 1 (K8, f32): the compact
// complex64 cube z [B, P, x_len], segment slice c0 .. c0+r_len after
// pad_front zeros -> complex64 out [B, P, num_g] at gate offset g0. src 2
// (K7's draw mode, bf16): Philox draws (K1's counters, key (s0, s1),
// segment index seg, zeros before pad_front) rounded to bf16 -> rounded
// bf16 planes outr, outi [B, P, num_g] at g0. mr, mi: the banded filter
// [window, tile] as f32 (holding bf16 values for src 2).
extern "C" int rv_band_pc(int src, const void* z, long long x_len, int c0, int r_len,
               int pad_front, int seg, unsigned s0, unsigned s1, float scale,
               const void* mr, const void* mi, int window, int tile, int lh,
               int num_b, int num_p, int j_len, int g0, int num_g, void* outr,
               void* outi, void* out, void* stream) {
  if (tile % kBN != 0 ||
      !(src == kCompact ? z != nullptr && out != nullptr
                        : src == kDraw && outr != nullptr && outi != nullptr))
    return (int)cudaErrorInvalidValue;
  PcArgs a{static_cast<const float2*>(z), x_len, c0, r_len, pad_front,
           (unsigned)seg, make_uint2(s0, s1), scale,
           static_cast<const float*>(mr), static_cast<const float*>(mi),
           window, tile, lh, num_p, j_len, g0, num_g, outr, outi,
           static_cast<float2*>(out)};
  return launch_band_pc(src, a, num_b, static_cast<cudaStream_t>(stream));
}
"""

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F, _LL = ctypes.c_float, ctypes.c_longlong
OLD_SIGNATURE = [_I, _P, _LL, _I, _I, _I, _I, _U, _U, _F, _P, _P, _I, _I, _I,
                 _I, _I, _I, _I, _I, _P, _P, _P, _P]

# copies of band_pc_sm90.cu with a part of the drawing producer changed:
# (old, new) text pairs
DRAW_VARIANTS = {
    # Philox chains a drawing thread runs at once: 8 (one call a chunk)
    "lanes_8": (("constexpr int kDrawLanes = 4; ",
                 "constexpr int kDrawLanes = 8; "),),
    # one drawing warpgroup, no setmaxnreg (384 threads: 168 registers each)
    "one_drawing_warpgroup": (
        ("constexpr int kDrawers = 256;", "constexpr int kDrawers = 128;"),
        ("    if constexpr (kDraw) setmaxnreg_dec<kProducerRegs>();\n", ""),
        ("  if constexpr (kDraw) setmaxnreg_inc<kConsumerRegs>();\n", "")),
    # the bounded wait's trap inside its loop, as before (ptxas spills the
    # consumers' accumulators)
    "trap_in_loop": ((
        "  for (;;) {\n    if (mbar_try_wait(bar, parity)) return;\n"
        "    if (now_ns() - t0 > kTimeoutNs) break;\n  }\n  __trap();\n",
        "  while (!mbar_try_wait(bar, parity))\n"
        "    if (now_ns() - t0 > kTimeoutNs) __trap();\n"),),
    "no_draw": ((
        "        draw_stage(smem_raw + (base - raw), t, m0, b0, p0, "
        "j0 + kt * kBK, sg, a);\n", ""),),
    "no_philox": ((
        "        philox_lanes(n, (unsigned)p, (unsigned)b, (unsigned)sg.seg_id, "
        "a.key, w0,\n                     w1);\n",
        "        for (int e = 0; e < kDrawLanes; ++e) {\n"
        "          w0[e] = n[e] * 2654435761u;\n"
        "          w1[e] = w0[e] ^ (unsigned)p;\n        }\n"),),
}
TIMING_ONLY = ("no_draw", "no_philox")   # their maps are wrong by design


def build(build_dir: str) -> ctypes.CDLL:
    """The copy of rdm_variants.cu with OLD_HELPERS and OLD_PC appended,
    built and loaded."""
    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "rdm_variants.cu")) as f:
        so = _compile({"old_pc": f.read() + OLD_HELPERS + OLD_PC},
                      build_dir)["old_pc"]
    lib = _load(so, "rdm_variants")
    lib.rv_band_pc.argtypes = OLD_SIGNATURE
    lib.rv_band_pc.restype = ctypes.c_int
    return lib


def draw_ptxas(log: str) -> list:
    """ptxas's register and spill lines for the draw-mode strip GEMM
    (``strip_pc_kernel<true>``) in an nvcc log."""
    out, cur = [], ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
        if "strip_pc_kernelILb1E" in cur and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


def build_draw_variants(build_dir: str) -> dict:
    """The DRAW_VARIANTS copies of csrc/band_pc_sm90.cu, built with the
    port's flags (one nvcc each, all at once) and loaded: name ->
    (library, ptxas's lines for the draw-mode strip GEMM)."""
    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "band_pc_sm90.cu")) as f:
        full = f.read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for var, cuts in DRAW_VARIANTS.items():
        src = full
        for old, new in cuts:
            if src.count(old) != 1:
                raise RuntimeError(f"band_pc_sm90.cu no longer has the text "
                                   f"{var} changes: {old[:60]!r}")
            src = src.replace(old, new)
        cu = os.path.join(build_dir, f"band_pc_{var}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(build_dir, f"libband_pc_{var}.so")
        procs[var] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, "-I", _build._CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for var, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {var}:\n{log}")
        out[var] = (_load(so, "band_pc_sm90"), draw_ptxas(log))
    return out


def old_k7_draw(lib, plan, lmat, seed):
    """The old K7 draw mode at bf16 (what ``noise_rdm._variant_bf16`` ran):
    ``band_pc_tc_kernel`` a launch a segment on the plan's banded filter
    rounded to bf16 (its planes made once here, as the plan kept them),
    then the port's DFT GEMM and mix; a call of it."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    mps = [torch.stack([m.real, m.imag]).contiguous() for m in
           (nr.round_mul(s.mp, bf) for s in plan.segments)]
    rv = _build.load("rdm_variants")
    l16 = nr.round_mul(lmat, bf).contiguous()

    def call():
        dev = lmat.device
        num_b, num_p = lmat.shape[0], plan.n_pulses
        num_v, num_g = plan.n_dop, plan.n_gates
        ld = -(-num_g // 8) * 8
        pcr = torch.empty((num_b, num_p, ld), dtype=bf, device=dev)
        pci = torch.empty_like(pcr)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for si, seg in enumerate(plan.segments):
            _build.check(lib, lib.rv_band_pc(
                2, None, 0, 0, 0, seg.pad_front, si, seed[0], seed[1],
                ctypes.c_float(nr.U_SCALE), mps[si][0].data_ptr(),
                mps[si][1].data_ptr(), seg.window, seg.tile,
                seg.taps.shape[0], num_b, num_p, seg.j_len, seg.g0, ld,
                pcr.data_ptr(), pci.data_ptr(), None, stream), "rv_band_pc")
        mtr = torch.empty((num_b, num_v, num_g), dtype=bf, device=dev)
        mti = torch.empty_like(mtr)
        nr.dft(plan, pcr, pci, num_g, mtr, mti)
        out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                          device=dev)
        _build.check(rv, rv.rv_mix(mtr.data_ptr(), mti.data_ptr(),
                                   l16.data_ptr(), num_b, num_v, num_g, None,
                                   None, None, 0, 0, out.data_ptr(), stream),
                     "rv_mix")
        return out

    return call


def old_k8_f32(lib, z, pplan):
    """The old K8 at f32: ``band_pc_kernel`` on the compact cube, a launch
    a segment; a call of it."""
    import torch

    from radar_tpu_torch import _build

    num_b, num_p, s_c = z.shape

    def call():
        out = torch.empty((num_b, num_p, pplan.n_gates),
                          dtype=torch.complex64, device=z.device)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        g0 = 0
        for seg in pplan.segments:
            _build.check(lib, lib.rv_band_pc(
                1, z.data_ptr(), s_c, seg.c0, seg.r_len, seg.pad_front, 0, 0,
                0, ctypes.c_float(0.0), seg.mr.data_ptr(), seg.mi.data_ptr(),
                seg.window, seg.tile, seg.taps, num_b, num_p, seg.j_len, g0,
                pplan.n_gates, None, None, out.data_ptr(), stream),
                "rv_band_pc")
            g0 += seg.j_len
        return out

    return call


# the profiler's split: kernel-name fragments of each part
SPLIT = (("pc_old_mma_sync", "band_pc_tc_kernel"),
         ("pc_old_cuda_cores", "band_pc_kernel"),
         ("pc_strip_gemm_drawn", "strip_pc_kernel<true>"),
         ("stage", "stage_kernel"), ("pc_3xtf32", "k8_pc_kernel"),
         ("dft_gemm", "dft_kernel"), ("mix", "::mix_kernel<"))


def _split(prof: dict) -> dict:
    """The profiler's ms a call by part; the rest as ``other``."""
    out = {}
    for part, key in SPLIT:
        ms = sum(v for k, v in prof.items() if key in k)
        if ms > 0.0:
            out[part] = ms
    out["other"] = sum(prof.values()) - sum(out.values())
    return out


def measure(lib, variants, plan, lmat, pplan, z, seed, reps: int) -> dict:
    """Old and new K7 draw mode (bf16) and K8 (f32): holds, then times in
    turns with the profiler's split; the draw-mode variants beside the
    shipped draw mode."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.studies import pallas_pc as ppc

    bf, f32 = torch.bfloat16, torch.float32
    num_b = lmat.shape[0]
    k7 = {"old": old_k7_draw(lib, plan, lmat, seed),
          "new": lambda: nr.noise_rdm(plan, lmat, seed=seed, stacked=True,
                                      mul_dtype=bf, layout="bvg")}
    k8 = {"old": old_k8_f32(lib, z, pplan),
          "new": lambda: ppc.pulse_compress_noise(z, pplan, mul_dtype=f32)}
    planes = nr.gen_noise_planes(plan, seed, num_b, device=lmat.device)
    ref7 = nr.noise_rdm_plain(plan, lmat, planes, mul_dtype=bf)
    fed = nr.noise_rdm(plan, lmat, planes=planes, variant="stacked",
                       mul_dtype=bf, layout="bvg")
    ref8 = ppc.pulse_compress_noise_plain(z, pplan, f32)
    var = {"shipped": k7["new"],
           **{k: swapped("band_pc_sm90", vlib, k7["new"])
              for k, (vlib, _) in variants.items()}}
    res = {"holds": {
        "k7_draw_bf16_vs_plain": {r: _rel_rms(fn(), ref7)
                                  for r, fn in k7.items()},
        "k7_draw_equals_planes_mode": {
            k: bool(torch.equal(fn(), fed)) for k, fn in var.items()
            if k not in TIMING_ONLY},
        "k8_f32_vs_plain": {r: _rel_rms(fn(), ref8) for r, fn in k8.items()},
        "tol": "K7 bf16 <=3e-4, K8 f32 <=1e-5 (rms rel)"}}
    del ref7, fed, ref8, planes
    for name, calls in (("k7_draw_bf16", k7), ("k8_f32", k8)):
        t = in_turns(calls, reps)
        for r, fn in calls.items():
            t[r]["profile_ms"] = _split(_profile(fn, reps=3))
        res[name] = t
    t = in_turns(var, max(3, reps // 2))
    from radar_tpu_torch import _build

    ptxas = {"shipped": draw_ptxas(_build.build_info["band_pc_sm90"]["log"]),
             **{k: lines for k, (_, lines) in variants.items()}}
    for k, fn in var.items():
        t[k]["profile_ms"] = _split(_profile(fn, reps=3))
        t[k]["ptxas"] = ptxas[k]
    res["k7_draw_variants"] = t
    return res


def main() -> int:
    import numpy as np
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import full_config, perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.studies import pallas_pc as ppc
    from radar_tpu_torch.waveform.precompute import precompute

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k7_k8: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["noise_rdm", "noise_rdm_sm90", "rdm_variants",
                      "rdm_sm90", "band_pc_sm90"])
    bdir = os.path.join(os.path.dirname(_build.BUILD_DIR), "ablate_k7_k8")
    lib = build(bdir)
    variants = build_draw_variants(bdir)
    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device="cuda")
    ref_cfg = full_config()
    pplan = ppc.make_pallas_pc_plan(precompute(ref_cfg), device="cuda")
    num_b, num_p = ref_cfg.sig.beam_num, ref_cfg.sig.prt_num
    g = torch.Generator(device="cuda").manual_seed(5)
    z = torch.complex(*(torch.randn((num_b, num_p, pplan.s_compact),
                                    generator=g, device="cuda")
                        for _ in range(2))) * float(np.sqrt(0.5))
    res = {"card": card, **measure(lib, variants, lr.rplan, lr.l_factor,
                                   pplan, z, nr.seed_words(4242),
                                   args.reps)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
