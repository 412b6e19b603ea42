"""K4 and K9's bf16 tail before and after their redesign for Hopper, on
one NVIDIA GPU at the perf config's full shape (13 beams, 332 pulses, 3404
gates, filters of 35/200/700 taps; one JSON line).

    python3 scripts/ablate_k4_k9.py [--reps 10]

K4 (``noise_rdm(seed=, rolling=False, beams_per_step=k)``, noise only):
``old`` is the first K4, kept only here (``OLD_K4``, appended to a copy of
``radar_tpu_torch/csrc/noise_rdm.cu`` built into ``build/ablate_k4_k9/``):
per segment ``pc_window_kernel`` on the CUDA cores in f32 (the drawn window
staged in shared memory, a register-window convolution, the block's beams
mixed in it when k = B), then ``k1_mix`` (k < B) and the tiled DFT
``k1_mtd``. ``new`` is the port's K4 (``csrc/noise_rdm_sm90.cu``: K1's
3xTF32 strip GEMM with the data's stage drawn in the block by a producer
warpgroup, then K1's mix and DFT GEMM). Both run through ``noise_rdm`` (the
old one in place of ``_k4_cuda``) at k = 13 and k = 1, in turns (old, new,
new, old), timed with CUDA events on an idle card and on one kept busy by
a sleep kernel, with the host's ms a call and torch.profiler's split; each
is held against the plain version (RMS of the difference over the RMS).

K9 at bf16 (a compact white cube holding K1c's planes): ``old`` is the
CUDA-core tail (``mtd_mix_kernel<__nv_bfloat16>``, reachable only here
through ``OLD_K9``, appended with ``scripts/ablate_f32_schedules.py``'s
``OLD_F32``, which keeps the kernel, to a copy of
``csrc/rdm_variants.cu`` with ``ablate_k7_k8.py``'s ``OLD_HELPERS``) after
the strip GEMM's PC, as K9 ran before; ``new`` the port's
``noise_rdm_compact(variant="allbeams", mul_dtype=bf16)`` (the strip GEMM,
then K7's wgmma DFT GEMM and mix). Then the tails alone on the same pc
planes, in turns, each held against the plain tail within 3e-4 RMS: the
old one, the port's (``port_dft_and_mix``) and the fused kernel this
redesign tried (``FUSED``: every beam's rounded DFT tile kept in shared
memory and mixed there, the map written once; kept only here, appended
with ablate_k3_k10's ``CLUSTER`` to a copy of ``csrc/rdm_sm90.cu``) with
its copies (``K9_VARIANTS``): ``cluster_2`` and ``cluster_3`` (clusters
of CTAs on adjacent Doppler tiles sharing each pc stage by TMA
multicast), ``streamed_d`` (D's k step loaded with every stage instead of
kept resident, as the fused tail runs beyond 416 pulses at 13 beams);
and, timing only, ``no_mix`` (no mix, no output), ``no_store`` (the mix
without its stores) and ``no_mma`` (no wgmmas).

Where K4's time goes: copies of ``csrc/noise_rdm_sm90.cu`` with a part
of the drawing producer changed (``K4_VARIANTS``), each swapped in for the
port's library and timed at 1 beam a block in turns with the shipped K4
and with K4 in planes mode (its stages loaded by TMA from K1c's planes):
``no_philox`` (a cheap hash in place of the Philox rounds), ``no_draw``
(no stage written at all), ``warp_arrive`` (one arrive a producer warp
on the full barrier instead of one a thread), ``no_fence`` (no
``fence.proxy.async``), ``sleepy_wait`` (every barrier wait of the source
sleeps 100 ns between polls); ``no_philox``, ``no_draw`` and ``no_fence``
give wrong values by design.

Prints the card's name and power limit in the line. Needs the CUDA toolkit
and a card; imports no JAX.
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

from ablate_k1 import _compile, _events, _load, _profile  # noqa: E402

OLD_K4 = r"""
// The first K4: the window schedule on the CUDA cores in f32.
// pc_window_kernel, once per segment: white noise (Philox draws, or given
// planes) staged in shared memory a window at a time (8 pulse rows x (128 +
// taps - 1) samples, re/im planes padded one word in 32 against bank
// conflicts), each lane sliding a register window over 4 contiguous output
// gates (one shared load feeds 16 FMAs), the beams of a block's window
// streamed through one staged window with their 8 x 128 convolved gates
// kept (8 KB a beam); with k = B the block mixes the beams before it writes
// pc [B, P, G]; then mix_kernel (k < B) in place and mtd_kernel, a 64x64x16
// shared-memory tiled complex GEMM with a 4x4 register tile a thread and
// the rank-K signal in its epilogue. Appended to a copy of noise_rdm.cu
// (kThreads and philox.cuh come from there).
namespace {
constexpr int kTile = 128;    // output gates per PC block (32 lanes x 4)
constexpr int kRows = 8;      // pulse rows per PC block (one warp each)
constexpr int kOuts = 4;      // contiguous output gates per lane
constexpr int kMaxB = 16;     // beams the mix kernel holds in registers

__host__ __device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

// Stages the noise window of beam b for rows p0 .. p0+kRows-1 and buffer
// samples n0 .. n0+wl-1 into shared memory: Philox draws (zero before
// pad_front) in draw mode, the given planes in planes mode.
template <bool kDraw>
__device__ __forceinline__ void stage_window(
    float* sw_r, float* sw_i, int wl, int wlp, int p0, int b, int n0,
    int pad_front, unsigned seg, uint2 key, float scale,
    const float* __restrict__ xr, const float* __restrict__ xi,
    long long x_len, int num_p) {
  for (int idx = threadIdx.x; idx < kRows * wl; idx += kThreads) {
    const int r = idx / wl;
    const int e = idx - r * wl;
    const int p = p0 + r;
    const int n = n0 + e;
    float vr = 0.f, vi = 0.f;
    if (p < num_p) {
      if (kDraw) {
        if (n >= pad_front) {
          const uint4 w = philox4x32_10(
              make_uint4((unsigned)n, (unsigned)p, (unsigned)b, seg), key);
          vr = uniform_rail(w.x, scale);
          vi = uniform_rail(w.y, scale);
        }
      } else {
        const long long off = ((long long)b * num_p + p) * x_len + n;
        vr = xr[off];
        vi = xi[off];
      }
    }
    sw_r[r * wlp + padded(e)] = vr;
    sw_i[r * wlp + padded(e)] = vi;
  }
}

// Causal convolution of one staged row: out[t0+o] = sum_k h[lh-1-k] *
// w[t0+o+k] for the lane's kOuts contiguous gates (th = reversed taps).
__device__ __forceinline__ void conv_row(const float* wr, const float* wi,
                                         const float* th_r, const float* th_i,
                                         int lh, int t0, float (&ar)[kOuts],
                                         float (&ai)[kOuts]) {
  // xr_[o] holds w[t0+k+o]
  float xr_[kOuts], xi_[kOuts];
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    ar[o] = 0.f;
    ai[o] = 0.f;
    xr_[o] = o < kOuts - 1 ? wr[padded(t0 + o)] : 0.f;
    xi_[o] = o < kOuts - 1 ? wi[padded(t0 + o)] : 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < lh; ++k) {
    const int e = t0 + k + kOuts - 1;
    xr_[kOuts - 1] = wr[padded(e)];
    xi_[kOuts - 1] = wi[padded(e)];
    const float hr = th_r[k], hi = th_i[k];
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      ar[o] = fmaf(hr, xr_[o], ar[o]);
      ar[o] = fmaf(-hi, xi_[o], ar[o]);
      ai[o] = fmaf(hr, xi_[o], ai[o]);
      ai[o] = fmaf(hi, xr_[o], ai[o]);
    }
#pragma unroll
    for (int o = 0; o < kOuts - 1; ++o) {
      xr_[o] = xr_[o + 1];
      xi_[o] = xi_[o + 1];
    }
  }
}

__device__ __forceinline__ void load_reversed_taps(const float2* __restrict__ taps,
                                                   int lh, float* th_r,
                                                   float* th_i) {
  for (int k = threadIdx.x; k < lh; k += kThreads) {
    const float2 h = taps[lh - 1 - k];
    th_r[k] = h.x;
    th_i[k] = h.y;
  }
}

// y[b] = sum_c L[b,c] x[c], c ascending, in the order mix_kernel takes.
__device__ __forceinline__ float2 mix_one(const float2* sl, int num_b, int b,
                                          const float2 (&x)[kMaxB]) {
  float yr = 0.f, yi = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxB; ++c) {
    if (c < num_b) {
      const float2 l = sl[b * num_b + c];
      yr = fmaf(l.x, x[c].x, yr);
      yr = fmaf(-l.y, x[c].y, yr);
      yi = fmaf(l.x, x[c].y, yi);
      yi = fmaf(l.y, x[c].x, yi);
    }
  }
  return make_float2(yr, yi);
}

// K4: the window schedule (TPU _make_kernel_gen, rolling=False). One block
// per (gate tile, pulse-row group, window of bps beams) stages each beam of
// its window in turn into the same shared window, convolves it, and keeps
// the un-mixed rows of all bps beams in shared memory. When the window is
// every beam (lmat given), the block applies the beam mix before it writes
// pc, so k1_mix does not run; otherwise it writes the un-mixed rows.
template <bool kDraw>
__global__ void __launch_bounds__(kThreads)
pc_window_kernel(const float2* __restrict__ taps, int lh, int pad_front,
                 int j_len, int g0, unsigned seg, uint2 key, float scale,
                 const float* __restrict__ xr, const float* __restrict__ xi,
                 long long x_len, int num_b, int num_p, int num_g, int bps,
                 const float2* __restrict__ lmat, float2* __restrict__ pc) {
  extern __shared__ float smem[];
  const int wl = kTile + lh - 1;
  const int wlp = padded(wl - 1) + 1;
  float* sw_r = smem;
  float* sw_i = sw_r + kRows * wlp;
  float* th_r = sw_i + kRows * wlp;
  float* th_i = th_r + lh;
  // [bps][kRows][kTile] un-mixed rows, then L; 8-byte aligned
  float2* ob = reinterpret_cast<float2*>(smem + ((2 * kRows * wlp + 2 * lh + 1) & ~1));
  float2* sl = ob + bps * kRows * kTile;

  const int p0 = blockIdx.y * kRows;
  const int b0 = blockIdx.z * bps;
  const int nb = min(bps, num_b - b0);      // beams of this window
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int t0 = (threadIdx.x & 31) * kOuts;

  load_reversed_taps(taps, lh, th_r, th_i);
  if (lmat != nullptr)
    for (int i = threadIdx.x; i < num_b * num_b; i += kThreads) sl[i] = lmat[i];
  for (int ub = 0; ub < nb; ++ub) {
    __syncthreads();                        // the last beam's window is read
    stage_window<kDraw>(sw_r, sw_i, wl, wlp, p0, b0 + ub, n0, pad_front, seg,
                        key, scale, xr, xi, x_len, num_p);
    __syncthreads();
    if (p0 + warp < num_p) {
      float ar[kOuts], ai[kOuts];
      conv_row(sw_r + warp * wlp, sw_i + warp * wlp, th_r, th_i, lh, t0, ar,
               ai);
      float2* orow = ob + (ub * kRows + warp) * kTile + t0;
#pragma unroll
      for (int o = 0; o < kOuts; ++o) orow[o] = make_float2(ar[o], ai[o]);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
    const int r = idx / kTile, t = idx - r * kTile;
    const int p = p0 + r, j = n0 + t;
    if (p >= num_p || j >= j_len) continue;
    const long long off = (long long)p * num_g + g0 + j;
    if (lmat != nullptr) {
      float2 x[kMaxB];
#pragma unroll
      for (int c = 0; c < kMaxB; ++c)
        x[c] = c < num_b ? ob[(c * kRows + r) * kTile + t] : make_float2(0.f, 0.f);
      for (int b = 0; b < num_b; ++b)
        pc[(long long)b * num_p * num_g + off] = mix_one(sl, num_b, b, x);
    } else {
      for (int ub = 0; ub < nb; ++ub)
        pc[(long long)(b0 + ub) * num_p * num_g + off] =
            ob[(ub * kRows + r) * kTile + t];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mix_kernel(float2* __restrict__ pc, const float2* __restrict__ lmat,
           int num_b, long long pg) {
  __shared__ float2 sl[kMaxB * kMaxB];
  for (int i = threadIdx.x; i < num_b * num_b; i += blockDim.x) sl[i] = lmat[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pg;
       i += stride) {
    float2 x[kMaxB];
#pragma unroll
    for (int c = 0; c < kMaxB; ++c)
      x[c] = c < num_b ? pc[c * pg + i] : make_float2(0.f, 0.f);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < num_b) pc[b * pg + i] = mix_one(sl, num_b, b, x);
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void __launch_bounds__(kThreads)
mtd_kernel(const float2* __restrict__ d, const float2* __restrict__ x,
           int num_b, int num_v, int num_p, int num_g,
           const float2* __restrict__ dv, const float2* __restrict__ pb,
           const float2* __restrict__ st, int num_k,
           float2* __restrict__ out) {
  __shared__ float2 as[kBK][kBM + 1];
  __shared__ float2 bs[kBK][kBN];
  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kBM;
  const int g0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float2* xb = x + (long long)b * num_p * num_g;
  const float2 zero = make_float2(0.f, 0.f);
  float accr[4][4], acci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0.f;

  for (int k0 = 0; k0 < num_p; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int m = e / kBK, kk = e % kBK;
      const int v = v0 + m, p = k0 + kk;
      as[kk][m] = (v < num_v && p < num_p) ? d[(long long)v * num_p + p] : zero;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int kk = e / kBN, n = e % kBN;
      const int p = k0 + kk, g = g0 + n;
      bs[kk][n] = (p < num_p && g < num_g) ? xb[(long long)p * num_g + g] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float2 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][j] = fmaf(a[i].x, c[j].x, accr[i][j]);
          accr[i][j] = fmaf(-a[i].y, c[j].y, accr[i][j]);
          acci[i][j] = fmaf(a[i].x, c[j].y, acci[i][j]);
          acci[i][j] = fmaf(a[i].y, c[j].x, acci[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= num_v) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + tx + 16 * j;
      if (g >= num_g) continue;
      float yr = accr[i][j], yi = acci[i][j];
      for (int k = 0; k < num_k; ++k) {
        const float2 a = dv[k * num_v + v], c = pb[k * num_g + g];
        const float2 s = st[k * num_b + b];
        const float orr = a.x * c.x - a.y * c.y, oi = a.x * c.y + a.y * c.x;
        yr += s.x * orr - s.y * oi;
        yi += s.x * oi + s.y * orr;
      }
      out[((long long)b * num_v + v) * num_g + g] = make_float2(yr, yi);
    }
  }
}

}  // namespace

extern "C" {

// K4: one segment's convolution with bps beams per block. With lmat given
// (bps == num_b), the block writes the beam-mixed pc and k1_mix must not
// run; without, the un-mixed pc [B, P, G] at gate offset g0. Planes mode
// when xr/xi are given ([B, P, x_len] f32), draw mode (Philox keyed by
// (s0, s1), counter (n, p, b, seg)) otherwise.
int k4_pc(const void* taps, int lh, int pad_front, int j_len, int g0, int seg,
          unsigned s0, unsigned s1, float scale, const void* xr,
          const void* xi, long long x_len, int num_b, int num_p, int num_g,
          int bps, const void* lmat, void* pc, void* stream) {
  if (bps < 1 || bps > num_b || num_b > kMaxB ||
      (lmat != nullptr && bps != num_b))
    return (int)cudaErrorInvalidValue;
  const int wl = kTile + lh - 1;
  const int wlp = padded(wl - 1) + 1;
  const size_t floats = (2 * (size_t)kRows * wlp + 2 * (size_t)lh + 1) & ~(size_t)1;
  const size_t smem = floats * sizeof(float) +
                      ((size_t)bps * kRows * kTile +
                       (lmat != nullptr ? (size_t)num_b * num_b : 0)) * sizeof(float2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid((j_len + kTile - 1) / kTile, (num_p + kRows - 1) / kRows,
                  (num_b + bps - 1) / bps);
  const uint2 key = make_uint2(s0, s1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = xr == nullptr ? pc_window_kernel<true> : pc_window_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float2*>(taps), lh, pad_front, j_len, g0,
      (unsigned)seg, key, scale, static_cast<const float*>(xr),
      static_cast<const float*>(xi), x_len, num_b, num_p, num_g, bps,
      static_cast<const float2*>(lmat), static_cast<float2*>(pc));
  return (int)cudaGetLastError();
}

// In-place beam mix of pc [B, P*G] by L [B, B] (row-major, complex).
int k1_mix(void* pc, const void* lmat, int num_b, long long pg, void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  long long blocks = (pg + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  mix_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(pc), static_cast<const float2*>(lmat), num_b, pg);
  return (int)cudaGetLastError();
}

// out [B, V, G] = D [V, P] @ pc[b] [P, G] + sum_k st[k,b] dv[k,v] pb[k,g].
int k1_mtd(const void* d, const void* pc, int num_b, int num_v, int num_p,
           int num_g, const void* dv, const void* pb, const void* st,
           int num_k, void* out, void* stream) {
  const dim3 grid((num_g + kBN - 1) / kBN, (num_v + kBM - 1) / kBM, num_b);
  mtd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(d), static_cast<const float2*>(pc), num_b,
      num_v, num_p, num_g, static_cast<const float2*>(dv),
      static_cast<const float2*>(pb), static_cast<const float2*>(st), num_k,
      static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
"""
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F, _LL = ctypes.c_float, ctypes.c_longlong
OLD_K4_SIGNATURES = {
    "k4_pc": [_P, _I, _I, _I, _I, _I, _U, _U, _F, _P, _P, _LL, _I, _I, _I,
              _I, _P, _P, _P],
    "k1_mix": [_P, _P, _I, _LL, _P],
    "k1_mtd": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
}

# K9's tail at bf16 on the CUDA cores: the bf16 instance of
# ablate_f32_schedules.py's mtd_mix_kernel (a block per 32 Doppler rows x 32 gates
# forms every beam's DFT tile in turn, keeps it rounded in shared memory,
# mixes; pc read with row stride num_g)
OLD_K9 = r"""
extern "C" int rv_mtd_mix_bf16(const void* dr, const void* di,
                               const void* pcr, const void* pci,
                               const void* lmat, int num_b, int num_v,
                               int num_p, int num_g, const void* dv,
                               const void* pb, const void* st_, int num_k,
                               void* out, void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  return launch_mtd_mix<__nv_bfloat16>(
      dr, di, pcr, pci, lmat, num_b, num_v, num_p, num_g,
      make_signal(dv, pb, st_, num_k), out, static_cast<cudaStream_t>(stream));
}
"""
OLD_K9_SIGNATURE = [_P] * 5 + [_I] * 4 + [_P] * 3 + [_I, _P, _P]

# copies of noise_rdm_sm90.cu with a part of K4's producer changed: (old,
# new) text pairs
_DRAW = "          draw_stage(smem_raw + (base - raw), t, p0, b, n0 + kt * kBK, sg, a);\n"
_FENCE = "          asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
_ARRIVE = "          mbar_arrive(full(sl.i));\n        }\n"
K4_VARIANTS = {
    "no_philox": ((
        "      philox_lanes(n, (unsigned)p, (unsigned)b, (unsigned)sg.seg_id, "
        "a.key, w0,\n                   w1);\n",
        "      for (int e = 0; e < kDrawLanes; ++e) {\n"
        "        w0[e] = n[e] * 2654435761u;\n"
        "        w1[e] = w0[e] ^ (unsigned)p;\n      }\n"),),
    "no_draw": ((_DRAW, ""),),
    "warp_arrive": (
        ("      mbar_init(full(st), kDraw ? kK4Producers + 1 : 1);",
         "      mbar_init(full(st), kDraw ? kK4Producers / 32 + 1 : 1);"),
        (_ARRIVE, "          __syncwarp();\n"
                  "          if ((t & 31) == 0) mbar_arrive(full(sl.i));\n"
                  "        }\n")),
    "no_fence": ((_FENCE, ""),),
    "sleepy_wait": ((
        "  while (!mbar_try_wait(bar, parity))\n"
        "    if (now_ns() - t0 > kTimeoutNs) __trap();\n",
        "  while (!mbar_try_wait(bar, parity)) {\n    __nanosleep(100);\n"
        "    if (now_ns() - t0 > kTimeoutNs) __trap();\n  }\n"),),
}
# K9's bf16 tail as one kernel (every beam's rounded DFT tile kept in
# shared memory and mixed there), the design the port measured against
# K7's dft_kernel + mix_kernel; appended with ablate_k3_k10's CLUSTER to a
# copy of csrc/rdm_sm90.cu
FUSED = r"""
// K9's bf16 tail as one kernel (the design first tried for it; the port runs
// K7's dft_kernel + mix_kernel instead, which measured faster), appended
// with CLUSTER (scripts/ablate_k3_k10.py) to a copy of rdm_sm90.cu.
//
// dft_mix_kernel. The 13 beams' rounded [V, G] maps do not fit a block, so
// a block owns a 64 (Doppler) x 32 (gate) tile of every beam: its bf16
// tiles (8 KB a beam, 104 KB for 13) stay in shared memory from the DFT to
// the mix, which writes each output once (K7's dft + mix_kernel write and
// read 58.8 MB of mt). Two consumer warpgroups take alternate beams (wgmma
// m64n32k16; B = pc MN-major through the transpose bit; 64-byte swizzle:
// a 32-gate row is 64 bytes, and so are D's [64][32] boxes), so one rounds
// its tile while the other's MMAs run; pc streams through up to 16 stages
// of [32 k][32 gates] boxes, each given back as soon as its MMAs are done.
// D's 64-row tile stays resident for every 32-deep k step where that
// leaves room for kTMinResident stages (13 beams: up to 416 pulses), else
// each stage carries its k step's D box beside pc's. With kTCluster > 1,
// the CTAs of a cluster take adjacent Doppler tiles of one gate tile: each
// stage is loaded by one CTA in turn and multicast to all, and goes back
// when every CTA's consumers are done with it. The mix (13 x 13 complex
// MACs an element) runs as mma.sync from shared memory, L padded to 16 x
// 16.

namespace {

constexpr int kTM = 64, kTN = 32, kTK = 32;   // Doppler rows, gates, k a step
constexpr int kTCluster = 1;                  // CTAs sharing each pc stage
constexpr int kTMaxStages = 16;
constexpr int kTMinResident = 4;              // fewest stages beside D's tile
constexpr int kTConsumers = 2;                // warpgroups: alternate beams
constexpr int kTThreads = 128 * kTConsumers + 32;
constexpr int kTDBox = kTM * kTK * 2;         // a D plane's box [64][32] bf16
constexpr int kTPcBox = kTK * kTN * 2;        // a pc plane's box [32 k][32 gates]
constexpr int kTRow = kTN * 2;                // bytes of a rounded tile's row
constexpr int kTMtBytes = 2 * kTM * kTRow;    // a beam's rounded tile, 2 planes
constexpr int kTMaxB = 16;

struct TailArgs {
  CUtensorMap dr, di;         // bf16 [V, P] (row stride p_ld), boxes [64][32]
  CUtensorMap pr, pi;         // bf16 [B][P][G] (row stride ld), boxes [32][32]
  const float2* lmat;         // L rounded to bf16 [B, B]
  const float2* dv;           // the rank-K signal [K, V], [K, G], [K, B]
  const float2* pb;
  const float2* st;
  int num_k, num_b, num_v, num_g, k_tiles;
  int stages;                 // pc stages
  int d_res;                  // 1: D's tile resident; 0: a D box in each stage
  float2* out;                // complex64 [B, V, G]
};

// The tail's shared memory for num_b beams and k_tiles k steps: D's tile
// resident for every k step beside at least kTMinResident pc stages where
// that fits, else each stage carries its k step's D box beside pc's; then
// every beam's rounded tile, the barriers and L. Sets the stages and
// whether D is resident; returns the dynamic shared bytes (0: no fit).
int tail_layout(int num_b, int k_tiles, int* stages, int* d_res) {
  const int fixed = 1024 + num_b * kTMtBytes + 8 * num_b * num_b + 8;
  for (int res = 1; res >= 0; --res) {
    const long long d_bytes = res ? (long long)k_tiles * 2 * kTDBox : 0;
    const int stage = 2 * kTPcBox + (res ? 0 : 2 * kTDBox) + 16;   // + barriers
    const long long room = kMaxSmem - fixed - d_bytes;
    const long long s = room > 0 ? room / stage : 0;
    if (s >= (res ? kTMinResident : 2)) {
      *stages = s < kTMaxStages ? (int)s : kTMaxStages;
      *d_res = res;
      return fixed + (int)d_bytes + *stages * stage;
    }
  }
  return 0;
}

// wgmma descriptors of bf16 tiles as TMA writes them with 64-byte swizzle
// (rows of 64 bytes, 8-row groups 512 bytes apart: the stride byte
// offset). K-major [64 rows][32 k] (D): a 16-deep k slice starts 32 bytes
// further into the rows. MN-major [k rows][32 gates] (pc): the tile is one
// 32-wide MN block, so the leading byte offset is not used; a 16-deep k
// slice starts 1024 bytes further.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

#define ACC16(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 32 f32) += A B, A 64 x 16 K-major, B 16 x 32 MN-major (the
// transpose bit), both with 64-byte swizzle; B scaled by kScaleB.
template <int kScaleB>
__device__ __forceinline__ void wgmma_n32t(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, %19, 0, 1;\n"
      "}\n"
      : ACC16(d)
      : "l"(da), "l"(db), "r"(1), "n"(kScaleB));
}

__device__ __forceinline__ void fence_acc16(float (&d)[16]) {
  asm volatile("" : ACC16(d) : : "memory");
}

// TMA: the 3D box at (column, row, plane) of `map` into shared `dst` of
// every CTA of `mask` in the cluster, completion on each one's barrier at
// `bar`.
__device__ __forceinline__ void tma_load3_mc(uint32_t dst, const CUtensorMap* map,
                                             int c0, int c1, int c2, uint32_t bar,
                                             uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "h"(mask)
      : "memory");
}

// Byte offset of gate pair (gl, gl + 1) of row r in a rounded tile: rows of
// 64 bytes, the 16-byte chunk index XORed with bits 1-2 of the row, so the
// fragments' 4-byte writes (8 rows x 4 columns a warp) hit 32 banks.
__device__ __forceinline__ int mt_off(int r, int gl) {
  return r * kTRow + ((((gl >> 3) ^ (r >> 1)) & 3) << 4) + (gl & 7) * 2;
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major fragment) b (16 x 8 bf16,
// column-major fragment): mma.sync m16n8k16.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 tiles transposed out of shared memory: lane i gives the
// address of row i % 8 of tile i / 8; tile m lands in r[m] as the column
// fragment of an mma B operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// K9's tail at bf16: out[b] = sum_c L[b,c] bf16(D @ pc[c]) (+ the signal)
// for a 64 (Doppler) x 32 (gate) tile of every beam. The producer warp
// loads D's tile once for every 32-deep k step (resident) or with each
// stage, and the pc boxes of each beam in turn: stage n goes to every CTA
// of the cluster, loaded by CTA n % kTCluster (multicast). Consumer
// warpgroup w takes beams w, w + 2, ... (the stages alternate between the
// warpgroups' beams, k step by k step), runs wgmma m64n32k16 (A = D
// K-major, B = pc MN-major), gives each stage back to every CTA as soon as
// its MMAs are done and rounds the beam's tile to bf16 into its slot. Then
// both mix every beam's tile from shared memory on the tensor cores
// (mma.sync) and write each output element once.
__global__ void __cluster_dims__(kTCluster, 1, 1) __launch_bounds__(kTThreads, 1)
    dft_mix_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const int stages = a.stages;
  const int stage_bytes = 2 * kTPcBox + (a.d_res ? 0 : 2 * kTDBox);
  const uint32_t stage0 = tiles + (a.d_res ? a.k_tiles * 2 * kTDBox : 0);
  const uint32_t mts = stage0 + stages * stage_bytes;
  const uint32_t bars = mts + a.num_b * kTMtBytes;   // full, empty, D
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (stages + st); };
  const uint32_t dfull = bars + 8u * 2 * stages;
  float2* sl = reinterpret_cast<float2*>(smem_raw + (dfull + 8u - raw));
  const uint32_t rank = kTCluster > 1 ? cluster_rank() : 0;
  const int v0 = blockIdx.x * kTM;
  // a tile past the last Doppler row (the grid is padded to whole
  // clusters) reads the first rows' D and stores nothing
  const int dv0 = v0 < a.num_v ? v0 : 0;
  const int g0 = blockIdx.y * kTN;
  const int pairs = (a.num_b + 1) / 2;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTCluster);   // a release from every CTA
    }
    mbar_init(dfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kTCluster > 1)
    cluster_sync();   // every CTA's barriers exist before a multicast lands
  else
    __syncthreads();

  if (threadIdx.x >= 128 * kTConsumers) {
    if (threadIdx.x == 128 * kTConsumers) {
      if (a.d_res) {
        mbar_expect_tx(dfull, a.k_tiles * 2 * kTDBox);
        for (int kt = 0; kt < a.k_tiles; ++kt) {
          tma_load(tiles + kt * 2 * kTDBox, &a.dr, kt * kTK, dv0, dfull);
          tma_load(tiles + kt * 2 * kTDBox + kTDBox, &a.di, kt * kTK, dv0, dfull);
        }
      }
      // stages in the order the warpgroups take them: for each pair of
      // beams, k step by k step, the even beam's then the odd one's
      Slot sl_;
      int n = 0;
      for (int j = 0; j < pairs; ++j) {
        for (int kt = 0; kt < a.k_tiles; ++kt)
          for (int c = 2 * j; c < 2 * j + 2 && c < a.num_b; ++c, ++n,
                   sl_.next(stages)) {
            if (n >= stages) {
              if constexpr (kTCluster > 1)
                mbar_wait_cluster(empty(sl_.i), sl_.phase ^ 1);
              else
                mbar_wait(empty(sl_.i), sl_.phase ^ 1);
            }
            const uint32_t base = stage0 + sl_.i * stage_bytes;
            mbar_expect_tx(full(sl_.i), stage_bytes);
            if constexpr (kTCluster > 1) {
              if (n % kTCluster == (int)rank) {
                constexpr uint16_t kAll = (1u << kTCluster) - 1;
                tma_load3_mc(base, &a.pr, g0, kt * kTK, c, full(sl_.i), kAll);
                tma_load3_mc(base + kTPcBox, &a.pi, g0, kt * kTK, c,
                             full(sl_.i), kAll);
              }
            } else {
              tma_load3(base, &a.pr, g0, kt * kTK, c, full(sl_.i));
              tma_load3(base + kTPcBox, &a.pi, g0, kt * kTK, c, full(sl_.i));
            }
            if (!a.d_res) {
              tma_load(base + 2 * kTPcBox, &a.dr, kt * kTK, dv0, full(sl_.i));
              tma_load(base + 2 * kTPcBox + kTDBox, &a.di, kt * kTK, dv0,
                       full(sl_.i));
            }
          }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  for (int i = tid; i < a.num_b * a.num_b; i += 128 * kTConsumers)
    sl[i] = a.lmat[i];
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), ft = lane & 3;
  if (a.d_res) mbar_wait(dfull, 0);
  for (int c = wg; c < a.num_b; c += kTConsumers) {
    const int j = c >> 1;
    const int in_pair = 2 * j + 1 < a.num_b ? 2 : 1;
    // the beam's k steps are stages n0, n0 + in_pair, ... (a slot and its
    // round's parity, advanced without division)
    const int n0 = 2 * j * a.k_tiles + (c & 1);
    int st = n0 % stages, ph = (n0 / stages) & 1;
    float accr[16], acci[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) accr[i] = acci[i] = 0.f;
    fence_acc16(accr);
    fence_acc16(acci);
    for (int kt = 0; kt < a.k_tiles; ++kt) {
      mbar_wait(full(st), ph);
      __syncwarp();
      const uint32_t p_r = stage0 + st * stage_bytes, p_i = p_r + kTPcBox;
      const uint32_t d_r = a.d_res ? tiles + kt * 2 * kTDBox : p_r + 2 * kTPcBox;
      const uint32_t d_i = d_r + kTDBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t ar = desc_sw64(d_r + 32 * kk), ai = desc_sw64(d_i + 32 * kk);
        const uint64_t br = desc_sw64(p_r + 1024 * kk);
        const uint64_t bi = desc_sw64(p_i + 1024 * kk);
        wgmma_n32t<1>(accr, ar, br);
        wgmma_n32t<-1>(accr, ai, bi);
        wgmma_n32t<1>(acci, ar, bi);
        wgmma_n32t<1>(acci, ai, br);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc16(accr);
      fence_acc16(acci);
      if ((tid & 127) == 0) {
        if constexpr (kTCluster > 1)
          for (int r = 0; r < kTCluster; ++r)
            mbar_arrive_peer(peer_addr(empty(st), r));
        else
          mbar_arrive(empty(st));
      }
      st += in_pair;
      if (st >= stages) {
        st -= stages;
        ph ^= 1;
      }
    }
    // the beam's tile rounded to bf16 into its slot (register 4q + 2h + e
    // holds row r0 + 8h, gate 8q + 2ft + e)
    unsigned char* mt = smem_raw + (mts + c * kTMtBytes - raw);
#pragma unroll
    for (int q = 0; q < kTN / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = mt_off(r0 + 8 * h, 8 * q + 2 * ft);
        *reinterpret_cast<uint32_t*>(mt + off) =
            pack_bf16(accr[4 * q + 2 * h], accr[4 * q + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(mt + kTM * kTRow + off) =
            pack_bf16(acci[4 * q + 2 * h], acci[4 * q + 2 * h + 1]);
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kTConsumers) : "memory");

  // The mix on the tensor cores: for 8 gates of a row, Y [16 beams b][8] =
  // L [16 b][16 c] X [16 c][8] as mma.sync m16n8k16 (beams past num_b are
  // zero rows and columns of L, all products exact: bf16 x bf16 in f32),
  // Yr = Lr Xr + (-Li) Xi, Yi = Lr Xi + Li Xr. A thread's fragments of L
  // are made once; X comes out of the beams' slots with ldmatrix.trans
  // (row c of a tile is beam c's 8 gates; a slot past num_b reads slot 0,
  // finite, against L's zero column). On the CUDA cores the mix's 13 x 13
  // products an element, each on a shared load of L, held the kernel.
  const int warp8 = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row group, column pair
  uint32_t lr[4], li[4], lni[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = gq + 8 * (i & 1), c = 2 * tq + 8 * (i >> 1);
    float2 e0 = make_float2(0.f, 0.f), e1 = e0;
    if (b < a.num_b && c < a.num_b) e0 = sl[b * a.num_b + c];
    if (b < a.num_b && c + 1 < a.num_b) e1 = sl[b * a.num_b + c + 1];
    lr[i] = pack_bf16(e0.x, e1.x);
    li[i] = pack_bf16(e0.y, e1.y);
    lni[i] = pack_bf16(-e0.y, -e1.y);
  }
  // the slot row this lane addresses: tile m = lane / 8 (0, 1: the real
  // plane's beams 0-7, 8-15; 2, 3: the imaginary plane's), row lane % 8
  const int c_row = 8 * ((lane >> 3) & 1) + (lane & 7);
  const uint32_t row_base = mts + (c_row < a.num_b ? c_row : 0) * kTMtBytes +
                            (lane >> 4) * (kTM * kTRow);
  for (int tile = warp8; tile < kTM * (kTN / 8); tile += 4 * kTConsumers) {
    const int r = tile >> 2, q = tile & 3;   // row, 8-gate group
    const int v = v0 + r;
    if (v >= a.num_v) break;
    uint32_t x[4];
    __syncwarp();   // lanes that skipped the last tile's stores rejoin
    ldmatrix_x4_trans(x, row_base + mt_off(r, 8 * q));
    float yr[4] = {0.f, 0.f, 0.f, 0.f}, yi[4] = {0.f, 0.f, 0.f, 0.f};
    mma_16816(yr, lr, x[0], x[1]);
    mma_16816(yr, lni, x[2], x[3]);
    mma_16816(yi, lr, x[2], x[3]);
    mma_16816(yi, li, x[0], x[1]);
    // register 2h + e holds beam gq + 8h, gate 8q + 2tq + e
    const int g = g0 + 8 * q + 2 * tq;
    if (g >= a.num_g) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = gq + 8 * h;
      if (b >= a.num_b) continue;
      float y[4] = {yr[2 * h], yi[2 * h], yr[2 * h + 1], yi[2 * h + 1]};
      for (int k = 0; k < a.num_k; ++k) {   // the rank-K signal
        const float2 s = a.st[k * a.num_b + b], d = a.dv[k * a.num_v + v];
        const float2 sd = make_float2(s.x * d.x - s.y * d.y, s.x * d.y + s.y * d.x);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (g + e >= a.num_g) break;
          const float2 p = a.pb[k * a.num_g + g + e];
          y[2 * e] += sd.x * p.x - sd.y * p.y;
          y[2 * e + 1] += sd.x * p.y + sd.y * p.x;
        }
      }
      const long long o = ((long long)b * a.num_v + v) * a.num_g + g;
      if (g + 1 < a.num_g && (a.num_g & 1) == 0)   // o even: one 16-byte store
        *reinterpret_cast<float4*>(a.out + o) = make_float4(y[0], y[1], y[2], y[3]);
      else {
        a.out[o] = make_float2(y[0], y[1]);
        if (g + 1 < a.num_g) a.out[o + 1] = make_float2(y[2], y[3]);
      }
    }
  }
  // no CTA leaves while a peer may still give a stage back to it
  if constexpr (kTCluster > 1) {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// A bf16 tensor [planes][rows][cols] (row stride ld elements, plane stride
// plane_ld) read in boxes {32 columns, box_rows rows, 1 plane} with 64-byte
// swizzle; out-of-bounds reads are 0. plane_ld == 0: a 2D map.
bool make_map32(CUtensorMap* map, long long ptr, long long cols, long long rows,
                long long ld, int box_rows, long long planes = 1,
                long long plane_ld = 0) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ptr % 16 != 0 || ld % 8 != 0 || plane_ld % 8 != 0 ||
      cols < 1 || rows < 1 || planes < 1)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)plane_ld * 2};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, plane_ld > 0 ? 3 : 2,
            reinterpret_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The layout of K9's tail for num_b beams and num_p pulses into out[4]:
// its dynamic shared bytes, pc stages, whether D's tile is resident (1) or
// comes with each stage (0), and its 32-deep k steps. Returns 0, or
// cudaErrorInvalidValue where no layout fits (more than 16 beams).
extern "C" int rs_dft_mix_layout(int num_b, int num_p, int* out) {
  if (num_b < 1 || num_b > kTMaxB || num_p < 1 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (num_p + kTK - 1) / kTK;
  out[0] = tail_layout(num_b, k_tiles, &out[1], &out[2]);
  out[3] = k_tiles;
  return out[0] > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// K9's tail at bf16: out [B, V, G] complex64 = sum_c L[b,c] bf16(D @ pc[c])
// (+ sum_k st[k,b] dv[k,v] pb[k,g]). d: D's bf16 planes [2, V, p_ld] (p_ld a
// multiple of 8); pcr, pci: bf16 [B, P, ld] (ld a multiple of 8), 16-byte
// aligned; lmat: L rounded to bf16, complex64 [B, B]. Any pulse count; up
// to 16 beams.
extern "C" int rs_dft_mix(const void* d, int num_v, int num_p, int p_ld, const void* pcr,
               const void* pci, int num_b, int num_g, int ld, const void* lmat,
               const void* dv, const void* pb, const void* st, int num_k,
               void* out, void* stream) {
  int lay[4];
  const int v_tiles = (num_v + kTM - 1) / kTM, g_tiles = (num_g + kTN - 1) / kTN;
  if (num_v < 1 || num_g < 1 || g_tiles > 65535 || lmat == nullptr ||
      out == nullptr || rs_dft_mix_layout(num_b, num_p, lay) != 0 ||
      (num_k > 0 && (dv == nullptr || pb == nullptr || st == nullptr)))
    return (int)cudaErrorInvalidValue;
  TailArgs a{};
  const long long dp = reinterpret_cast<long long>(d);
  if (!make_map32(&a.dr, dp, num_p, num_v, p_ld, kTM) ||
      !make_map32(&a.di, dp + 2LL * num_v * p_ld, num_p, num_v, p_ld, kTM) ||
      !make_map32(&a.pr, reinterpret_cast<long long>(pcr), num_g, num_p, ld,
                  kTK, num_b, (long long)num_p * ld) ||
      !make_map32(&a.pi, reinterpret_cast<long long>(pci), num_g, num_p, ld,
                  kTK, num_b, (long long)num_p * ld))
    return (int)cudaErrorInvalidValue;
  a.lmat = static_cast<const float2*>(lmat);
  a.dv = static_cast<const float2*>(dv);
  a.pb = static_cast<const float2*>(pb);
  a.st = static_cast<const float2*>(st);
  a.num_k = num_k;
  a.num_b = num_b;
  a.num_v = num_v;
  a.num_g = num_g;
  a.stages = lay[1];
  a.d_res = lay[2];
  a.k_tiles = lay[3];
  a.out = static_cast<float2*>(out);
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(dft_mix_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  // Doppler tiles fastest, padded to whole clusters: a cluster's CTAs share
  // each pc stage, and the clusters that read one gate tile's pc run
  // together, so pc comes from HBM about once
  const dim3 grid((v_tiles + kTCluster - 1) / kTCluster * kTCluster, g_tiles);
  dft_mix_kernel<<<grid, kTThreads, lay[0], static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
"""
FUSED_SIGNATURES = {
    "rs_dft_mix": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                   _P, _P],
    "rs_dft_mix_layout": [_I, _I, _P],
}
# copies of the fused tail with a part changed: clusters of 2 or 3 CTAs
# sharing each pc stage by multicast, D's k step loaded with every stage
# (as beyond 416 pulses at 13 beams), and, timing only, without the mix (no
# output), without the mix's stores, and without the MMAs
_CLUSTER = "constexpr int kTCluster = 1;"
K9_VARIANTS = {"fused": (),
               "cluster_2": ((_CLUSTER, "constexpr int kTCluster = 2;"),),
               "cluster_3": ((_CLUSTER, "constexpr int kTCluster = 3;"),),
               "streamed_d": (("  for (int res = 1; res >= 0; --res) {",
                               "  for (int res = 0; res >= 0; --res) {"),),
               "no_mix": (("  for (int tile = warp8; tile < kTM * (kTN / 8); "
                           "tile += 4 * kTConsumers) {\n",
                           "  for (int tile = warp8; tile < 0; "
                           "tile += 4 * kTConsumers) {\n"),),
               "no_store": (("      if (g + 1 < a.num_g && (a.num_g & 1) == 0)"
                             "   // o even: one 16-byte store\n",
                             "      if (y[0] == 1234.5f && y[3] == 1234.5f)\n"),),
               "no_mma": (("        wgmma_n32t<1>(accr, ar, br);\n"
                           "        wgmma_n32t<-1>(accr, ai, bi);\n"
                           "        wgmma_n32t<1>(acci, ar, bi);\n"
                           "        wgmma_n32t<1>(acci, ai, br);\n", ""),)}


def build(build_dir: str):
    """The copies of noise_rdm.cu (the old K4 appended) and of
    rdm_variants.cu (the old f32 kernels and the old bf16 tail's entry
    appended), one nvcc each, at once; (old K4 library, old K9 library)."""
    from ablate_f32_schedules import OLD_F32
    from ablate_k7_k8 import OLD_HELPERS

    from radar_tpu_torch import _build

    src = lambda name: open(os.path.join(_build._CSRC, name + ".cu")).read()
    sos = _compile({"k4_old": src("noise_rdm") + OLD_K4,
                    "k9_old": src("rdm_variants") + OLD_HELPERS + OLD_F32
                              + OLD_K9},
                   build_dir)
    k4 = _load(sos["k4_old"], "noise_rdm")
    for fn, argtypes in OLD_K4_SIGNATURES.items():
        getattr(k4, fn).argtypes = argtypes
        getattr(k4, fn).restype = ctypes.c_int
    k9 = _load(sos["k9_old"], "rdm_variants")
    k9.rv_mtd_mix_bf16.argtypes = OLD_K9_SIGNATURE
    k9.rv_mtd_mix_bf16.restype = ctypes.c_int
    return k4, k9


def old_k4(lib, plan, lmat, signal, seed, beams_per_step):
    """The old K4 in draw mode: pc_window_kernel a segment (the in-block
    mix at k = B), k1_mix otherwise, then k1_mtd with the signal."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    dev = lmat.device
    num_b, num_p = lmat.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    lmat = lmat.contiguous()
    d = plan.d.contiguous()
    num_k, sig_ptrs, _keep = nr._signal_args(signal, dev, num_b, num_v,
                                             num_g)
    pc = torch.empty((num_b, num_p, num_g), dtype=torch.complex64,
                     device=dev)
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mixed = beams_per_step == num_b
    for si, seg in enumerate(plan.segments):
        taps = seg.taps.contiguous()
        _build.check(lib, lib.k4_pc(
            taps.data_ptr(), taps.shape[0], seg.pad_front, seg.j_len, seg.g0,
            si, seed[0], seed[1], ctypes.c_float(nr.U_SCALE), None, None, 0,
            num_b, num_p, num_g, beams_per_step,
            lmat.data_ptr() if mixed else None, pc.data_ptr(), stream),
            "k4_pc")
    if not mixed:
        _build.check(lib, lib.k1_mix(pc.data_ptr(), lmat.data_ptr(), num_b,
                                     num_p * num_g, stream), "k1_mix")
    _build.check(lib, lib.k1_mtd(d.data_ptr(), pc.data_ptr(), num_b, num_v,
                                 num_p, num_g, *sig_ptrs, num_k,
                                 out.data_ptr(), stream), "k1_mtd")
    return out


def build_variants(name: str, variants: dict, build_dir: str,
                   extra: str = "") -> dict:
    """The ``variants`` copies of csrc/<name>.cu (with ``extra`` appended),
    built and loaded."""
    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, name + ".cu")) as f:
        full = f.read() + extra
    sources = {}
    for var, cuts in variants.items():
        src = full
        for old, new in cuts:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}.cu no longer has the text {var} "
                                   f"changes: {old[:60]!r}")
            src = src.replace(old, new)
        sources[f"{name}_{var}"] = src
    return {k[len(name) + 1:]: _load(so, name)
            for k, so in _compile(sources, build_dir).items()}


def swapped(lib_name: str, lib, fn):
    """``fn`` run with ``lib`` in place of the port's library ``lib_name``."""
    from radar_tpu_torch import _build

    def run():
        shipped = _build.load(lib_name)
        _build._libs[lib_name] = lib
        try:
            return fn()
        finally:
            _build._libs[lib_name] = shipped
    return run


def k4_variants(libs: dict, plan, lmat, seed, reps: int) -> dict:
    """K4 at 1 beam a block with each K4_VARIANTS library swapped in for
    the port's, beside the shipped K4 and K4 in planes mode on K1c's
    planes: times in turns, the profiler's split."""
    from radar_tpu_torch.ops import noise_rdm as nr

    num_b = lmat.shape[0]
    planes = nr.gen_noise_planes(plan, seed, num_b, device=lmat.device)
    call = lambda **kw: nr.noise_rdm(plan, lmat, layout="bvg", rolling=False,
                                     beams_per_step=1, **kw)
    calls = {"shipped": lambda: call(seed=seed),
             "planes_mode": lambda: call(planes=planes),
             **{k: swapped("noise_rdm_sm90", lib, lambda: call(seed=seed))
                for k, lib in libs.items()}}
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["profile_ms"] = _profile(fn)
    return out


def in_turns(calls: dict, reps: int) -> dict:
    """Busy-card and idle-card events and host ms a call of each of
    ``calls`` in turns (forwards, then backwards), medians."""
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    t = {k: {"busy": [], "idle": [], "host": []} for k in calls}
    for _ in range(reps):
        for k in list(calls) + list(calls)[::-1]:
            for mode in ("idle", "busy"):
                dev_ms, host_ms = _events(calls[k], mode == "busy")
                t[k][mode].append(dev_ms)
                if mode == "busy":
                    t[k]["host"].append(host_ms)
    return {k: {"busy_ms": statistics.median(v["busy"]),
                "idle_ms": statistics.median(v["idle"]),
                "host_ms": statistics.median(v["host"])}
            for k, v in t.items()}


def _rel_rms(a, b) -> float:
    return float((a - b).abs().pow(2).mean().sqrt()
                 / b.abs().pow(2).mean().sqrt())


def k4(lib, plan, lmat, seed, reps: int) -> dict:
    """Old and new K4 in draw mode through ``noise_rdm`` at 13 beams and 1
    beam a block: times in turns, the profiler's split, RMS errors."""
    from radar_tpu_torch.ops import noise_rdm as nr

    num_b = lmat.shape[0]
    ref = nr.noise_rdm_plain(plan, lmat, nr.philox_planes(
        plan, seed, num_b, device=lmat.device))
    new_route = nr._k4_cuda
    old_route = lambda plan_, l_, signal_, seed_, planes_, k: old_k4(
        lib, plan_, l_, signal_, seed_, k)
    out = {}
    for bps in (num_b, 1):
        call = lambda: nr.noise_rdm(plan, lmat, seed=seed, layout="bvg",
                                    rolling=False, beams_per_step=bps)

        def old():
            nr._k4_cuda = old_route
            try:
                return call()
            finally:
                nr._k4_cuda = new_route

        calls = {"old": old, "new": call}
        err = {k: _rel_rms(fn(), ref) for k, fn in calls.items()}
        res = in_turns(calls, reps)
        for k, fn in calls.items():
            res[k]["rms_err_over_rms"] = err[k]
            res[k]["profile_ms"] = _profile(fn)
        out[f"beams_per_step_{bps}"] = res
    return out


def fused_tail(lib, plan, pcr, pci, num_g: int, lmat, out) -> None:
    """The fused tail of ``lib`` (FUSED or a copy): out [B, V, G] = sum_c
    L[b,c] bf16(D @ pc[c]) from bf16 pc planes [B, P, ld]."""
    import torch

    from radar_tpu_torch import _build

    d = plan.d_bf16
    num_b, num_p, ld = pcr.shape
    _build.check(lib, lib.rs_dft_mix(
        d.data_ptr(), plan.n_dop, num_p, d.shape[2], pcr.data_ptr(),
        pci.data_ptr(), num_b, num_g, ld, lmat.data_ptr(), None, None, None,
        0, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "rs_dft_mix")


def k9(lib, plan, lmat, planes, reps: int, fused: dict) -> dict:
    """K9 at bf16 with the old tail and the port's (both after the strip
    GEMM), then the tails alone on the same pc planes: the old one, the
    port's (K7's DFT GEMM and mix) and the fused kernel with each of its
    ``fused`` copies: times in turns, the profiler's split, RMS errors."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    dev = lmat.device
    num_b, num_p = lmat.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    z = torch.zeros((num_b, num_p, plan.s_compact), dtype=torch.complex64,
                    device=dev)
    for seg, (xr, xi) in zip(plan.segments, planes):
        sl = slice(seg.pad_front, seg.pad_front + seg.r_len)
        z[:, :, seg.c0:seg.c0 + seg.r_len] = torch.complex(xr[..., sl],
                                                           xi[..., sl])
    l16 = nr._rounded_l(lmat, bf)
    d16 = nr.round_mul(plan.d, bf)
    dr, di = d16.real.contiguous(), d16.imag.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def strip_planes(ld):
        pcr = torch.empty((num_b, num_p, ld), dtype=bf, device=dev)
        pci = torch.empty_like(pcr)
        segs = [(nr._rows16(xr), nr._rows16(xi), seg.strip, seg.j_len,
                 seg.g0) for seg, (xr, xi) in
                zip(plan.segments, nr.planes_from_compact(z, plan, bf))]
        nr.strip_pc(segs, num_b * num_p, ld, outr=pcr, outi=pci)
        return pcr, pci

    def old_tail(pcr, pci, out):
        _build.check(lib, lib.rv_mtd_mix_bf16(
            dr.data_ptr(), di.data_ptr(), pcr.data_ptr(), pci.data_ptr(),
            l16.data_ptr(), num_b, num_v, num_p, num_g, None, None, None, 0,
            out.data_ptr(), stream), "rv_mtd_mix_bf16")

    def old_k9():
        pcr, pci = strip_planes(num_g)     # the old tail's row stride
        out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                          device=dev)
        old_tail(pcr, pci, out)
        return out

    new_k9 = lambda: nr.noise_rdm_compact(z, plan, lmat, variant="allbeams",
                                          mul_dtype=bf).permute(2, 0, 1)
    ref = nr.noise_rdm_plain(plan, lmat, nr.planes_from_compact(z, plan, bf),
                             mul_dtype=bf)
    calls = {"old": old_k9, "new": new_k9}
    err = {k: _rel_rms(fn(), ref) for k, fn in calls.items()}
    full = in_turns(calls, reps)
    for k, fn in calls.items():
        full[k]["rms_err_over_rms"] = err[k]
        full[k]["profile_ms"] = _profile(fn)
    del ref

    # the tails alone on the same pc: old (row stride num_g), the port's
    # and the fused ones (ld)
    ld = -(-num_g // 8) * 8
    pcr, pci = strip_planes(ld)
    pcr_g, pci_g = pcr[..., :num_g].contiguous(), pci[..., :num_g].contiguous()
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    mtr = torch.empty((num_b, num_v, num_g), dtype=bf, device=dev)
    mti = torch.empty_like(mtr)
    rv = _build.load("rdm_variants")

    def port():
        nr.dft(plan, pcr, pci, num_g, mtr, mti)
        _build.check(rv, rv.rv_mix(mtr.data_ptr(), mti.data_ptr(),
                                   l16.data_ptr(), num_b, num_v, num_g, None,
                                   None, None, 0, 0, out.data_ptr(), stream),
                     "rv_mix")
        return out

    tails = {"old": lambda: (old_tail(pcr_g, pci_g, out), out)[1],
             "port_dft_and_mix": port}
    for var, vlib in fused.items():
        tails[var] = (lambda vlib=vlib: (fused_tail(
            vlib, plan, pcr, pci, num_g, l16, out), out)[1])
    pc = torch.complex(pcr_g.float(), pci_g.float())
    want = torch.einsum("bc,cvg->bvg", l16, nr.round_mul(
        torch.matmul(nr.round_mul(plan.d, bf), pc), bf))
    terr = {k: _rel_rms(fn().clone(), want) for k, fn in tails.items()}
    del want, pc
    alone = in_turns(tails, reps)
    for k, fn in tails.items():
        alone[k]["rms_err_over_rms"] = terr[k]
        alone[k]["profile_ms"] = _profile(fn)
    lay = (ctypes.c_int * 4)()
    _build.check(fused["fused"], fused["fused"].rs_dft_mix_layout(
        num_b, num_p, lay), "rs_dft_mix_layout")
    alone["fused"]["layout"] = {"smem_bytes": lay[0], "stages": lay[1],
                                "d_resident": lay[2], "k_tiles": lay[3]}
    return {"k9": full, "tails_alone": alone}


def main() -> int:
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.waveform.precompute import precompute

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k4_k9: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["noise_rdm", "noise_rdm_sm90", "rdm_variants",
                      "rdm_sm90", "band_pc_sm90"])
    lib4, lib9 = build(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                    "ablate_k4_k9"))
    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device="cuda")
    plan, lmat = lr.rplan, lr.l_factor
    seed = nr.seed_words(20261016)
    res = {"card": card, "k4": k4(lib4, plan, lmat, seed, args.reps)}
    vdir = os.path.join(os.path.dirname(_build.BUILD_DIR), "ablate_k4_k9")
    res["k4_variants"] = k4_variants(
        build_variants("noise_rdm_sm90", K4_VARIANTS, vdir), plan, lmat,
        seed, max(3, args.reps // 2))
    planes = nr.gen_noise_planes(plan, nr.seed_words(4242), lmat.shape[0],
                                 device="cuda")
    from ablate_k3_k10 import CLUSTER

    fused = build_variants("rdm_sm90", K9_VARIANTS, vdir, CLUSTER + FUSED)
    for flib in fused.values():
        for fn, argtypes in FUSED_SIGNATURES.items():
            getattr(flib, fn).argtypes = argtypes
            getattr(flib, fn).restype = ctypes.c_int
    res.update(k9(lib9, plan, lmat, planes, args.reps, fused))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
