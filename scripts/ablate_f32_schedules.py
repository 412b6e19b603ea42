"""The f32 noise-RDM schedules K10, K7 and K9 (and K7's draw mode) before
and after their move onto K1's 3xTF32 tensor-core GEMMs, on one NVIDIA GPU
at the perf config's full shape (13 beams, 332 pulses, 3404 gates, filters
of 35/200/700 taps; one JSON line).

    python3 scripts/ablate_f32_schedules.py [--reps 10]

``new`` is the port: ``noise_rdm_compact(z, plan, L, variant=v)`` at
``mul_dtype=torch.float32`` (``ops/noise_rdm.py::_variant_tf32``: K1's
strip-GEMM PC, its two passes joined, K1's DFT GEMM, the mix after the DFT
in one epilogue), and ``noise_rdm(seed=, stacked=True)`` for the draw mode
(K4's drawing PC in place of K1's). ``old`` is the route these schedules
ran before, on the CUDA cores, kept only here (``OLD_F32``, appended to a
copy of ``radar_tpu_torch/csrc/rdm_variants.cu``, after
``ablate_k7_k8.py``'s ``OLD_HELPERS``, built into
``build/ablate_f32_schedules/``): K10's resident ring PC
(``ring_pc_kernel``), the banded PC GEMM of K7 and K9 on planes or Philox
draws (``old_band_pc_kernel``), the tiled DFT GEMM (``mtd_gemm_kernel``)
and the mix of K10 and K7, K9's fused DFT + mix (``mtd_mix_kernel``). The
old route runs through the same entry points, swapped in for
``_variant_tf32``, so both pay the same wrapper (``planes_from_compact``).

The input is a compact white cube holding K1c's planes for one seed (the
draw mode draws the same samples). Each route is held against the plain
version (RMS of the difference over the RMS); the three new schedules
must agree bit for bit, as must the three old ones, and the new draw mode
must equal the new K7 on K1c's planes. Then old and new are timed in turns
(old, new, new, old) with CUDA events on a card kept busy by a sleep
kernel and on an idle one, with the host's ms a call, and split by
torch.profiler's kernel names.

``mtd_mix_kernel`` also serves ``scripts/ablate_k4_k9.py``'s old bf16 K9
tail (its ``OLD_K9`` is appended after ``OLD_F32``).

Prints the card's name and power limit in the line. Needs the CUDA toolkit
and a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ablate_k1 import _compile, _load, _profile  # noqa: E402
from ablate_k4_k9 import _rel_rms, in_turns  # noqa: E402

# The f32 schedules' CUDA-core kernels as they ran before the move onto
# K1's GEMMs; appended to a copy of csrc/rdm_variants.cu (its Num, Signal,
# mix_out and mix_kernel) after ablate_k7_k8.py's OLD_HELPERS (Acc, the
# GEMM tile and Philox)
OLD_F32 = r"""
namespace {

constexpr int kTile = 128;    // K10 gate tile
constexpr int kRows = 8;      // K10 pulse rows per block (one warp each)
constexpr int kOuts = 4;      // K10 contiguous gates per lane
constexpr int kVT = 32, kGT = 32;   // K9's tail tile
constexpr int kMaxSmem = 232448;

__host__ __device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct OldPcArgs {
  const float* xr;       // f32 planes [B, P, x_len] (planes mode)
  const float* xi;
  long long x_len;
  int pad_front;
  unsigned seg;          // draw mode: Philox counter word 3
  uint2 key;
  float scale;
  const float* mr;       // banded filter planes [window, tile]
  const float* mi;
  int window, tile, lh;
  int num_p, j_len, g0, num_g;
  float* outr;           // f32 planes [B, P, num_g]
  float* outi;
};

template <bool kDraw>
__device__ __forceinline__ float2 old_sample(const OldPcArgs& a, int b, int p,
                                             int n) {
  const long long row = (long long)b * a.num_p + p;
  if (!kDraw) {
    const long long off = row * a.x_len + n;
    return make_float2(a.xr[off], a.xi[off]);
  }
  if (n < a.pad_front) return make_float2(0.f, 0.f);
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)n, (unsigned)p, (unsigned)b, a.seg), a.key);
  return make_float2(uniform_rail(w.x, a.scale), uniform_rail(w.y, a.scale));
}

// One 64-pulse x 64-gate block of the f32 PC of beam blockIdx.z: the
// stacked product of the window of its tile with the columns n0 .. n0+63
// of M, over M's rows n0 .. n0+63+lh-2 only, on the CUDA cores.
template <bool kDraw>
__global__ void __launch_bounds__(kThreads) old_band_pc_kernel(OldPcArgs a) {
  __shared__ float ar_s[kBK * (kBM + 1)], ai_s[kBK * (kBM + 1)];
  __shared__ float br_s[kBK * kBN], bi_s[kBK * kBN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int per_tile = a.tile / kBN;
  const int t = blockIdx.x / per_tile;
  const int n0 = (blockIdx.x - t * per_tile) * kBN;
  const int col0 = t * a.tile;
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
      if (p < a.num_p && k < k_hi) v = old_sample<kDraw>(a, b, p, col0 + k);
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
      a.outr[off] = acc.rr[i][j] - acc.ii[i][j];
      a.outi[off] = acc.ri[i][j] + acc.ir[i][j];
    }
  }
}

// K10's PC: one block per (run of tiles, 8 pulse rows, beam). The ring
// holds samples [s0 + r*128, s0 + r*128 + W) of each row at step r, sample
// i in slot (i - s0) mod C, C = W + 128; the next tile's 128 new samples go
// to the 128 free slots; direct convolution, tap by tap.
__global__ void __launch_bounds__(kThreads)
ring_pc_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               long long x_len, const float* __restrict__ taps_r,
               const float* __restrict__ taps_i, int lh, int window,
               int tiles_per_run, int ntiles, int num_p, int j_len, int g0,
               int num_g, float* __restrict__ outr, float* __restrict__ outi) {
  extern __shared__ float smem[];
  const int ring = window + kTile;
  const int rp = padded(ring - 1) + 1;
  float* sr = smem;
  float* si = sr + kRows * rp;
  float* th_r = si + kRows * rp;            // reversed taps: h[lh-1-k]
  float* th_i = th_r + lh;

  const int t_first = blockIdx.x * tiles_per_run;
  const int t_last = min(ntiles, t_first + tiles_per_run);
  const int p0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const long long s0 = (long long)t_first * kTile;
  const int warp = threadIdx.x >> 5;
  const int t0 = (threadIdx.x & 31) * kOuts;

  for (int k = threadIdx.x; k < lh; k += kThreads) {
    th_r[k] = taps_r[lh - 1 - k];
    th_i[k] = taps_i[lh - 1 - k];
  }
  auto sample = [&](int r, long long n, float& vr, float& vi) {
    vr = vi = 0.f;
    const int p = p0 + r;
    if (p < num_p && n < x_len) {
      const long long off = ((long long)b * num_p + p) * x_len + n;
      vr = xr[off];
      vi = xi[off];
    }
  };
  for (int idx = threadIdx.x; idx < kRows * window; idx += kThreads) {
    const int r = idx / window, e = idx - r * window;
    float vr, vi;
    sample(r, s0 + e, vr, vi);
    sr[r * rp + padded(e)] = vr;
    si[r * rp + padded(e)] = vi;
  }
  __syncthreads();

  constexpr int kPer = kRows * kTile / kThreads;
  for (int t = t_first; t < t_last; ++t) {
    const int rel = (t - t_first) * kTile;
    const bool next = t + 1 < t_last;
    float nr[kPer], ni[kPer];
    if (next) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int idx = threadIdx.x + kThreads * q;
        sample(idx / kTile, s0 + rel + window + idx % kTile, nr[q], ni[q]);
      }
    }
    const int p = p0 + warp;
    if (p < num_p) {
      const float* wr = sr + warp * rp;
      const float* wi = si + warp * rp;
      float rr[kOuts], ii[kOuts], ri[kOuts], ir[kOuts];
      float xr_[kOuts], xi_[kOuts];
      int pos = (rel + t0) % ring;
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        rr[o] = ii[o] = ri[o] = ir[o] = 0.f;
        if (o < kOuts - 1) {
          xr_[o] = wr[padded(pos)];
          xi_[o] = wi[padded(pos)];
          pos = pos + 1 == ring ? 0 : pos + 1;
        }
      }
#pragma unroll 4
      for (int k = 0; k < lh; ++k) {
        xr_[kOuts - 1] = wr[padded(pos)];
        xi_[kOuts - 1] = wi[padded(pos)];
        pos = pos + 1 == ring ? 0 : pos + 1;
        const float hr = th_r[k], hi = th_i[k];
#pragma unroll
        for (int o = 0; o < kOuts; ++o) {
          rr[o] = fmaf(xr_[o], hr, rr[o]);
          ii[o] = fmaf(xi_[o], hi, ii[o]);
          ri[o] = fmaf(xr_[o], hi, ri[o]);
          ir[o] = fmaf(xi_[o], hr, ir[o]);
        }
#pragma unroll
        for (int o = 0; o < kOuts - 1; ++o) {
          xr_[o] = xr_[o + 1];
          xi_[o] = xi_[o + 1];
        }
      }
      const long long row = ((long long)b * num_p + p) * num_g + g0;
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        const int j = t * kTile + t0 + o;
        if (j < j_len) {
          outr[row + j] = rr[o] - ii[o];
          outi[row + j] = ri[o] + ir[o];
        }
      }
    }
    if (next) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int idx = threadIdx.x + kThreads * q;
        const int r = idx / kTile;
        const int slot = (rel + window + idx % kTile) % ring;
        sr[r * rp + padded(slot)] = nr[q];
        si[r * rp + padded(slot)] = ni[q];
      }
    }
    __syncthreads();
  }
}

// mt[b] = D [V, P] @ pc[b] [P, G] in f32 on the CUDA cores
__global__ void __launch_bounds__(kThreads)
mtd_gemm_kernel(const float* __restrict__ dr, const float* __restrict__ di,
                const float* __restrict__ pcr, const float* __restrict__ pci,
                int num_v, int num_p, int num_g, float* __restrict__ mtr,
                float* __restrict__ mti) {
  __shared__ float ar_s[kBK * (kBM + 1)], ai_s[kBK * (kBM + 1)];
  __shared__ float br_s[kBK * kBN], bi_s[kBK * kBN];
  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kBM;
  const int g0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long base = (long long)b * num_p * num_g;
  Acc<4, 4> acc;
  acc.zero();
  for (int k0 = 0; k0 < num_p; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int m = e / kBK, kk = e % kBK;
      const int v = v0 + m, p = k0 + kk;
      const bool in = v < num_v && p < num_p;
      ar_s[kk * (kBM + 1) + m] = in ? dr[(long long)v * num_p + p] : 0.f;
      ai_s[kk * (kBM + 1) + m] = in ? di[(long long)v * num_p + p] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int kk = e / kBN, n = e % kBN;
      const int p = k0 + kk, g = g0 + n;
      const bool in = p < num_p && g < num_g;
      const long long off = base + (long long)p * num_g + g;
      br_s[kk * kBN + n] = in ? pcr[off] : 0.f;
      bi_s[kk * kBN + n] = in ? pci[off] : 0.f;
    }
    __syncthreads();
    acc.step(ar_s, ai_s, kBM + 1, br_s, bi_s, kBN, tx, ty);
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
      const long long off = ((long long)b * num_v + v) * num_g + g;
      mtr[off] = acc.rr[i][j] - acc.ii[i][j];
      mti[off] = acc.ri[i][j] + acc.ir[i][j];
    }
  }
}

// K9's tail: one block per 32 Doppler rows x 32 gates forms every beam's
// DFT tile in turn (a 2x2 register tile a thread), keeps it rounded to T in
// shared memory, then mixes the beams and writes the map once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mtd_mix_kernel(const float* __restrict__ dr, const float* __restrict__ di,
               const T* __restrict__ pcr, const T* __restrict__ pci,
               const float2* __restrict__ lmat, int num_b, int num_v,
               int num_p, int num_g, Signal s, float2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char mt_raw[];
  T* mt_r = reinterpret_cast<T*>(mt_raw);           // [B][32][32]
  T* mt_i = mt_r + num_b * kVT * kGT;
  __shared__ float ar_s[kBK * (kVT + 1)], ai_s[kBK * (kVT + 1)];
  __shared__ float br_s[kBK * kGT], bi_s[kBK * kGT];
  __shared__ float2 sl[kMaxB * kMaxB];
  const int v0 = blockIdx.y * kVT;
  const int g0 = blockIdx.x * kGT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int i = threadIdx.x; i < num_b * num_b; i += kThreads) sl[i] = lmat[i];

  for (int c = 0; c < num_b; ++c) {
    const long long base = (long long)c * num_p * num_g;
    Acc<2, 2> acc;
    acc.zero();
    for (int k0 = 0; k0 < num_p; k0 += kBK) {
      for (int e = threadIdx.x; e < kVT * kBK; e += kThreads) {
        const int m = e / kBK, kk = e % kBK;
        const int v = v0 + m, p = k0 + kk;
        const bool in = v < num_v && p < num_p;
        ar_s[kk * (kVT + 1) + m] = in ? dr[(long long)v * num_p + p] : 0.f;
        ai_s[kk * (kVT + 1) + m] = in ? di[(long long)v * num_p + p] : 0.f;
      }
      for (int e = threadIdx.x; e < kBK * kGT; e += kThreads) {
        const int kk = e / kGT, n = e % kGT;
        const int p = k0 + kk, g = g0 + n;
        const bool in = p < num_p && g < num_g;
        const long long off = base + (long long)p * num_g + g;
        br_s[kk * kGT + n] = in ? Num<T>::f32(pcr[off]) : 0.f;
        bi_s[kk * kGT + n] = in ? Num<T>::f32(pci[off]) : 0.f;
      }
      __syncthreads();
      acc.step(ar_s, ai_s, kVT + 1, br_s, bi_s, kGT, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = (c * kVT + ty + 16 * i) * kGT + tx + 16 * j;
        mt_r[e] = Num<T>::from(acc.rr[i][j] - acc.ii[i][j]);
        mt_i[e] = Num<T>::from(acc.ri[i][j] + acc.ir[i][j]);
      }
  }
  __syncthreads();

  const long long pg = (long long)num_v * num_g;
  for (int e = threadIdx.x; e < kVT * kGT; e += kThreads) {
    const int vl = e / kGT, gl = e - vl * kGT;
    const int v = v0 + vl, g = g0 + gl;
    if (v >= num_v || g >= num_g) continue;
    float2 x[kMaxB];
#pragma unroll
    for (int c = 0; c < kMaxB; ++c)
      x[c] = c < num_b ? make_float2(Num<T>::f32(mt_r[c * kVT * kGT + e]),
                                     Num<T>::f32(mt_i[c * kVT * kGT + e]))
                       : make_float2(0.f, 0.f);
    const long long off = (long long)v * num_g + g;
    for (int b = 0; b < num_b; ++b)
      out[b * pg + off] = mix_out(sl, num_b, b, x, v, g, num_v, num_g, s, false);
  }
}

template <typename T>
int launch_mtd_mix(const void* dr, const void* di, const void* pcr,
                   const void* pci, const void* lmat, int num_b, int num_v,
                   int num_p, int num_g, Signal s, void* out, cudaStream_t st) {
  const size_t smem = 2 * (size_t)num_b * kVT * kGT * sizeof(T);
  cudaError_t err = allow_smem(mtd_mix_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_g + kGT - 1) / kGT, (num_v + kVT - 1) / kVT);
  mtd_mix_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const T*>(pcr), static_cast<const T*>(pci),
      static_cast<const float2*>(lmat), num_b, num_v, num_p, num_g, s,
      static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The f32 banded PC of one segment: src 0 the f32 planes xr, xi [B, P,
// x_len], src 2 Philox draws (K1's counters, key (s0, s1)) -> f32 planes
// outr, outi [B, P, num_g] at gate offset g0.
int rv_old_band_pc(int src, const void* xr, const void* xi, long long x_len,
                   int pad_front, int seg, unsigned s0, unsigned s1,
                   float scale, const void* mr, const void* mi, int window,
                   int tile, int lh, int num_b, int num_p, int j_len, int g0,
                   int num_g, void* outr, void* outi, void* stream) {
  if (tile % kBN != 0 || (src != 0 && src != 2)) return (int)cudaErrorInvalidValue;
  OldPcArgs a{static_cast<const float*>(xr), static_cast<const float*>(xi),
              x_len, pad_front, (unsigned)seg, make_uint2(s0, s1), scale,
              static_cast<const float*>(mr), static_cast<const float*>(mi),
              window, tile, lh, num_p, j_len, g0, num_g,
              static_cast<float*>(outr), static_cast<float*>(outi)};
  const dim3 grid(((j_len + tile - 1) / tile) * (tile / kBN),
                  (num_p + kBM - 1) / kBM, num_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src == 2)
    old_band_pc_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else
    old_band_pc_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K10's PC of one segment: f32 planes [B, P, x_len] -> f32 planes [B, P,
// num_g] at g0; taps tr, ti [lh]; 128-gate tiles, tiles_per_run a block.
int rv_ring_pc(const void* xr, const void* xi, long long x_len, const void* tr,
               const void* ti, int lh, int window, int tiles_per_run,
               int ntiles, int num_b, int num_p, int j_len, int g0, int num_g,
               void* outr, void* outi, void* stream) {
  if (tiles_per_run < 1 || window % 32 != 0) return (int)cudaErrorInvalidValue;
  const int ring = window + kTile;
  const size_t smem =
      (2 * (size_t)kRows * (padded(ring - 1) + 1) + 2 * (size_t)lh) * sizeof(float);
  cudaError_t err = allow_smem(ring_pc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ntiles + tiles_per_run - 1) / tiles_per_run,
                  (num_p + kRows - 1) / kRows, num_b);
  ring_pc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), x_len,
      static_cast<const float*>(tr), static_cast<const float*>(ti), lh, window,
      tiles_per_run, ntiles, num_p, j_len, g0, num_g, static_cast<float*>(outr),
      static_cast<float*>(outi));
  return (int)cudaGetLastError();
}

// mt [B, V, G] = D [V, P] @ pc[b] in f32; D as f32 planes.
int rv_mtd(const void* dr, const void* di, const void* pcr, const void* pci,
           int num_b, int num_v, int num_p, int num_g, void* mtr, void* mti,
           void* stream) {
  const dim3 grid((num_g + kBN - 1) / kBN, (num_v + kBM - 1) / kBM, num_b);
  mtd_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const float*>(pcr), static_cast<const float*>(pci), num_v,
      num_p, num_g, static_cast<float*>(mtr), static_cast<float*>(mti));
  return (int)cudaGetLastError();
}

// out [B, V, G] complex64 = L mt (+ the rank-K signal), mt f32 planes.
int rv_mix_f32(const void* mtr, const void* mti, const void* lmat, int num_b,
               int num_v, int num_g, const void* dv, const void* pb,
               const void* st_, int num_k, int round_out, void* out,
               void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  return launch_mix<float>(mtr, mti, lmat, num_b, num_v, num_g,
                           make_signal(dv, pb, st_, num_k), round_out, out,
                           static_cast<cudaStream_t>(stream));
}

// K9's tail at f32: out [B, V, G] complex64 = L (D @ pc[c]) (+ signal).
int rv_mtd_mix(const void* dr, const void* di, const void* pcr,
               const void* pci, const void* lmat, int num_b, int num_v,
               int num_p, int num_g, const void* dv, const void* pb,
               const void* st_, int num_k, void* out, void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  return launch_mtd_mix<float>(dr, di, pcr, pci, lmat, num_b, num_v, num_p,
                               num_g, make_signal(dv, pb, st_, num_k), out,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
"""
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F, _LL = ctypes.c_float, ctypes.c_longlong
OLD_SIGNATURES = {
    "rv_old_band_pc": [_I, _P, _P, _LL, _I, _I, _U, _U, _F, _P, _P, _I, _I,
                       _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "rv_ring_pc": [_P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P],
    "rv_mtd": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "rv_mix_f32": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    "rv_mtd_mix": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P,
                   _P],
}
RESIDENT_RUN = 5       # most 128-gate tiles a block of the old K10 owned
SCHEDULES = ("resident", "stacked", "allbeams")


def build(build_dir: str) -> ctypes.CDLL:
    """The copy of rdm_variants.cu with OLD_HELPERS and OLD_F32 appended,
    built and loaded."""
    from ablate_k7_k8 import OLD_HELPERS

    from radar_tpu_torch import _build

    with open(os.path.join(_build._CSRC, "rdm_variants.cu")) as f:
        so = _compile({"old_f32": f.read() + OLD_HELPERS + OLD_F32},
                      build_dir)["old_f32"]
    lib = _load(so, "rdm_variants")
    for fn, argtypes in OLD_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def old_route(lib, plan):
    """The old f32 route as a stand-in for ``noise_rdm._variant_tf32``
    (same arguments), its constants' f32 planes made once here as the plan
    kept them: per segment per schedule the PC launches (K10's ring, else
    the banded GEMM on planes or draws), then K9's fused DFT + mix or the
    DFT GEMM and the mix."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    f32 = torch.float32
    taps = [torch.stack([s.taps.real, s.taps.imag]).contiguous()
            for s in plan.segments]
    mps = [torch.stack([s.mp.real, s.mp.imag]).contiguous()
           for s in plan.segments]
    dr, di = plan.d.real.contiguous(), plan.d.imag.contiguous()
    ck = lambda rc, what: _build.check(lib, rc, what)

    def run(_plan, l_factor, signal, seed, planes, schedule, out_dtype):
        dev = l_factor.device
        num_b, num_p = l_factor.shape[0], plan.n_pulses
        num_v, num_g = plan.n_dop, plan.n_gates
        lmat = l_factor.contiguous()
        num_k, sig_ptrs, _keep = nr._signal_args(signal, dev, num_b, num_v,
                                                 num_g)
        pcr = torch.empty((num_b, num_p, num_g), dtype=f32, device=dev)
        pci = torch.empty_like(pcr)
        stream = torch.cuda.current_stream(dev).cuda_stream
        s0, s1 = seed if seed is not None else (0, 0)
        for si, seg in enumerate(plan.segments):
            lh = seg.taps.shape[0]
            if planes is not None:
                xr, xi = nr._kernel_planes(planes, si, seg, dev, num_b,
                                           num_p, f32)
                x_ptrs, x_len = (xr.data_ptr(), xi.data_ptr()), xr.shape[2]
            else:
                x_ptrs, x_len = (None, None), 0
            if schedule == "resident":
                ntiles = -(-seg.j_len // seg.tile)
                per_run = -(-ntiles // -(-ntiles // RESIDENT_RUN))
                ck(lib.rv_ring_pc(*x_ptrs, x_len, taps[si][0].data_ptr(),
                                  taps[si][1].data_ptr(), lh, seg.window,
                                  per_run, ntiles, num_b, num_p, seg.j_len,
                                  seg.g0, num_g, pcr.data_ptr(),
                                  pci.data_ptr(), stream), "rv_ring_pc")
                continue
            ck(lib.rv_old_band_pc(0 if planes is not None else 2, *x_ptrs,
                                  x_len, seg.pad_front, si, s0, s1,
                                  ctypes.c_float(nr.U_SCALE),
                                  mps[si][0].data_ptr(), mps[si][1].data_ptr(),
                                  seg.window, seg.tile, lh, num_b, num_p,
                                  seg.j_len, seg.g0, num_g, pcr.data_ptr(),
                                  pci.data_ptr(), stream), "rv_old_band_pc")
        out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                          device=dev)
        if schedule == "allbeams":
            ck(lib.rv_mtd_mix(dr.data_ptr(), di.data_ptr(), pcr.data_ptr(),
                              pci.data_ptr(), lmat.data_ptr(), num_b, num_v,
                              num_p, num_g, *sig_ptrs, num_k, out.data_ptr(),
                              stream), "rv_mtd_mix")
            return out
        mtr = torch.empty((num_b, num_v, num_g), dtype=f32, device=dev)
        mti = torch.empty_like(mtr)
        ck(lib.rv_mtd(dr.data_ptr(), di.data_ptr(), pcr.data_ptr(),
                      pci.data_ptr(), num_b, num_v, num_p, num_g,
                      mtr.data_ptr(), mti.data_ptr(), stream), "rv_mtd")
        ck(lib.rv_mix_f32(mtr.data_ptr(), mti.data_ptr(), lmat.data_ptr(),
                          num_b, num_v, num_g, *sig_ptrs, num_k,
                          int(out_dtype != f32), out.data_ptr(), stream),
           "rv_mix_f32")
        return out

    return run


# the profiler's split: kernel-name fragments of each part
SPLIT = {"new": (("pc_gemm", "pc_gemm_kernel"), ("pc_drawn", "k4_pc_kernel"),
                 ("join", "join_kernel"), ("dft_gemm", "dft_gemm_kernel"),
                 ("mix_after", "mix_after_kernel")),
         "old": (("pc", "old_band_pc_kernel"), ("pc_ring", "ring_pc_kernel"),
                 ("dft", "mtd_gemm_kernel"), ("dft_mix", "mtd_mix_kernel"),
                 ("mix", "::mix_kernel<float>"))}


def _split(prof: dict, route: str) -> dict:
    """The profiler's ms a call by part; the rest (the wrapper's casts,
    pads and copies) as ``wrapper``."""
    out = {}
    for part, key in SPLIT[route]:
        ms = sum(v for k, v in prof.items() if key in k)
        if ms > 0.0:
            out[part] = ms
    out["wrapper"] = sum(prof.values()) - sum(out.values())
    return out


def measure(lib, plan, lmat, seed, reps: int) -> dict:
    """Each f32 schedule (and K7's draw mode), old and new: the hold
    against plain and the bit-for-bit checks, then the times in turns and
    the profiler's split."""
    import torch

    from radar_tpu_torch.ops import noise_rdm as nr

    num_b, num_p = lmat.shape[0], plan.n_pulses
    planes = nr.gen_noise_planes(plan, seed, num_b, device=lmat.device)
    z = torch.zeros((num_b, num_p, plan.s_compact), dtype=torch.complex64,
                    device=lmat.device)
    for seg, (xr, xi) in zip(plan.segments, planes):
        sl = slice(seg.pad_front, seg.pad_front + seg.r_len)
        z[:, :, seg.c0:seg.c0 + seg.r_len] = torch.complex(xr[..., sl],
                                                           xi[..., sl])
    ref = nr.noise_rdm_plain(plan, lmat, planes)
    new_route, old = nr._variant_tf32, old_route(lib, plan)
    calls = {}
    for v in SCHEDULES:
        calls[v] = lambda v=v: nr.noise_rdm_compact(z, plan, lmat,
                                                    variant=v).permute(2, 0, 1)
    calls["stacked_draw"] = lambda: nr.noise_rdm(plan, lmat, seed=seed,
                                                 stacked=True, layout="bvg")

    def with_route(route, fn):
        def run():
            nr._variant_tf32 = route
            try:
                return fn()
            finally:
                nr._variant_tf32 = new_route
        return run

    routes = {f"{r}_{k}": with_route(new_route if r == "new" else old, fn)
              for k, fn in calls.items() for r in ("old", "new")}
    outs = {k: fn() for k, fn in routes.items()}
    torch.cuda.synchronize()
    res = {"rms_err_over_rms": {k: _rel_rms(y, ref)
                                for k, y in outs.items()}}
    same = lambda a, b: bool(torch.equal(outs[a], outs[b]))
    res["identical"] = {
        "new_schedules": same("new_resident", "new_stacked")
        and same("new_resident", "new_allbeams"),
        "old_schedules": same("old_resident", "old_stacked")
        and same("old_resident", "old_allbeams"),
        "new_draw_equals_new_stacked": same("new_stacked_draw",
                                            "new_stacked"),
        "new_vs_old_max_abs": float(max(
            (outs[f"new_{v}"] - outs[f"old_{v}"]).abs().max()
            for v in SCHEDULES))}
    del outs, ref
    res["times"] = {}
    for k in calls:
        pair = {r: routes[f"{r}_{k}"] for r in ("old", "new")}
        t = in_turns(pair, reps)
        for r, fn in pair.items():
            t[r]["profile_ms"] = _split(_profile(fn, reps=3), r)
        res["times"][k] = t
    return res


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
        print("ablate_f32_schedules: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["noise_rdm", "noise_rdm_sm90", "rdm_variants"])
    lib = build(os.path.join(os.path.dirname(_build.BUILD_DIR),
                             "ablate_f32_schedules"))
    cfg = perf_config()
    lr = make_lowrank_stages(cfg, precompute(cfg), device="cuda")
    res = {"card": card, **measure(lib, lr.rplan, lr.l_factor,
                                   nr.seed_words(4242), args.reps)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
