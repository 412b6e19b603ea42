// K1: fused noise range-Doppler map for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel radar_tpu/ops/pallas_rdm.py::noise_rdm_pallas_gen
// (rolling=True, signal=...; bodies _make_kernel_gen_rolling,
// _draw_uniform_chunk, _mtd_store, _mix_vals) and its planes-input sibling
// noise_rdm_pallas_planes (body _make_kernel). Per PC segment it computes
//
//   rdm[b] = D @ (sum_c L[b,c] * PC_seg(x_c)) + sum_k st[k,b] * dv[k] (x) pb[k]
//
// (the beam mix L commutes with the slow-time DFT D, so it is applied to
// the pulse-compressed cube, before D). Launch sequence, all on the
// caller's stream:
//   1. pc_kernel, once per segment: white noise (Philox draws in draw mode,
//      given planes in planes mode) -> causal convolution with the
//      segment's matched filter -> un-mixed pc [B, P, G] (scratch).
//   2. mix_kernel: pc[b] <- sum_c L[b,c] pc[c], in place.
//   3. mtd_kernel: out[b] = D [V,P] @ pc[b] [P,G] + rank-K signal, written
//      once as the [B, V, G] complex64 map.
//
// What bounds it on this card: FP32 CUDA-core FMAs. At the full perf
// shape (13 beams, 332 pulses, 3404 gates, filters of 35/200/700 taps) the
// convolutions are 8.1e9 complex MACs and the DFT 4.9e9, 5.2e10 real FMAs
// in all: 1.55 ms at the 67 TFLOP/s FP32 peak. Scratch: the pc cube,
// 13 x 332 x 3404 complex64 = 117 MB (mixed in place, so one buffer).
//
// What the design does about it: every operand and accumulator is f32
// (no TF32, no bf16; tensor-core wgmma and a single fused pass are later
// work). The convolution keeps each block's noise window in shared memory
// (8 pulse rows x (128 + taps - 1) samples, re/im planes padded one word in
// 32 against bank conflicts) and each lane slides a register window over
// 4 contiguous output gates, so one shared load feeds 16 FMAs. The DFT is
// a 64x64x16 shared-memory tiled complex GEMM with a 4x4 register tile per
// thread. Draws are regenerated per window (counter-based, ~6.5x on the
// long segment) instead of being stored: Philox costs far less than the
// 117 MB round trip a stored noise cube would.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTile = 128;    // output gates per PC block (32 lanes x 4)
constexpr int kRows = 8;      // pulse rows per PC block (one warp each)
constexpr int kOuts = 4;      // contiguous output gates per lane
constexpr int kThreads = 256;
constexpr int kMaxB = 16;     // beams the mix kernel holds in registers

__host__ __device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

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

  for (int k = threadIdx.x; k < lh; k += kThreads) {
    const float2 h = taps[lh - 1 - k];
    th_r[k] = h.x;
    th_i[k] = h.y;
  }
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
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int p = p0 + warp;
  if (p >= num_p) return;
  const float* wr = sw_r + warp * wlp;
  const float* wi = sw_i + warp * wlp;
  const int t0 = (threadIdx.x & 31) * kOuts;
  // out[t] = sum_k h[lh-1-k] * w[t+k]; xr_[o] holds w[t0+k+o]
  float ar[kOuts], ai[kOuts], xr_[kOuts], xi_[kOuts];
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
  float2* row = pc + ((long long)b * num_p + p) * num_g + g0;
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int j = n0 + t0 + o;
    if (j < j_len) row[j] = make_float2(ar[o], ai[o]);
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
    for (int b = 0; b < kMaxB; ++b) {
      if (b < num_b) {
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
        pc[b * pg + i] = make_float2(yr, yi);
      }
    }
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

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
