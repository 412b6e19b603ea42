// K4 and K1c for NVIDIA Hopper (sm_90a), on the CUDA cores in f32.
//
// K4 (pc_window_kernel) replaces the TPU kernel radar_tpu/ops/pallas_rdm.py
// ::noise_rdm_pallas_gen(rolling=False, beams_per_step=k) (pallas_call
// :980, body _make_kernel_gen): the noise range-Doppler map
//
//   rdm[b] = D @ (sum_c L[b,c] * PC_seg(x_c)) + sum_k st[k,b] * dv[k] (x) pb[k]
//
// (the beam mix L commutes with the slow-time DFT D, so it is applied to
// the pulse-compressed cube, before D), the noise drawn inside the kernel
// (Philox, or given planes), one block convolving a window of k beams in
// turn. Launch sequence, all on the caller's stream:
//   1. pc_window_kernel, once per segment: white noise -> causal
//      convolution with the segment's matched filter -> pc [B, P, G]; with
//      k = B it mixes the beams in the block;
//   2. mix_kernel (k < B): pc[b] <- sum_c L[b,c] pc[c], in place;
//   3. mtd_kernel: out[b] = D [V,P] @ pc[b] [P,G] + rank-K signal, written
//      once as the [B, V, G] complex64 map.
// K1, the rolling schedule, runs on the tensor cores in noise_rdm_sm90.cu;
// its draw mode starts with K1c below.
//
// K1c (planes_kernel) replaces gen_noise_planes_pallas (:1052): it writes
// the white planes that K4 and K1's draw mode use (the Philox counters,
// key and rails of stage_window), so planes mode can be fed the same
// noise. Bound by the larger of its 8 bytes written per sample (163.5 MB
// at the full shape, 0.0488 ms at 3.35 TB/s) and its integer work: one
// Philox4x32-10 block per complex sample, of which it keeps 2 of 4 words,
// ten rounds of two 32x32->64 products (IMAD.WIDE, on the FMA-heavy pipe)
// and two 3-input XORs (LOP3, on the ALU pipe), the key schedule in
// uniform registers; at 64 lanes a pipe and 128 issued an SM and clock
// this is ~0.031 ms, so bytes bind. One launch covers every segment, a
// warp a row, 4 consecutive samples a lane, one 16-byte store to each
// plane.
//
// What bounds K4 on this card: FP32 CUDA-core FMAs. At the full perf shape
// (13 beams, 332 pulses, 3404 gates, filters of 35/200/700 taps) the
// convolutions are 8.1e9 complex MACs and the DFT 4.9e9, 5.2e10 real FMAs
// in all: 1.55 ms at the 67 TFLOP/s FP32 peak. Scratch: the pc cube,
// 13 x 332 x 3404 complex64 = 117 MB (mixed in place, so one buffer).
//
// What the design does about it: every operand and accumulator is f32.
// The convolution keeps each block's noise window in shared memory (8
// pulse rows x (128 + taps - 1) samples, re/im planes padded one word in
// 32 against bank conflicts) and each lane slides a register window over
// 4 contiguous output gates, so one shared load feeds 16 FMAs. The DFT is
// a 64x64x16 shared-memory tiled complex GEMM with a 4x4 register tile per
// thread. Draws are regenerated per window (counter-based) instead of
// being stored.
//
// K4's trouble spot is shared memory: a window of 13 beams x 8 pulse rows
// of the long segment (827 samples, re/im f32) would take ~690 KB, three
// times the 227 KB a block has. So K4 streams the beams through one staged
// window (54.5 KB) and keeps only each beam's 8 x 128 convolved gates
// (8 KB a beam, 104 KB for 13): ~164 KB in all, one block per SM.

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

// K1c: the per-segment white planes [B, P, xlen] that draw mode draws
// (same Philox counters, key and rails; zeros before pad_front), every
// segment in one launch: blockIdx.y is the segment, each warp one (beam,
// pulse) row, each lane kVec consecutive samples a step, stored with one
// 16-byte store to each plane when every xlen is a multiple of kVec
// (kAligned; the plan's rows are 128-sample multiples), one word at a time
// otherwise. The samples before pad_front are drawn too and masked to
// zeros (at most a few percent of a row): the loop body stays one straight
// run of kVec Philox blocks without branches, so the SASS count of its
// integer instructions is the work of a sample.
constexpr int kMaxSeg = 4;
constexpr int kVec = 4;

struct PlaneSeg {
  long long off_r, off_i;   // float offsets of the planes in `out`
  int pad_front, xlen;
};

struct PlaneTable {
  PlaneSeg seg[kMaxSeg];
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const PlaneTable t, uint2 key, float scale, int num_p,
              int rows, float* __restrict__ out) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const unsigned seg = blockIdx.y;
  PlaneSeg g = t.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i)
    if (seg == i) g = t.seg[i];
  const unsigned b = (unsigned)row / (unsigned)num_p;
  const unsigned p = (unsigned)row - b * (unsigned)num_p;
  float* xr = out + g.off_r + (long long)row * g.xlen;
  float* xi = out + g.off_i + (long long)row * g.xlen;
  for (int n0 = (threadIdx.x & 31) * kVec; n0 < g.xlen; n0 += 32 * kVec) {
    float vr[kVec], vi[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint4 w = philox4x32_10(
          make_uint4((unsigned)(n0 + k), p, b, seg), key);
      // zero before pad_front by a mask, not a branch (+0.0, as plain)
      const unsigned keep = n0 + k >= g.pad_front ? ~0u : 0u;
      vr[k] = __uint_as_float(__float_as_uint(uniform_rail(w.x, scale)) &
                              keep);
      vi[k] = __uint_as_float(__float_as_uint(uniform_rail(w.y, scale)) &
                              keep);
    }
    if (kAligned) {
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

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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

// K1c: every segment's draw-mode planes in one launch. table holds, per
// segment, pad_front, xlen and the float offsets of its re and im planes
// [num_b, num_p, xlen] in `out` (multiples of 4; out 16-byte aligned).
int k1c_planes(const long long* table, int n_seg, unsigned s0, unsigned s1,
               float scale, int num_b, int num_p, void* out, void* stream) {
  const long long rows = (long long)num_b * num_p;
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  PlaneTable t = {};
  bool aligned = true;
  for (int s = 0; s < n_seg; ++s) {
    const long long* e = table + 4 * s;
    if (e[1] < 1 || e[1] >= (1LL << 30) || e[2] % 4 || e[3] % 4)
      return (int)cudaErrorInvalidValue;
    t.seg[s] = {e[2], e[3], (int)e[0], (int)e[1]};
    aligned = aligned && e[1] % kVec == 0;
  }
  const dim3 grid((unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                  n_seg);
  auto kernel = aligned ? planes_kernel<true> : planes_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, make_uint2(s0, s1), scale, num_p, (int)rows,
      static_cast<float*>(out));
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
