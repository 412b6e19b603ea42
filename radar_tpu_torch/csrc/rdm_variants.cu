// K7, K8, K9, K10: the parts of the noise-RDM kernel studies for NVIDIA
// Hopper (sm_90a) that live here.
//
// Replace the TPU kernels behind radar_tpu/ops/pallas_rdm.py::
// noise_rdm_pallas(z, plan, L, mul_dtype=, variant=) and the banded-PC
// study radar_tpu/studies/pallas_pc.py:
//   K10 variant="resident": noise_rdm_pallas_planes, body
//       _make_kernel_resident (pallas_call :789);
//   K7  variant="stacked": _call_stacked, body _make_kernel_stacked (:627),
//       and the stacked=True products of the rolling draw kernel
//       _make_kernel_gen_rolling (draw mode, Philox draws as K1's);
//   K9  variant="allbeams": _call_allbeams, body _make_kernel_allbeams
//       (:1088);
//   K8  studies/pallas_pc.py::pulse_compress_noise_pallas, body
//       _make_seg_kernel (:150): the banded PC alone, f32 out.
//
// Per segment, with x the white planes, M the banded filter [W, T], D the
// MTD DFT [V, P] and L the 13x13 Cholesky factor, the RDM variants compute
//
//   rdm[b] = sum_c L[b,c] * D @ PC_seg(x_c)   (+ the rank-K signal)
//
// in the TPU's arithmetic for a multiply type T (float, or bf16 as the TPU
// runs it), the beam mix AFTER the DFT. What runs where:
//   f32 (K10, K7, K9 and K7's draw mode): K1's 3xTF32 tensor-core GEMMs of
//       noise_rdm_sm90.cu (strip-GEMM PC, DFT GEMM, then its mix-after
//       epilogue), one sequence for the three schedules;
//   bf16 planes (K10, K7, K9): the strip GEMM of band_pc_sm90.cu, the
//       wgmma DFT GEMM of rdm_sm90.cu, then mix_kernel (here);
//   bf16 draw mode (K7, stacked=True): band_pc_tc_kernel (here), whose
//       Philox draws are made in the GEMM's loads (TMA cannot draw), then
//       the DFT GEMM and mix_kernel;
//   K8: bf16 the staging kernel and strip GEMM of band_pc_sm90.cu; f32
//       band_pc_kernel (here) on the compact cube, on the CUDA cores.
// At bf16 every operand is a bf16 value (the wrapper rounds the constants,
// the kernels round what they draw or read), products accumulate in f32,
// and the PC and MTD results are rounded to bf16; rounding is to nearest
// even (__float2bfloat16_rn), as torch's .to(torch.bfloat16) and JAX's
// astype; storing an intermediate as bf16 is its rounding. A bf16 x bf16
// product is exact in f32, so the tensor cores compute what the TPU's MXU
// computes up to the order of the f32 sums.
//
// What bounds them on this card: operations. At the full perf shape (13
// beams, 332 pulses, 3404 gates, filters of 35/200/700 taps) the
// convolutions are 8.1e9 complex MACs: with bf16 operands the tensor cores
// could take them in 0.07 ms; K8's f32 PC 0.97 ms at the 67 TFLOP/s
// CUDA-core peak. The mix reads the bf16 mt planes and writes the f32 map
// once: bytes.
//
// What the designs do about it. band_pc_tc_kernel: a 64x64 complex tile a
// block on mma.sync m16n8k16 fragments, 32-deep k steps, the four real
// accumulators of the stacked product (re*re, im*im, re*im, im*re: its
// four quadrants, combined once at the end as the TPU combines them),
// synchronous scalar staging; a block walks only the rows of M its columns
// touch (column n of M is nonzero in rows n .. n+taps-1), so the all-zero
// part of the band costs nothing. band_pc_kernel: the same tiling on the
// CUDA cores, a 4x4 register tile a thread, 16-deep k steps. mix_kernel: a
// thread owns one (v, g) of every beam, L in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 16;     // beams a mix holds in registers
constexpr int kBM = 64, kBN = 64, kBK = 16;   // GEMM block tile

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

// ------------------------------------------------------------ banded PC

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

// ------------------------------------------- bf16 tensor-core GEMM

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

// ------------------------------------------------------------ the mix

struct Signal {
  const float2* dv;      // [K, V]
  const float2* pb;      // [K, G]
  const float2* st;      // [K, B]
  int num_k;
};

// y[b] = sum_c L[b,c] x[c] as the TPU's two real contractions (lr.x and
// li.x, combined once), plus the rank-K signal, rounded when asked (the
// resident variant's bf16 output planes).
__device__ __forceinline__ float2 mix_out(const float2* sl, int num_b, int b,
                                          const float2 (&x)[kMaxB], int v,
                                          int g, int num_v, int num_g,
                                          const Signal& s, bool round_out) {
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
  if (round_out) {
    yr = rnd<__nv_bfloat16>(yr);
    yi = rnd<__nv_bfloat16>(yi);
  }
  return make_float2(yr, yi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ mtr, const T* __restrict__ mti,
           const float2* __restrict__ lmat, int num_b, int num_v, int num_g,
           Signal s, int round_out, float2* __restrict__ out) {
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
    for (int b = 0; b < num_b; ++b)
      out[b * pg + i] = mix_out(sl, num_b, b, x, v, g, num_v, num_g, s,
                                round_out != 0);
  }
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

template <typename T>
int launch_mix(const void* mtr, const void* mti, const void* lmat, int num_b,
               int num_v, int num_g, Signal s, int round_out, void* out,
               cudaStream_t st) {
  long long blocks = ((long long)num_v * num_g + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  mix_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(mtr), static_cast<const T*>(mti),
      static_cast<const float2*>(lmat), num_b, num_v, num_g, s, round_out,
      static_cast<float2*>(out));
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

// Banded PC of one segment, src 1 or 2. src 1 (K8, f32): the compact
// complex64 cube z [B, P, x_len], segment slice c0 .. c0+r_len after
// pad_front zeros -> complex64 out [B, P, num_g] at gate offset g0. src 2
// (K7's draw mode, bf16): Philox draws (K1's counters, key (s0, s1),
// segment index seg, zeros before pad_front) rounded to bf16 -> rounded
// bf16 planes outr, outi [B, P, num_g] at g0. mr, mi: the banded filter
// [window, tile] as f32 (holding bf16 values for src 2).
int rv_band_pc(int src, const void* z, long long x_len, int c0, int r_len,
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

// The bf16 schedules' mix: out [B, V, G] complex64 = L mt (+ sum_k st[k,b]
// dv[k,v] pb[k,g]) of the bf16 planes mtr, mti [B, V, G]; with round_out
// the output values are rounded to bf16.
int rv_mix(const void* mtr, const void* mti, const void* lmat, int num_b,
           int num_v, int num_g, const void* dv, const void* pb,
           const void* st_, int num_k, int round_out, void* out,
           void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  return launch_mix<__nv_bfloat16>(mtr, mti, lmat, num_b, num_v, num_g,
                                   make_signal(dv, pb, st_, num_k), round_out,
                                   out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
