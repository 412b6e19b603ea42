// K7, K8, K9, K10: the noise-RDM kernel studies for NVIDIA Hopper (sm_90a).
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
// With bf16 operands, K8 and the planes-mode PC of K7, K9 and K10 run the
// strip GEMM of band_pc_sm90.cu (TMA + wgmma), and their DFT the wgmma
// GEMM of rdm_sm90.cu (K9's then mix_kernel); here they run at f32, and
// K7's draw-mode PC at both types.
//
// Per segment, with x the white planes, M the banded filter [W, T], D the
// MTD DFT [V, P] and L the 13x13 Cholesky factor, the RDM variants compute
//
//   rdm[b] = sum_c L[b,c] * D @ PC_seg(x_c)   (+ the rank-K signal)
//
// in the TPU's arithmetic for a multiply type T (float, or bf16 as the TPU
// runs it): every operand is a T value (the wrapper rounds the constants,
// the kernels round what they draw or read), products accumulate in f32,
// the PC result and the MTD result are rounded to T, and the beam mix comes
// AFTER the rounded DFT (K1 mixes before the DFT, which is exact only in
// f32) and accumulates in f32. Rounding is to nearest even
// (__float2bfloat16_rn), as torch's .to(torch.bfloat16) and JAX's astype;
// storing an intermediate as T is its rounding, so pc and mt live in device
// memory as T planes. A bf16 x bf16 product is exact in f32, so the kernels
// compute what the TPU's MXU computes up to the order of the f32 sums (TF32
// would not: it rounds f32 operands, so f32 runs on the CUDA cores).
//
// Launches, all on the caller's stream:
//   K10: ring_pc_kernel per segment (bf16: the strip GEMM, one launch)
//        -> DFT GEMM (bf16: rdm_sm90.cu's dft_kernel) -> mix_kernel;
//   K7:  banded PC GEMM per segment (bf16 planes: the strip GEMM of
//        band_pc_sm90.cu) -> DFT GEMM (bf16: dft_kernel) -> mix_kernel;
//   K9:  the same PC -> mtd_mix_kernel (DFT of all beams, rounded, mixed in
//        the block: no mt round trip, one output write; bf16: K7's DFT GEMM
//        and mix_kernel, which measured faster than one wgmma kernel);
//   K8:  f32: banded PC GEMM per segment on the compact cube, f32 complex
//        out (bf16: band_pc_sm90.cu).
// The GEMMs (band_pc_kernel, mtd_gemm_kernel) run on the CUDA cores at f32;
// at bf16 K7's draw-mode PC runs on the tensor cores (band_pc_tc_kernel,
// whose Philox draws are made in the GEMM's loads, which TMA cannot do).
//
// What bounds them on this card: operations. At the full perf shape (13
// beams, 332 pulses, 3404 gates, filters of 35/200/700 taps) the
// convolutions are 8.1e9 complex MACs and the DFT 4.9e9: at f32, 1.55 ms
// at the 67 TFLOP/s CUDA-core peak; with bf16 operands the tensor cores
// could take it in 0.1 ms, where the bf16 planes and the f32 map are 0.2 GB
// (0.06 ms at 3.35 TB/s).
//
// What the designs do about it. The products run as shared-memory tiled
// complex GEMMs with 64x64 output tiles and the four real accumulators of
// the stacked product (re*re, im*im, re*im, im*re: its four quadrants,
// combined once at the end as the TPU combines them): on the CUDA cores a
// 4x4 register tile a thread, 16-deep k steps; on the tensor cores
// mma.sync m16n8k16 fragments, 32-deep k steps (synchronous scalar
// staging: K7's draw-mode PC only).
// - K7's PC is the stacked product [2P, W] x [W, 2T] per tile; a block
//   walks only the rows of M its columns touch (column n of M is nonzero in
//   rows n .. n+taps-1), so the all-zero part of the band costs nothing.
//   It takes the band in the convolution's sample order, so at f32 K7,
//   K9 and K10 agree bit for bit, as the TPU's schedules do.
// - K10 (f32) keeps what the TPU's resident buffer keeps: each plane sample
//   is read from device memory about once. A block owns one beam x 8 pulse
//   rows x a run of consecutive 128-gate tiles and slides a ring of W + 128
//   samples a row through shared memory, loading only the 128 new samples
//   of the next tile (into registers before the current tile's
//   convolution, stored after it). K1 planes mode re-reads each sample
//   W/T ~ 7x on the long segment. Its convolution is direct, tap by tap,
//   on the CUDA cores (one shared load feeds 16 FMAs), not the banded GEMM.
//   (At bf16 K10's PC is the strip GEMM of band_pc_sm90.cu.)
// - K9: the 13 beams' [V, T] DFT tiles of the TPU's step (4.4 MB) do not
//   fit a block (227 KB). One block per 32 Doppler rows x 32 gates forms the
//   DFT of every beam in turn on the CUDA cores, keeps the tiles in shared
//   memory (106 KB at f32), mixes them and writes the map once (at f32
//   only; bf16 runs K7's DFT GEMM and mix).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 16;     // beams a mix holds in registers
constexpr int kBM = 64, kBN = 64, kBK = 16;   // GEMM block tile
constexpr int kTile = 128;    // K10 gate tile
constexpr int kRows = 8;      // K10 pulse rows per block (one warp each)
constexpr int kOuts = 4;      // K10 contiguous gates per lane

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

__host__ __device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

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

enum Src { kPlanes = 0, kCompact = 1, kDraw = 2 };

struct PcArgs {
  const void* xr;        // kPlanes: T planes [B, P, x_len]
  const void* xi;
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
  void* outr;            // rounded T planes [B, P, num_g], or
  void* outi;
  float2* out;           // complex64 [B, P, num_g] (K8)
};

// Sample n of the segment buffer of (beam b, pulse p) as T values.
template <typename T, int kSrc>
__device__ __forceinline__ float2 load_sample(const PcArgs& a, int b, int p,
                                              int n) {
  const long long row = (long long)b * a.num_p + p;
  if (kSrc == kPlanes) {
    const T* xr = static_cast<const T*>(a.xr);
    const T* xi = static_cast<const T*>(a.xi);
    const long long off = row * a.x_len + n;
    return make_float2(Num<T>::f32(xr[off]), Num<T>::f32(xi[off]));
  }
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

// One 64-pulse x 64-gate block of the f32 PC of beam blockIdx.z: the
// stacked product of the window of its tile with the columns n0 .. n0+63
// of M, over M's rows n0 .. n0+63+lh-2 only (the rest of those columns is
// 0). bf16 runs band_pc_tc_kernel in draw mode, else band_pc_sm90.cu.
template <int kSrc, bool kRoundOut>
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
      if (p < a.num_p && k < k_hi) v = load_sample<float, kSrc>(a, b, p, col0 + k);
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
      const float cr = acc.rr[i][j] - acc.ii[i][j];
      const float ci = acc.ri[i][j] + acc.ir[i][j];
      const long long off = ((long long)b * a.num_p + p) * a.num_g + a.g0 + jg;
      if (kRoundOut) {
        static_cast<float*>(a.outr)[off] = cr;
        static_cast<float*>(a.outi)[off] = ci;
      } else {
        a.out[off] = make_float2(cr, ci);
      }
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

// band_pc_kernel on the tensor cores (bf16 operands), for draw mode.
template <int kSrc, bool kRoundOut>
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
        return m0 + m < a.num_p ? load_sample<T, kSrc>(a, b, m0 + m, col0 + k)
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
    if (kRoundOut) {
      static_cast<T*>(a.outr)[off] = __float2bfloat16_rn(cr);
      static_cast<T*>(a.outi)[off] = __float2bfloat16_rn(ci);
    } else {
      a.out[off] = make_float2(cr, ci);
    }
  });
}

// ------------------------------------------------------- K10 ring PC

// K10: one block per (run of tiles, 8 pulse rows, beam). The ring holds
// samples [s0 + r*128, s0 + r*128 + W) of each row at step r, sample i in
// slot (i - s0) mod C, C = W + 128; the next tile's 128 new samples go to
// the 128 free slots.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_pc_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
               long long x_len, const float* __restrict__ taps_r,
               const float* __restrict__ taps_i, int lh, int window,
               int tiles_per_run, int ntiles, int num_p, int j_len, int g0,
               int num_g, T* __restrict__ outr, T* __restrict__ outi) {
  extern __shared__ float smem[];
  const int ring = window + kTile;
  const int rp = padded(ring - 1) + 1;      // padded row stride (words)
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
      vr = Num<T>::f32(xr[off]);
      vi = Num<T>::f32(xi[off]);
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

  constexpr int kPer = kRows * kTile / kThreads;   // prefetched samples a thread
  for (int t = t_first; t < t_last; ++t) {
    const int rel = (t - t_first) * kTile;         // window start, ring-relative
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
      float xr_[kOuts], xi_[kOuts];               // xr_[o] = w[t0+k+o]
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
          outr[row + j] = Num<T>::from(rr[o] - ii[o]);
          outi[row + j] = Num<T>::from(ri[o] + ir[o]);
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

// ------------------------------------------------------------ the DFT

// mt[b] = D [V, P] @ pc[b] [P, G] in f32 (the TPU's mt scratch); bf16
// runs rdm_sm90.cu's dft_kernel.
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

// K9's tail: one block per 32 Doppler rows x 32 gates forms every beam's
// DFT tile in turn (a 2x2 register tile a thread), keeps it rounded to T in
// shared memory, then mixes the beams and writes the map once.
constexpr int kVT = 32, kGT = 32;

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

constexpr int kMaxSmem = 232448;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// f32 on the CUDA cores; bf16 (draw mode only: planes and the compact cube
// run the strip GEMM of band_pc_sm90.cu) on the tensor cores
int launch_band_pc(bool bf16, int src, const PcArgs& a, int num_b,
                   cudaStream_t st) {
  const dim3 grid(((a.j_len + a.tile - 1) / a.tile) * (a.tile / kBN),
                  (a.num_p + kBM - 1) / kBM, num_b);
  if (bf16) {
    if (src != kDraw) return (int)cudaErrorInvalidValue;
    band_pc_tc_kernel<kDraw, true><<<grid, kThreads, 0, st>>>(a);
  } else {
    if (src == kPlanes)
      band_pc_kernel<kPlanes, true><<<grid, kThreads, 0, st>>>(a);
    else if (src == kDraw)
      band_pc_kernel<kDraw, true><<<grid, kThreads, 0, st>>>(a);
    else
      band_pc_kernel<kCompact, false><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ring_pc(const void* xr, const void* xi, long long x_len,
                   const void* tr, const void* ti, int lh, int window,
                   int tiles_per_run, int ntiles, int num_b, int num_p,
                   int j_len, int g0, int num_g, void* outr, void* outi,
                   cudaStream_t st) {
  const int ring = window + kTile;
  const size_t smem =
      (2 * (size_t)kRows * (padded(ring - 1) + 1) + 2 * (size_t)lh) * sizeof(float);
  cudaError_t err = allow_smem(ring_pc_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ntiles + tiles_per_run - 1) / tiles_per_run,
                  (num_p + kRows - 1) / kRows, num_b);
  ring_pc_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi), x_len,
      static_cast<const float*>(tr), static_cast<const float*>(ti), lh, window,
      tiles_per_run, ntiles, num_p, j_len, g0, num_g, static_cast<T*>(outr),
      static_cast<T*>(outi));
  return (int)cudaGetLastError();
}

// f32 on the CUDA cores (bf16: rdm_sm90.cu's dft_kernel)
int launch_mtd(const void* dr, const void* di, const void* pcr,
               const void* pci, int num_b, int num_v, int num_p, int num_g,
               void* mtr, void* mti, cudaStream_t st) {
  const dim3 grid((num_g + kBN - 1) / kBN, (num_v + kBM - 1) / kBM, num_b);
  mtd_gemm_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const float*>(pcr), static_cast<const float*>(pci), num_v,
      num_p, num_g, static_cast<float*>(mtr), static_cast<float*>(mti));
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

Signal make_signal(const void* dv, const void* pb, const void* st, int num_k) {
  return Signal{static_cast<const float2*>(dv), static_cast<const float2*>(pb),
                static_cast<const float2*>(st), num_k};
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Banded PC of one segment (K7's and K9's PC stage, K8). bf16: operands are
// bf16 values, src 2 only. src 0: T planes xr, xi [B, P, x_len] -> rounded T planes
// outr, outi [B, P, num_g] at gate offset g0; src 2: the same from Philox
// draws (K1's counters, key (s0, s1)); src 1: the compact complex64 cube z
// [B, P, x_len], segment slice c0 .. c0+r_len after pad_front zeros ->
// complex64 out [B, P, num_g], not rounded (K8). mr, mi: the banded filter
// [window, tile] as f32 holding T values.
int rv_band_pc(int bf16, int src, const void* xr, const void* xi,
               const void* z, long long x_len, int c0, int r_len,
               int pad_front, int seg, unsigned s0, unsigned s1, float scale,
               const void* mr, const void* mi, int window, int tile, int lh,
               int num_b, int num_p, int j_len, int g0, int num_g, void* outr,
               void* outi, void* out, void* stream) {
  if (tile % kBN != 0 || src < 0 || src > 2 ||
      (src == kCompact ? out == nullptr : outr == nullptr))
    return (int)cudaErrorInvalidValue;
  PcArgs a{xr, xi, static_cast<const float2*>(z), x_len, c0, r_len,
           pad_front, (unsigned)seg, make_uint2(s0, s1), scale,
           static_cast<const float*>(mr), static_cast<const float*>(mi),
           window, tile, lh, num_p, j_len, g0, num_g, outr, outi,
           static_cast<float2*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_band_pc(bf16 != 0, src, a, num_b, st);
}

// K10's PC of one segment at f32 (bf16: band_pc_sm90.cu's strip GEMM): f32
// planes [B, P, x_len] -> f32 planes [B, P, num_g] at g0; taps tr, ti [lh];
// 128-gate tiles, tiles_per_run consecutive tiles a block.
int rv_ring_pc(const void* xr, const void* xi, long long x_len, const void* tr,
               const void* ti, int lh, int window, int tiles_per_run,
               int ntiles, int num_b, int num_p, int j_len, int g0, int num_g,
               void* outr, void* outi, void* stream) {
  if (tiles_per_run < 1 || window % 32 != 0) return (int)cudaErrorInvalidValue;
  return launch_ring_pc<float>(xr, xi, x_len, tr, ti, lh, window,
                               tiles_per_run, ntiles, num_b, num_p, j_len, g0,
                               num_g, outr, outi,
                               static_cast<cudaStream_t>(stream));
}

// mt [B, V, G] = D [V, P] @ pc[b] in f32 (bf16: rdm_sm90.cu's rs_dft); D
// as f32 planes.
int rv_mtd(const void* dr, const void* di, const void* pcr, const void* pci,
           int num_b, int num_v, int num_p, int num_g, void* mtr, void* mti,
           void* stream) {
  return launch_mtd(dr, di, pcr, pci, num_b, num_v, num_p, num_g, mtr, mti,
                    static_cast<cudaStream_t>(stream));
}

// out [B, V, G] complex64 = L mt (+ sum_k st[k,b] dv[k,v] pb[k,g]); with
// round_out the output values are rounded to bf16.
int rv_mix(int bf16, const void* mtr, const void* mti, const void* lmat,
           int num_b, int num_v, int num_g, const void* dv, const void* pb,
           const void* st_, int num_k, int round_out, void* out, void* stream) {
  if (num_b > kMaxB) return (int)cudaErrorInvalidValue;
  const Signal s = make_signal(dv, pb, st_, num_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mix<__nv_bfloat16>(mtr, mti, lmat, num_b, num_v, num_g, s,
                                          round_out, out, st)
              : launch_mix<float>(mtr, mti, lmat, num_b, num_v, num_g, s,
                                  round_out, out, st);
}

// K9's tail at f32: out [B, V, G] complex64 = L (D @ pc[c]) (+ signal)
// (bf16: rs_dft, then rv_mix).
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
