// K10, K7, K9: the beam mix of the noise-RDM kernel studies' bf16 path
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
// mix_kernel is also the tail of K1's (and K4's) bf16 path (ops/
// noise_rdm.py::_bf16_chain; radar_tpu/ops/pallas_rdm.py::
// noise_rdm_pallas_gen at its default bf16 mul_dtype, whose rolling kernel
// mixes after the DFT too, _mix_vals :159-172, then adds the signal,
// :447-468). For the kernel-maps tail it writes, as the TPU kernel does
// from its resident f32 tiles (:469-478), the adjacent-beam pair maps
// |y_b| + |y_b+1| of the UNROUNDED f32 map (after the signal) into K2's
// padded qvg buffer, walking the beams in order with the previous beam's
// magnitude in a register: the maps cost their own bytes written and no
// second pass over the map. The magnitude is sqrt(re*re + im*im) rounded
// at each step, as the plain version's.
//
// What bounds it on this card. It reads the bf16 mt planes and writes the
// complex64 map (and the maps) once: at the perf frame's 13 x 332 x 3404,
// 58.8 MB read and 117.5 MB written, 0.0526 ms at 3.35 TB/s. Its FP32
// work is as large: 4B^2 FFMAs a cell for the mix (0.023 ms on every SM at
// 128 lanes a clock), and the rank-K signal adds 6K + 8BK operations a
// cell (the file is built with -fmad=false, so each is its own
// instruction): past K ~ 8 the operations bound it, not the bytes. A copy
// of this kernel with its loads and stores taken out (scripts/
// ablate_mix.py's diagnosis) takes 0.049 ms without the signal on an
// H100: the mix is as much an FP32-issue kernel as a bytes one. The
// design for that:
//   - a thread owns a run of consecutive cells of one Doppler row (two
//     without the signal and when holding every beam, one when walking
//     the beams with the signal: those measured fastest) and walks every
//     beam of them: each plane is read a run of bf16 values at a time (a
//     warp's request covers a whole 128-byte line), the map stored a run
//     of complex64 (16 bytes) and the maps a run of floats at a time; L
//     sits in shared memory, read two columns (16 bytes) at a time, each
//     read serving the run's cells; index arithmetic in 32 bits (rv_mix
//     refuses what would overflow); one run a thread, which keeps the
//     registers low enough for three blocks an SM: resident blocks
//     walking the runs with the next run's planes in registers measured
//     slower (more registers, fewer blocks an SM);
//   - the system's 13 beams are compiled in (loops unrolled, L's offsets
//     immediate, the planes in registers as f32); other counts up to 16
//     take the generic instance;
//   - the rank-K signal is factored as the TPU kernel factors it: each
//     cell's outer products dv[k,v] pb[k,g] are formed once, not once a
//     beam. With K <= kWalkK they stay in registers while the thread walks
//     the beams (st in shared memory); with more the thread holds every
//     beam's mixed value and adds the signal k by k to all beams, st
//     staged in shared memory kChunkK terms at a time and kKUnroll terms'
//     loads in flight together ("held"). Either way each beam's sum is
//     taken in the parent's order (the four fmaf chains over c, then yr =
//     rr - ii, yi = ri + ir, then the signal's terms k by k), so the map is
//     bit for bit what the first design (one thread a cell, L read for
//     every cell, the outer products formed once a beam; kept in
//     scripts/ablate_mix.py) wrote;
//   - shapes a wide run does not fit (an odd gate count, unaligned
//     pointers or maps strides) take the one-cell instance, the same
//     arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 16;     // beams a mix takes
constexpr int kLd = 16;       // L's row stride in shared memory (16-byte
                              // aligned pairs of columns)
// consecutive cells of a row a thread owns: without the signal, walking
// the beams with it (K <= kWalkK), and holding every beam (K > kWalkK)
constexpr int kRun = 2, kSigRun = 1, kHeldRun = 2;
static_assert(kSigRun == 1 || kSigRun == kRun, "one wide walking instance");
constexpr int kWalkK = 2;     // signal terms held while walking the beams
constexpr int kChunkK = 64;   // signal terms staged at a time (held)
constexpr int kKUnroll = 4;   // signal terms unrolled (held)
constexpr int kBeams = 13;    // the system's beam count, compiled in

// x rounded to bf16 (nearest even) and widened back to f32
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kRun-wide loads of the bf16 planes (the raw bits, widened to f32 later:
// the bits of a bf16 are the high half of its f32) and stores of the map
// and the maps
template <int R>
struct Run;
template <>
struct Run<1> {
  static __device__ __forceinline__ unsigned fetch(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void widen(unsigned u, float (&x)[1]) {
    x[0] = __uint_as_float(u << 16);
  }
  static __device__ __forceinline__ void store(float2* o,
                                               const float2 (&y)[1]) {
    *o = y[0];
  }
  static __device__ __forceinline__ void store(float* m,
                                               const float (&s)[1]) {
    *m = s[0];
  }
};
template <>
struct Run<2> {
  static __device__ __forceinline__ unsigned fetch(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned*>(p));
  }
  static __device__ __forceinline__ void widen(unsigned u, float (&x)[2]) {
    x[0] = __uint_as_float(u << 16);
    x[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(float2* o,
                                               const float2 (&y)[2]) {
    *reinterpret_cast<float4*>(o) = make_float4(y[0].x, y[0].y, y[1].x,
                                                y[1].y);
  }
  static __device__ __forceinline__ void store(float* m,
                                               const float (&s)[2]) {
    *reinterpret_cast<float2*>(m) = make_float2(s[0], s[1]);
  }
};

struct Signal {
  const float2* dv;      // [K, V]
  const float2* pb;      // [K, G]
  const float2* st;      // [K, B]
  int num_k;
};

// The pair maps' destination: column 0 of pair 0's interior in K2's padded
// qvg layout (row stride ld, plane stride plane), or none.
struct Maps {
  float* m;
  long long ld, plane;
};

// Beam b of the run's cells: y[e] = sum_c L[b,c] x_c as the TPU's two real
// contractions (lr.x and li.x, combined once), c ascending; unrounded. L's
// columns are read in pairs (one 16-byte shared load).
template <int MB, int R>
__device__ __forceinline__ void mix_beam(const float2* sl, int num_b, int b,
                                         const float (&xr)[MB][R],
                                         const float (&xi)[MB][R],
                                         float2 (&y)[R]) {
  float rr[R], ii[R], ri[R], ir[R];
#pragma unroll
  for (int e = 0; e < R; ++e) rr[e] = ii[e] = ri[e] = ir[e] = 0.f;
#pragma unroll
  for (int c = 0; c < MB; c += 2) {
    if (c < num_b) {
      const float4 l2 = *reinterpret_cast<const float4*>(sl + b * kLd + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c + h < num_b) {
          const float lx = h ? l2.z : l2.x, ly = h ? l2.w : l2.y;
#pragma unroll
          for (int e = 0; e < R; ++e) {
            rr[e] = fmaf(lx, xr[c + h][e], rr[e]);
            ii[e] = fmaf(ly, xi[c + h][e], ii[e]);
            ri[e] = fmaf(lx, xi[c + h][e], ri[e]);
            ir[e] = fmaf(ly, xr[c + h][e], ir[e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < R; ++e) y[e] = make_float2(rr[e] - ii[e], ri[e] + ir[e]);
}

// The outer product dv[k,v] pb[k,g] of each cell of the run
template <int R>
__device__ __forceinline__ void outer(const Signal& s, int k, int num_v,
                                      int num_g, int v, int g, float (&orr)[R],
                                      float (&oi)[R]) {
  const float2 a = s.dv[k * num_v + v];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const float2 c = s.pb[k * num_g + g + e];
    orr[e] = a.x * c.x - a.y * c.y;
    oi[e] = a.x * c.y + a.y * c.x;
  }
}

// One signal term st * outer added to beam values y (the parent's order)
template <int R>
__device__ __forceinline__ void add_term(float2 st, const float (&orr)[R],
                                         const float (&oi)[R],
                                         float2 (&y)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    y[e].x += st.x * orr[e] - st.y * oi[e];
    y[e].y += st.x * oi[e] + st.y * orr[e];
  }
}

// Beam b's values out: the pair map of beams b-1 and b (prev holds b-1's
// magnitudes), the rounding, the store
template <int R>
__device__ __forceinline__ void emit(int b, float2 (&y)[R], float (&prev)[R],
                                     float* m, int plane, int round_out,
                                     float2* o) {
  if (m != nullptr) {
    float mag[R], pair[R];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      mag[e] = __fsqrt_rn(
          __fadd_rn(__fmul_rn(y[e].x, y[e].x), __fmul_rn(y[e].y, y[e].y)));
      pair[e] = __fadd_rn(prev[e], mag[e]);
      prev[e] = mag[e];
    }
    if (b > 0) Run<R>::store(m + (b - 1) * plane, pair);
  }
  if (round_out) {
#pragma unroll
    for (int e = 0; e < R; ++e)
      y[e] = make_float2(rnd_bf16(y[e].x), rnd_bf16(y[e].y));
  }
  Run<R>::store(o, y);
}

// NB: the beam count compiled in (0: num_b at run time, up to kMaxB); R:
// the cells a thread owns (one run a thread); kHeld: every beam's values
// held, the signal added k by k to all of them (any K, st staged in
// shared memory kChunkK terms at a time), else the beams walked with K <=
// kWalkK outer products in registers.
template <int NB, int R, bool kHeld>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const __nv_bfloat16* __restrict__ mtr,
           const __nv_bfloat16* __restrict__ mti,
           const float2* __restrict__ lmat, int num_b_arg, int num_v,
           int num_g, Signal s, int round_out, Maps maps,
           float2* __restrict__ out) {
  constexpr int MB = NB ? NB : kMaxB;
  const int num_b = NB ? NB : num_b_arg;
  __shared__ __align__(16) float2 sl[kMaxB * kLd];
  __shared__ float2 sst[kChunkK * kMaxB];
  for (int j = threadIdx.x; j < kMaxB * kLd; j += kThreads) {
    const int r = j / kLd, c = j - r * kLd;
    sl[j] = r < num_b && c < num_b ? lmat[r * num_b + c]
                                   : make_float2(0.f, 0.f);
  }
  if constexpr (!kHeld)
    for (int j = threadIdx.x; j < s.num_k * num_b; j += kThreads)
      sst[j] = s.st[j];
  __syncthreads();
  const int pg = num_v * num_g;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * R;
  const bool active = i < pg;
  if (!kHeld && !active) return;
  const int v = i / num_g, g = i - v * num_g;
  float xr[MB][R], xi[MB][R];
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    if (c < num_b && active) {
      Run<R>::widen(Run<R>::fetch(mtr + c * pg + i), xr[c]);
      Run<R>::widen(Run<R>::fetch(mti + c * pg + i), xi[c]);
    }
  }
  float* m = maps.m == nullptr ? nullptr : maps.m + v * (int)maps.ld + g;
  const int plane = (int)maps.plane;
  float prev[R];
#pragma unroll
  for (int e = 0; e < R; ++e) prev[e] = 0.f;
  if constexpr (kHeld) {
    float2 y[MB][R];
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < num_b && active) mix_beam<MB, R>(sl, num_b, b, xr, xi, y[b]);
    for (int k0 = 0; k0 < s.num_k; k0 += kChunkK) {
      const int kn = min(kChunkK, s.num_k - k0);
      __syncthreads();
      for (int j = threadIdx.x; j < kn * num_b; j += kThreads)
        sst[j] = s.st[k0 * num_b + j];
      __syncthreads();
      if (!active) continue;
#pragma unroll (kKUnroll)
      for (int k = 0; k < kn; ++k) {
        float orr[R], oi[R];
        outer<R>(s, k0 + k, num_v, num_g, v, g, orr, oi);
#pragma unroll
        for (int b = 0; b < MB; ++b)
          if (b < num_b) add_term<R>(sst[k * num_b + b], orr, oi, y[b]);
      }
    }
    if (!active) return;
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < num_b) emit<R>(b, y[b], prev, m, plane, round_out,
                             out + b * pg + i);
  } else {
    float orr[kWalkK][R], oi[kWalkK][R];
#pragma unroll
    for (int k = 0; k < kWalkK; ++k)
      if (k < s.num_k) outer<R>(s, k, num_v, num_g, v, g, orr[k], oi[k]);
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      if (b < num_b) {
        float2 y[R];
        mix_beam<MB, R>(sl, num_b, b, xr, xi, y);
#pragma unroll
        for (int k = 0; k < kWalkK; ++k)
          if (k < s.num_k) add_term<R>(sst[k * num_b + b], orr[k], oi[k], y);
        emit<R>(b, y, prev, m, plane, round_out, out + b * pg + i);
      }
    }
  }
}

template <int NB, int R, bool kHeld>
int start_mix(const void* mtr, const void* mti, const void* lmat, int num_b,
              int num_v, int num_g, Signal s, int round_out, Maps maps,
              void* out, cudaStream_t st) {
  const long long runs = ((long long)num_v * num_g) / R;
  mix_kernel<NB, R, kHeld>
      <<<(unsigned)((runs + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(mtr),
          static_cast<const __nv_bfloat16*>(mti),
          static_cast<const float2*>(lmat), num_b, num_v, num_g, s,
          round_out, maps, static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// The instance for the beam count NB, K and the run width r (kRun,
// kSigRun or kHeldRun, or 1 where that does not fit the shapes)
template <int NB>
int launch_mix(int r, const void* mtr, const void* mti, const void* lmat,
               int num_b, int num_v, int num_g, Signal s, int round_out,
               Maps maps, void* out, cudaStream_t st) {
  if (s.num_k > kWalkK)
    return r > 1 ? start_mix<NB, kHeldRun, true>(mtr, mti, lmat, num_b,
                                                 num_v, num_g, s, round_out,
                                                 maps, out, st)
                 : start_mix<NB, 1, true>(mtr, mti, lmat, num_b, num_v,
                                          num_g, s, round_out, maps, out, st);
  return r > 1 ? start_mix<NB, kRun, false>(mtr, mti, lmat, num_b, num_v,
                                            num_g, s, round_out, maps, out, st)
               : start_mix<NB, 1, false>(mtr, mti, lmat, num_b, num_v, num_g,
                                         s, round_out, maps, out, st);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  const long long pg = (long long)num_v * num_g;
  if (num_b < 1 || num_b > kMaxB || num_k < 0 || num_v < 0 || num_g < 0 ||
      num_b * pg >= (1LL << 31) ||
      (maps != nullptr && (num_v * ld >= (1LL << 31) ||
                           num_b * plane >= (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  if (pg == 0) return 0;
  const Signal s{static_cast<const float2*>(dv),
                 static_cast<const float2*>(pb),
                 static_cast<const float2*>(st_), num_k};
  const Maps mp{static_cast<float*>(maps), ld, plane};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // a run of r cells stays in one row, and its loads and stores are
  // aligned, when G and the maps' strides are multiples of r
  int r = num_k == 0 ? kRun : num_k <= kWalkK ? kSigRun : kHeldRun;
  if (num_g % r != 0 || !aligned(mtr, 2 * r) || !aligned(mti, 2 * r) ||
      !aligned(out, 8 * r) ||
      (maps != nullptr &&
       (ld % r != 0 || plane % r != 0 || !aligned(maps, 4 * r))))
    r = 1;
  return num_b == kBeams
             ? launch_mix<kBeams>(r, mtr, mti, lmat, num_b, num_v, num_g, s,
                                  round_out, mp, out, cs)
             : launch_mix<0>(r, mtr, mti, lmat, num_b, num_v, num_g, s,
                             round_out, mp, out, cs);
}

}  // extern "C"
