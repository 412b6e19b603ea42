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
