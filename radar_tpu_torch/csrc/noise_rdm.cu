// K1c for NVIDIA Hopper (sm_90a), on the CUDA cores.
//
// K1c (planes_kernel) replaces radar_tpu/ops/pallas_rdm.py::
// gen_noise_planes_pallas (pallas_call :1052): it writes the white planes
// that K1's draw mode uses (the Philox counters, key and rails that K4's
// producers draw in noise_rdm_sm90.cu), so planes mode can be fed the same
// noise. In f32 (K1's 3xTF32 draw mode) bound by the larger of its 8 bytes
// written per sample (163.5 MB at the full shape, 0.0488 ms at 3.35 TB/s)
// and its integer work: one Philox4x32-10 block per complex sample, of
// which it keeps 2 of 4 words, ten rounds of two 32x32->64 products
// (IMAD.WIDE, on the FMA-heavy pipe) and two 3-input XORs (LOP3, on the
// ALU pipe), the key schedule in uniform registers; at 64 lanes a pipe and
// 128 issued an SM and clock this is ~0.031 ms, so bytes bind. In bf16 (the
// TPU kernel's default mul_dtype, K1's bf16 draw mode) each draw is rounded
// to nearest even as the TPU's `.astype(bfloat16)` rounds it, and the rows
// go straight into the strip GEMM's TMA layout: [B*P, ld] with ld = xlen
// rounded up to 8 (16-byte row strides), the pad columns zero; 4 bytes a
// sample, so the integer work binds. One launch covers every segment, a
// warp a row, 16 bytes of consecutive samples a lane (4 f32 or 8 bf16),
// one 16-byte store to each plane. (K1 and K4 run on the tensor cores in
// noise_rdm_sm90.cu; the first, CUDA-core K4 is kept in
// scripts/ablate_k4_k9.py.)

#include <cuda_bf16.h>
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
