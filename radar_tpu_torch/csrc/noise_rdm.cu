// K1c for NVIDIA Hopper (sm_90a), on the CUDA cores.
//
// K1c (planes_kernel) replaces radar_tpu/ops/pallas_rdm.py::
// gen_noise_planes_pallas (pallas_call :1052): it writes the white planes
// that K1's draw mode uses (the Philox counters, key and rails that K4's
// producers draw in noise_rdm_sm90.cu), so planes mode can be fed the same
// noise. Bound by the larger of its 8 bytes written per sample (163.5 MB
// at the full shape, 0.0488 ms at 3.35 TB/s) and its integer work: one
// Philox4x32-10 block per complex sample, of which it keeps 2 of 4 words,
// ten rounds of two 32x32->64 products (IMAD.WIDE, on the FMA-heavy pipe)
// and two 3-input XORs (LOP3, on the ALU pipe), the key schedule in
// uniform registers; at 64 lanes a pipe and 128 issued an SM and clock
// this is ~0.031 ms, so bytes bind. One launch covers every segment, a
// warp a row, 4 consecutive samples a lane, one 16-byte store to each
// plane. (K1 and K4 run on the tensor cores in noise_rdm_sm90.cu; the
// first, CUDA-core K4 is kept in scripts/ablate_k4_k9.py.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

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

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
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

}  // extern "C"
