// K1c for NVIDIA Hopper (sm_90a), on the CUDA cores.
//
// K1c (planes_kernel) replaces radar_tpu/ops/pallas_rdm.py::
// gen_noise_planes_pallas (pallas_call :1052): it writes the white planes
// that K1's draw mode uses (the Philox counters, key and rails that K4's
// producers and the strip GEMM's draw mode draw), so planes mode can be fed
// the same noise. In f32 (K1's 3xTF32 draw mode) it writes 8 bytes a sample
// (163.5 MB at the full shape, 0.0488 ms at 3.35 TB/s); in bf16 (the TPU
// kernel's default mul_dtype, K1's bf16 draw mode) 4 bytes a sample, each
// draw rounded to nearest even as the TPU's `.astype(bfloat16)` rounds it,
// the rows straight in the strip GEMM's TMA layout: [B*P, ld] with ld =
// xlen rounded up to 8 (16-byte row strides), the pad columns zero.
//
// What bounds it is the Philox work against those bytes. A Philox4x32-10
// block is ten rounds of two 32x32->64 products (IMAD.WIDE, two slots of
// the FMA-heavy pipe: 32 lanes a clock an SM on an H100, half the IMAD
// rate, by scripts/ablate_planes.py's probe) and two 3-input XORs (LOP3,
// ALU pipe); the key schedule is uniform. The design draws two samples
// from each block, all four words (philox.cuh: block m gives samples 2m
// and 2m + 1), so a sample costs five rounds of products, half of what a
// block a sample cost; a thread's 16-byte vector (8 bf16 or 4 f32
// samples) runs its 4 or 2 blocks as independent chains whose first two
// rounds' shared products (same pulse, beam and segment) the compiler
// computes once. Splitting a product into IMAD.HI + IMAD costs three slots
// to IMAD.WIDE's two (measured slower), so the products stay whole.
//
// The grid is persistent: one launch covers every segment, each segment
// gets blocks in proportion to its vectors, and a thread walks its
// segment's interior [B*P rows, vectors] flat by a grid stride, its (beam,
// pulse, column) stepped by additions (no division in the loop), so no lane
// idles at a row's end and a short segment's blocks do not finish early.
// The interior vectors (every sample at or past pad_front and before xlen)
// need no masks: one straight run of Philox blocks, rails and one 16-byte
// store to each plane (kAligned: every row length a multiple of the
// vector; the plan's rows are 128-sample multiples, bf16 rows padded to 8;
// one value at a time otherwise), so the SASS count of that loop is the
// work of a sample. The few edge vectors follow in a second loop, the
// same draws masked sample by sample (zeros, as plain): the 128-byte lines
// of a row that hold samples before pad_front or from xlen on (8 of
// segment 0's 48 bf16 vectors a row at the perf plan, 8 of its 96 f32
// ones), whole lines so that no line is written partly by each loop (the
// f32 planes, bound by their stores, lose ~4% to such lines). (K1 and K4 run on the tensor
// cores in noise_rdm_sm90.cu; the K1c that drew a block a sample, a warp a
// row, is kept in scripts/ablate_planes.py.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
// 8 blocks of 256 an SM (32 registers a thread): the f32 planes are bound
// by their stores, which want every warp the SM holds in flight
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSeg = 4;

struct PlaneSeg {
  long long off_r, off_i;   // offsets of the planes in `out`, in T's
  int pad_front, xlen;
  int ld;                   // a row's values: xlen, or in bf16 xlen -> 8
  int vecs;                 // vectors a row: ld / kVec rounded up
  int c_lo, n_in;           // the interior vectors: c_lo .. c_lo + n_in - 1
  int blk0, blocks;         // the segment's blocks
  int step_col, step_p, step_b;   // a grid stride in interior (column,
  long long step_off;             // pulse, beam) and in a plane's values
  int wrap_off;             // a column wrap's offset: ld - n_in * kVec
};

struct PlaneTable {
  PlaneSeg seg[kMaxSeg];
};

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// An item's kVec samples of each plane at xr, xi: one 16-byte streaming
// store to each (the planes are written once and read later) when the rows
// are aligned (bf16 rows always are), else the first `valid` values one at
// a time.
template <typename T, bool kAligned, int kVec>
__device__ __forceinline__ void store_vec(T* xr, T* xi, const float (&vr)[kVec],
                                          const float (&vi)[kVec], int valid) {
  if constexpr (sizeof(T) == 2) {
    // nearest even, two values a word
    __stcs(reinterpret_cast<uint4*>(xr),
           make_uint4(bf16_pair(vr[0], vr[1]), bf16_pair(vr[2], vr[3]),
                      bf16_pair(vr[4], vr[5]), bf16_pair(vr[6], vr[7])));
    __stcs(reinterpret_cast<uint4*>(xi),
           make_uint4(bf16_pair(vi[0], vi[1]), bf16_pair(vi[2], vi[3]),
                      bf16_pair(vi[4], vi[5]), bf16_pair(vi[6], vi[7])));
  } else if constexpr (kAligned) {
    __stcs(reinterpret_cast<float4*>(xr),
           make_float4(vr[0], vr[1], vr[2], vr[3]));
    __stcs(reinterpret_cast<float4*>(xi),
           make_float4(vi[0], vi[1], vi[2], vi[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < valid) {
        xr[k] = vr[k];
        xi[k] = vi[k];
      }
  }
}

// K1c: the per-segment white planes [B, P, xlen] that draw mode draws
// (zeros before pad_front and, in bf16, from xlen to ld). An item: kVec
// consecutive samples n0 .. n0 + kVec - 1 of a row (n0 even), from the
// kVec / 2 Philox blocks m = n0 / 2 + j, counter (m, p, b, seg).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
planes_kernel(const PlaneTable t, int n_seg, uint2 key, float scale,
              int num_p, int num_b, T* __restrict__ out) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kBlocks = kVec / 2;
  int seg = 0;
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i)
    if (i < n_seg && (int)blockIdx.x >= t.seg[i].blk0) seg = i;
  PlaneSeg g = t.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSeg; ++i)
    if (seg == i) g = t.seg[i];
  const int i0 = ((int)blockIdx.x - g.blk0) * kThreads + (int)threadIdx.x;
  if (g.n_in > 0) {
    // the thread's first interior item; then a grid stride at a time
    const int row0 = i0 / g.n_in;
    int col = i0 - row0 * g.n_in;
    int b = row0 / num_p;
    int p = row0 - b * num_p;
    long long off = (long long)row0 * g.ld + (long long)(g.c_lo + col) * kVec;
    while (b < num_b) {
      const int n0 = (g.c_lo + col) * kVec;
      unsigned m[kBlocks];
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) m[j] = (unsigned)(n0 / 2 + j);
      uint4 w[kBlocks];
      philox_lanes(m, (unsigned)p, (unsigned)b, (unsigned)seg, key, w);
      float vr[kVec], vi[kVec];
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        vr[2 * j] = uniform_rail(w[j].x, scale);
        vi[2 * j] = uniform_rail(w[j].y, scale);
        vr[2 * j + 1] = uniform_rail(w[j].z, scale);
        vi[2 * j + 1] = uniform_rail(w[j].w, scale);
      }
      store_vec<T, kAligned>(out + g.off_r + off, out + g.off_i + off, vr, vi,
                             kVec);
      // the next item, a grid stride on: carries from column to pulse to
      // beam
      col += g.step_col;
      p += g.step_p;
      b += g.step_b;
      off += g.step_off;
      if (col >= g.n_in) {
        col -= g.n_in;
        ++p;
        off += g.wrap_off;
      }
      if (p >= num_p) {
        p -= num_p;
        ++b;
      }
    }
  }
  // the edge items, each sample masked (+0.0 before pad_front and from xlen
  // on, as plain)
  const int n_edge = g.vecs - g.n_in;
  for (int e = i0; e < num_b * num_p * n_edge; e += g.blocks * kThreads) {
    const int row = e / n_edge;
    const int k = e - row * n_edge;
    const int n0 = (k < g.c_lo ? k : k + g.n_in) * kVec;
    const int b = row / num_p;
    unsigned m[kBlocks];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) m[j] = (unsigned)(n0 / 2 + j);
    uint4 w[kBlocks];
    philox_lanes(m, (unsigned)(row - b * num_p), (unsigned)b, (unsigned)seg,
                 key, w);
    float vr[kVec], vi[kVec];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const int n = n0 + 2 * j;
      const bool keep0 = n >= g.pad_front && n < g.xlen;
      const bool keep1 = n + 1 >= g.pad_front && n + 1 < g.xlen;
      vr[2 * j] = keep0 ? uniform_rail(w[j].x, scale) : 0.f;
      vi[2 * j] = keep0 ? uniform_rail(w[j].y, scale) : 0.f;
      vr[2 * j + 1] = keep1 ? uniform_rail(w[j].z, scale) : 0.f;
      vi[2 * j + 1] = keep1 ? uniform_rail(w[j].w, scale) : 0.f;
    }
    const long long off = (long long)row * g.ld + n0;
    store_vec<T, kAligned>(out + g.off_r + off, out + g.off_i + off, vr, vi,
                           g.ld - n0);
  }
}

// Blocks of planes_kernel an SM keeps resident, and the SMs, of the
// current device (kept per device).
int resident_blocks(bool bf16, bool aligned) {
  static int cached[64][3];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  const int which = bf16 ? 0 : aligned ? 1 : 2;
  if (cached[dev][which] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const void* fn =
        bf16 ? (const void*)planes_kernel<__nv_bfloat16, true>
             : aligned ? (const void*)planes_kernel<float, true>
                       : (const void*)planes_kernel<float, false>;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
    cached[dev][which] = sms * per_sm;
  }
  return cached[dev][which];
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
  if (n_seg < 1 || n_seg > kMaxSeg || num_b < 1 || num_p < 1 ||
      rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int vec = bf16 ? 8 : 4;
  PlaneTable t = {};
  bool aligned = true;
  long long items[kMaxSeg] = {}, total = 0;
  for (int s = 0; s < n_seg; ++s) {
    const long long* e = table + 4 * s;
    if (e[1] < 1 || e[1] >= (1LL << 30) || e[2] % vec || e[3] % vec)
      return (int)cudaErrorInvalidValue;
    const int ld = bf16 ? (int)((e[1] + 7) / 8 * 8) : (int)e[1];
    const int vecs = (ld + vec - 1) / vec;
    // interior vectors: starting at or past pad_front, ending by xlen, in
    // whole 128-byte lines of the row (8 vectors), so that no line is
    // written partly by each loop
    const int c_lo = (int)((e[0] + 8 * vec - 1) / (8 * vec)) * 8;
    const int c_hi = (int)(e[1] / (8 * vec)) * 8;
    const int n_in = c_hi > c_lo ? c_hi - c_lo : 0;
    items[s] = rows * vecs;
    if (items[s] >= (1LL << 31) - (1LL << 24)) return (int)cudaErrorInvalidValue;
    total += items[s];
    t.seg[s] = {e[2], e[3], (int)e[0], (int)e[1], ld, vecs, c_lo, n_in};
    aligned = aligned && ld % vec == 0;
  }
  const int resident = resident_blocks(bf16, aligned);
  if (resident < 1) return (int)cudaErrorInvalidValue;
  // blocks in proportion to each segment's vectors, each at least one and
  // at most one item a thread
  int blk0 = 0;
  for (int s = 0; s < n_seg; ++s) {
    PlaneSeg& g = t.seg[s];
    const long long want = (long long)resident * items[s] / total;
    const long long most = (items[s] + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 1 ? 1 : want > most ? most : want);
    const long long stride = (long long)blocks * kThreads;
    g.blk0 = blk0;
    g.blocks = blocks;
    if (g.n_in > 0) {
      const long long drow = stride / g.n_in;
      g.step_col = (int)(stride % g.n_in);
      g.step_b = (int)(drow / num_p);
      g.step_p = (int)(drow % num_p);
      g.step_off = drow * g.ld + (long long)g.step_col * vec;
      g.wrap_off = g.ld - g.n_in * vec;
    }
    blk0 += blocks;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 key = make_uint2(s0, s1);
  if (bf16) {
    planes_kernel<__nv_bfloat16, true><<<blk0, kThreads, 0, st>>>(
        t, n_seg, key, scale, num_p, num_b, static_cast<__nv_bfloat16*>(out));
  } else {
    auto kernel = aligned ? planes_kernel<float, true>
                          : planes_kernel<float, false>;
    kernel<<<blk0, kThreads, 0, st>>>(t, n_seg, key, scale, num_p, num_b,
                                      static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
