// K2 and K3: 2D GOCA/SOCA/CA-CFAR for NVIDIA Hopper (sm_90a). Compiled
// with -fmad=false.
//
// K2 replaces the TPU kernel radar_tpu/ops/pallas_kernels.py::
// goca_cfar_qvg_pallas (body _cfar_maps_kernel): CFAR on padded qvg
// pair-sum maps, emitting the mask and the per-(pair, gate) hit counts the
// first-K extraction consumes.
//
// K3 replaces radar_tpu/ops/pallas_kernels.py::goca_cfar_2d_pallas (body
// _cfar_kernel): the adjacent-beam magnitude sum |RDM_b| + |RDM_b+1| fused
// with the same CFAR, emitting the mask and the threshold map, on the
// un-padded beams-major magnitudes [B, V, G]; out-of-map cells read as
// zero, the zero fill the TPU kernel gets from its HALO padding.
//
// Per cell both compute the lead/trail window means along range and
// Doppler (ref cells beyond guard cells, zero fill past the edges), the
// per-axis combine, threshold = factor * max(noise_r, noise_v) and the
// border mask.
//
// Bit-identity: the pair sum is one rounded f32 add, as pair_sum_maps. The
// window sums are accumulated in the order of radar_tpu/ops/cfar.py::
// lead_trail_means (start at zero, add k = guard+1 .. guard+ref), then
// multiplied by the f32 reciprocal of the window length — what XLA makes
// of the reference's division by a constant; the CA combine is the one
// fused multiply-add XLA's CPU compiler forms. Explicitly rounded
// intrinsics and no other FMA contraction keep mask and threshold equal to
// the plain PyTorch versions' bit for bit.
//
// What bounds them on this card: memory.
// - K2 reads the 12 x 336 x 3840 padded f32 maps (62 MB) and writes
//   14.3 MB of mask: about 23 us at 3.35 TB/s.
// - K3 reads 58.8 MB of magnitudes, each plane by two pairs, and writes
//   13.6 MB of mask and 54 MB of threshold: about 185 MB, >= 55 us at
//   3.35 TB/s.
// The ~20 adds per cell come from shared memory; the two halo'd strips
// below read each cell about 4 times, the repeats from L2.
//
// What the design does about it: a block owns one (pair, 16-row Doppler
// tile, 128-gate tile). It stages a row strip (its rows, gates +/- the
// range window) and a column strip (its gates, rows +/- the Doppler
// window) in shared memory, so every map cell is read from device memory
// about once per strip; K3 forms the pair sum while staging. K2's row
// counts are integer atomics into a zeroed buffer: exact and order-free,
// hence deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kVT = 16;       // Doppler rows per block
constexpr int kGT = 128;      // gates per block
constexpr int kThreads = 256;

struct Window {
  int gr, rr, gv, rv;         // guard and ref cells, range and Doppler
  float inv_rr, inv_rv, factor;
  int method;                 // 0 GOCA, 1 SOCA, 2 CA
};

// K2's source: one [v_pad, g_pad] plane with `halo` zero columns on the
// left; g is the un-padded gate (may be negative).
struct PaddedMap {
  const float* m;
  int v_pad, g_pad, halo;
  __device__ float operator()(int v, int g) const {
    const int col = halo + g;
    return (v >= 0 && v < v_pad && col >= 0 && col < g_pad)
               ? m[(long long)v * g_pad + col] : 0.f;
  }
};

// K3's source: the sum of two [num_v, num_g] beam planes, zero outside.
struct PairSum {
  const float* a;
  const float* b;
  int num_v, num_g;
  __device__ float operator()(int v, int g) const {
    if (v < 0 || v >= num_v || g < 0 || g >= num_g) return 0.f;
    const long long k = (long long)v * num_g + g;
    return __fadd_rn(a[k], b[k]);
  }
};

// Noise estimate of one axis from its lead and trail window sums. CA takes
// the fused multiply-add XLA makes of lead*inv + trail*inv.
__device__ __forceinline__ float combine(float lead, float trail, float inv,
                                         int method) {
  if (method == 0) return fmaxf(__fmul_rn(lead, inv), __fmul_rn(trail, inv));
  if (method == 1) return fminf(__fmul_rn(lead, inv), __fmul_rn(trail, inv));
  return __fmul_rn(0.5f, __fmaf_rn(lead, inv, __fmul_rn(trail, inv)));
}

// Stage the block's row strip srow [kVT][kGT + 2hr] and column strip
// scol [kVT + 2hv][kGT] of the tile at Doppler row v0, gate c0.
template <class Source>
__device__ void stage(const Source& at, float* srow, float* scol, int v0,
                      int c0, int hr, int hv) {
  const int rw = kGT + 2 * hr;
  for (int idx = threadIdx.x; idx < kVT * rw; idx += kThreads) {
    const int i = idx / rw, j = idx - i * rw;
    srow[idx] = at(v0 + i, c0 - hr + j);
  }
  for (int idx = threadIdx.x; idx < (kVT + 2 * hv) * kGT; idx += kThreads) {
    const int i = idx / kGT, j = idx - i * kGT;
    scol[idx] = at(v0 - hv + i, c0 + j);
  }
  __syncthreads();
}

// Threshold of tile cell (i, j) from the staged strips; *x = its value.
__device__ __forceinline__ float threshold(const float* srow,
                                           const float* scol, int i, int j,
                                           const Window& w, float* x) {
  const int hr = w.gr + w.rr, hv = w.gv + w.rv;
  const float* r = srow + i * (kGT + 2 * hr) + hr + j;
  float lr = 0.f, tr = 0.f, lv = 0.f, tv = 0.f;
  for (int k = w.gr + 1; k <= w.gr + w.rr; ++k) {
    lr = __fadd_rn(lr, r[-k]);
    tr = __fadd_rn(tr, r[k]);
  }
  for (int k = w.gv + 1; k <= w.gv + w.rv; ++k) {
    lv = __fadd_rn(lv, scol[(i + hv - k) * kGT + j]);
    tv = __fadd_rn(tv, scol[(i + hv + k) * kGT + j]);
  }
  const float noise_r = combine(lr, tr, w.inv_rr, w.method);
  const float noise_v = combine(lv, tv, w.inv_rv, w.method);
  *x = r[0];
  return __fmul_rn(w.factor, fmaxf(noise_r, noise_v));
}

__device__ __forceinline__ bool inside_border(int v, int g, int num_v,
                                              int num_g, const Window& w) {
  const int hr = w.gr + w.rr, hv = w.gv + w.rv;
  return g >= hr && g < num_g - hr && v >= hv && v < num_v - hv;
}

size_t smem_bytes(const Window& w) {
  const int hr = w.gr + w.rr, hv = w.gv + w.rv;
  return ((size_t)kVT * (kGT + 2 * hr) + (size_t)(kVT + 2 * hv) * kGT) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
k2_kernel(const float* __restrict__ maps, int v_pad, int g_pad, int num_v,
          int num_g, int halo, int out_cols, Window w,
          bool* __restrict__ mask, int* __restrict__ rc) {
  extern __shared__ float smem[];
  float* srow = smem;
  float* scol = smem + kVT * (kGT + 2 * (w.gr + w.rr));
  const int q = blockIdx.z;
  const int v0 = blockIdx.y * kVT;
  const int c0 = blockIdx.x * kGT;       // un-padded gate of the tile start
  stage(PaddedMap{maps + (long long)q * v_pad * g_pad, v_pad, g_pad, halo},
        srow, scol, v0, c0, w.gr + w.rr, w.gv + w.rv);
  for (int cell = threadIdx.x; cell < kVT * kGT; cell += kThreads) {
    const int i = cell / kGT, j = cell - i * kGT;
    const int v = v0 + i, g = c0 + j;
    if (v >= num_v || g >= out_cols) continue;
    float x;
    const float thr = threshold(srow, scol, i, j, w, &x);
    const bool hit = inside_border(v, g, num_v, num_g, w) && (x > thr);
    mask[((long long)q * num_v + v) * out_cols + g] = hit;
    if (hit) atomicAdd(rc + (long long)q * out_cols + g, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
k3_kernel(const float* __restrict__ mag, int num_v, int num_g, Window w,
          bool* __restrict__ mask, float* __restrict__ thr) {
  extern __shared__ float smem[];
  float* srow = smem;
  float* scol = smem + kVT * (kGT + 2 * (w.gr + w.rr));
  const int q = blockIdx.z;
  const int v0 = blockIdx.y * kVT;
  const int c0 = blockIdx.x * kGT;
  const long long plane = (long long)num_v * num_g;
  stage(PairSum{mag + q * plane, mag + (q + 1) * plane, num_v, num_g},
        srow, scol, v0, c0, w.gr + w.rr, w.gv + w.rv);
  for (int cell = threadIdx.x; cell < kVT * kGT; cell += kThreads) {
    const int i = cell / kGT, j = cell - i * kGT;
    const int v = v0 + i, g = c0 + j;
    if (v >= num_v || g >= num_g) continue;
    float x;
    const float t = threshold(srow, scol, i, j, w, &x);
    const long long o = q * plane + (long long)v * num_g + g;
    mask[o] = inside_border(v, g, num_v, num_g, w) && (x > t);
    thr[o] = t;
  }
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// maps [Q, v_pad, g_pad] f32 with `halo` zero columns on the left;
// mask [Q, num_v, g_pad - 2*halo] bool, rc [Q, g_pad - 2*halo] int32.
// method: 0 GOCA, 1 SOCA, 2 CA.
int k2_cfar(const void* maps, int num_q, int v_pad, int g_pad, int num_v,
            int num_g, int halo, int gr, int rr, int gv, int rv, float inv_rr,
            float inv_rv, float factor, int method, void* mask, void* rc,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out_cols = g_pad - 2 * halo;
  cudaError_t err = cudaMemsetAsync(rc, 0, sizeof(int) * (size_t)num_q * out_cols, st);
  if (err != cudaSuccess) return (int)err;
  const Window w{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  const size_t smem = smem_bytes(w);
  cudaFuncSetAttribute(k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((out_cols + kGT - 1) / kGT, (num_v + kVT - 1) / kVT, num_q);
  k2_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(maps), v_pad, g_pad, num_v, num_g, halo,
      out_cols, w, static_cast<bool*>(mask), static_cast<int*>(rc));
  return (int)cudaGetLastError();
}

// mag [num_b, num_v, num_g] f32; mask [num_b-1, num_v, num_g] bool and
// thr [num_b-1, num_v, num_g] f32. method: 0 GOCA, 1 SOCA, 2 CA.
int k3_cfar(const void* mag, int num_b, int num_v, int num_g, int gr, int rr,
            int gv, int rv, float inv_rr, float inv_rv, float factor,
            int method, void* mask, void* thr, void* stream) {
  const Window w{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  const size_t smem = smem_bytes(w);
  cudaFuncSetAttribute(k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((num_g + kGT - 1) / kGT, (num_v + kVT - 1) / kVT,
                  num_b - 1);
  k3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag), num_v, num_g, w,
      static_cast<bool*>(mask), static_cast<float*>(thr));
  return (int)cudaGetLastError();
}

}  // extern "C"
