// K2: 2D GOCA/SOCA/CA-CFAR on padded qvg pair-sum maps, for NVIDIA Hopper
// (sm_90a). Compiled with -fmad=false.
//
// Replaces the TPU kernel radar_tpu/ops/pallas_kernels.py::
// goca_cfar_qvg_pallas (body _cfar_maps_kernel): per cell of the
// [pairs, V, G] maps, the lead/trail window means along range and Doppler
// (ref cells beyond guard cells, zero fill past the edges), the per-axis
// combine, threshold = factor * max(noise_r, noise_v), the border mask,
// and the per-(pair, gate) hit counts the first-K extraction consumes.
//
// Bit-identity: the window sums are accumulated in the order of
// radar_tpu/ops/cfar.py::lead_trail_means (start at zero, add
// k = guard+1 .. guard+ref), then multiplied by the f32 reciprocal of the
// window length — what XLA makes of the reference's division by a
// constant — with explicitly rounded intrinsics and no FMA contraction, so
// the mask equals the plain PyTorch version's bit for bit.
//
// What bounds it on this card: memory. At the full shape it reads the
// 12 x 336 x 3840 padded f32 maps (62 MB) and writes 14.3 MB of mask:
// about 23 us at 3.35 TB/s. The ~20 adds per cell come from shared
// memory; the two halo'd strips below read each cell about 4 times, the
// repeats from L2.
//
// What the design does about it: a block owns one (pair, 16-row Doppler
// tile, 128-gate tile). It stages a row strip (its rows, gates +/- the
// range window) and a column strip (its gates, rows +/- the Doppler
// window) in shared memory, so every map cell is read from device memory
// about once per strip. Row counts are integer atomics into a zeroed
// buffer: exact and order-free, hence deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kVT = 16;       // Doppler rows per block
constexpr int kGT = 128;      // gates per block
constexpr int kThreads = 256;

__device__ __forceinline__ float combine(float lead, float trail, int method) {
  if (method == 0) return fmaxf(lead, trail);                   // GOCA
  if (method == 1) return fminf(lead, trail);                   // SOCA
  return __fmul_rn(0.5f, __fadd_rn(lead, trail));              // CA
}

__global__ void __launch_bounds__(kThreads)
cfar_kernel(const float* __restrict__ maps, int v_pad, int g_pad, int num_v,
            int num_g, int halo, int out_cols, int gr, int rr, int gv, int rv,
            float inv_rr, float inv_rv, float factor, int method,
            bool* __restrict__ mask, int* __restrict__ rc) {
  extern __shared__ float smem[];
  const int hr = gr + rr, hv = gv + rv;
  const int rw = kGT + 2 * hr;
  float* srow = smem;                    // [kVT][kGT + 2hr]
  float* scol = smem + kVT * rw;         // [kVT + 2hv][kGT]
  const int q = blockIdx.z;
  const int v0 = blockIdx.y * kVT;
  const int c0 = blockIdx.x * kGT;       // un-padded gate of the tile start
  const float* mq = maps + (long long)q * v_pad * g_pad;

  for (int idx = threadIdx.x; idx < kVT * rw; idx += kThreads) {
    const int i = idx / rw, j = idx - i * rw;
    const int v = v0 + i, col = halo + c0 - hr + j;
    srow[idx] = (v < v_pad && col >= 0 && col < g_pad)
                    ? mq[(long long)v * g_pad + col] : 0.f;
  }
  for (int idx = threadIdx.x; idx < (kVT + 2 * hv) * kGT; idx += kThreads) {
    const int i = idx / kGT, j = idx - i * kGT;
    const int v = v0 - hv + i, col = halo + c0 + j;
    scol[idx] = (v >= 0 && v < v_pad && col < g_pad)
                    ? mq[(long long)v * g_pad + col] : 0.f;
  }
  __syncthreads();

  for (int cell = threadIdx.x; cell < kVT * kGT; cell += kThreads) {
    const int i = cell / kGT, j = cell - i * kGT;
    const int v = v0 + i, g = c0 + j;
    if (v >= num_v || g >= out_cols) continue;
    const float* r = srow + i * rw + hr + j;
    float lr = 0.f, tr = 0.f, lv = 0.f, tv = 0.f;
    for (int k = gr + 1; k <= gr + rr; ++k) {
      lr = __fadd_rn(lr, r[-k]);
      tr = __fadd_rn(tr, r[k]);
    }
    for (int k = gv + 1; k <= gv + rv; ++k) {
      lv = __fadd_rn(lv, scol[(i + hv - k) * kGT + j]);
      tv = __fadd_rn(tv, scol[(i + hv + k) * kGT + j]);
    }
    const float noise_r = combine(__fmul_rn(lr, inv_rr), __fmul_rn(tr, inv_rr),
                                  method);
    const float noise_v = combine(__fmul_rn(lv, inv_rv), __fmul_rn(tv, inv_rv),
                                  method);
    const float thr = __fmul_rn(factor, fmaxf(noise_r, noise_v));
    const bool valid = g >= hr && g < num_g - hr && v >= hv && v < num_v - hv;
    const bool hit = valid && (r[0] > thr);
    mask[((long long)q * num_v + v) * out_cols + g] = hit;
    if (hit) atomicAdd(rc + (long long)q * out_cols + g, 1);
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
  const int hr = gr + rr, hv = gv + rv;
  const size_t smem =
      ((size_t)kVT * (kGT + 2 * hr) + (size_t)(kVT + 2 * hv) * kGT) * sizeof(float);
  cudaFuncSetAttribute(cfar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((out_cols + kGT - 1) / kGT, (num_v + kVT - 1) / kVT, num_q);
  cfar_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(maps), v_pad, g_pad, num_v, num_g, halo,
      out_cols, gr, rr, gv, rv, inv_rr, inv_rv, factor, method,
      static_cast<bool*>(mask), static_cast<int*>(rc));
  return (int)cudaGetLastError();
}

}  // extern "C"
