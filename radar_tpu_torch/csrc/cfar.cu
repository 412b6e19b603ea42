// K2 and K3: 2D GOCA/SOCA/CA-CFAR for NVIDIA Hopper (sm_90a). Compiled
// with -fmad=false.
//
// K2 replaces the TPU kernel radar_tpu/ops/pallas_kernels.py::
// goca_cfar_qvg_pallas (pallas_call :234, body _cfar_maps_kernel): CFAR on
// padded qvg pair-sum maps, emitting the mask and the per-(pair, gate) hit
// counts the first-K extraction consumes.
//
// K3 replaces radar_tpu/ops/pallas_kernels.py::goca_cfar_2d_pallas (:292,
// body _cfar_kernel): the adjacent-beam magnitude sum |RDM_b| + |RDM_b+1|
// fused with the same CFAR, emitting the mask and the threshold map, on the
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
// multiplied by the f32 reciprocal of the window length -- what XLA makes
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
//
// K2's design (k2_kernel): a block owns one (pair, tv-row Doppler tile,
// 128-gate tile). One thread stages the block's row strip (its rows, gates
// +/- the range window rounded up to 4) and column strip (its gates, rows
// +/- the Doppler window) with TMA, completion on an mbarrier; TMA's zero
// fill past the map's gates and Doppler rows (the map is addressed from
// its first gate, so the left halo reads as zeros too) replaces per-element
// bounds checks, and no element's index is divided. The windows the
// repo's configs use (guard/ref range, guard/ref Doppler = 10/5/10/5, the
// full and perf configs, and 10/5/4/3) are template parameters: a warp
// owns a row, a lane 4 consecutive gates, the range window of its 4 cells
// in registers (loaded as 16-byte vectors), the Doppler window read as
// 16-byte vectors of the column strip, every loop unrolled. The mask goes
// out 4 cells a 32-bit store; the row counts are summed per gate over the
// block's rows in shared memory, then one integer atomicAdd per gate and
// block (exact and order-free, hence deterministic). One generic
// instantiation takes any other window up to HALO at run time: the same
// staging and cells, runtime loops, smaller row tiles (16 rows) and strips
// loaded in boxes of at most 256 (TMA's limit) where the window is wide.
//
// K3 (k3_kernel) stages a row strip and a column strip per (pair, 16-row
// Doppler tile, 128-gate tile) with plain loads, forming the pair sum
// while staging, and computes a cell per thread.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kVT = 16;       // Doppler rows per block
constexpr int kGT = 128;      // gates per block
constexpr int kThreads = 256;

struct Window {
  int gr, rr, gv, rv;         // guard and ref cells, range and Doppler
  float inv_rr, inv_rv, factor;
  int method;                 // 0 GOCA, 1 SOCA, 2 CA
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


// ------------------------------------------------------------------ K2

constexpr int kK2Gates = 128;       // gates per K2 block: 32 lanes x 4
constexpr int kK2Threads = 256;     // 8 warps, a Doppler row each at a time
constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s

// The block's staging, host-computed (ops/cfar_kernel.py::k2_geometry):
// the row strip [rnc][tv][rw] (rows v0 .. v0+tv-1, columns c0-hrp ..
// c0+128+hrp-1 in rnc boxes of rw) and the column strip [cnr*cbh][128]
// (rows v0-hv .. in cnr boxes of cbh, columns c0 .. c0+127).
struct K2Args {
  Window w;
  int num_v, num_g, out_cols;
  int tv, hrp, rw, rnc, cbh, cnr;
  int col_off;                 // floats from the smem base to the column strip
  unsigned tx_bytes;
  unsigned* mask;              // 4 cells a word
  int* rc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A load that never lands is a bug: trap after kTimeoutNs, do not hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > kTimeoutNs) __trap();
}

// TMA: the 3D box at (column, row, pair) of `map` into shared `dst`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The range and Doppler windows of K2: compile-time for the instantiated
// windows (kFixed), else the run-time Window.
template <int GR, int RR, int GV, int RV>
struct K2Win {
  static constexpr bool kFixed = GR >= 0;
  static constexpr int kHr = GR + RR, kHv = GV + RV;
  static constexpr int kHrp = (kHr + 3) & ~3;
};

template <int GR, int RR, int GV, int RV, int TV>
__global__ void __launch_bounds__(kK2Threads)
k2_kernel(const __grid_constant__ CUtensorMap rmap,
          const __grid_constant__ CUtensorMap cmap, const K2Args a) {
  using W = K2Win<GR, RR, GV, RV>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar_mem;
  __shared__ int counts[kK2Gates];
  // TMA destinations on 128-byte boundaries
  float* srow = reinterpret_cast<float*>(
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u));
  float* scol = srow + a.col_off;
  const uint32_t bar = smem_u32(&bar_mem);
  const int q = blockIdx.z;
  const int v0 = blockIdx.y * TV;
  const int c0 = blockIdx.x * kK2Gates;       // un-padded gate of the tile
  const int hv = W::kFixed ? W::kHv : a.w.gv + a.w.rv;
  const int hr = W::kFixed ? W::kHr : a.w.gr + a.w.rr;
  const int hrp = W::kFixed ? W::kHrp : a.hrp;
  if (threadIdx.x < kK2Gates) counts[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(a.tx_bytes)
                 : "memory");
    for (int ci = 0; ci < a.rnc; ++ci)
      tma_load3(smem_u32(srow + ci * TV * a.rw), &rmap, c0 - hrp + ci * a.rw,
                v0, q, bar);
    for (int ri = 0; ri < a.cnr; ++ri)
      tma_load3(smem_u32(scol + ri * a.cbh * kK2Gates), &cmap, c0,
                v0 - hv + ri * a.cbh, q, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = 4 * lane;                      // the lane's first tile gate
  const int g = c0 + j;
  int hits[4] = {0, 0, 0, 0};
  for (int i = warp; i < TV; i += kK2Threads / 32) {
    const int v = v0 + i;
    if (v >= a.num_v) break;
    float lr[4], tr[4], lv[4], tvs[4], x[4];
    if constexpr (W::kFixed) {
      // the range window of the 4 cells: columns j .. j + 4 + 2 hrp - 1
      constexpr int kWin = 4 + 2 * W::kHrp;
      constexpr int kRw = kK2Gates + 2 * W::kHrp;
      float win[kWin];
      const float4* r4 = reinterpret_cast<const float4*>(srow + i * kRw + j);
#pragma unroll
      for (int u = 0; u < kWin / 4; ++u) {
        const float4 t = r4[u];
        win[4 * u] = t.x;
        win[4 * u + 1] = t.y;
        win[4 * u + 2] = t.z;
        win[4 * u + 3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lr[e] = tr[e] = 0.f;
#pragma unroll
        for (int k = GR + 1; k <= GR + RR; ++k) {
          lr[e] = __fadd_rn(lr[e], win[W::kHrp + e - k]);
          tr[e] = __fadd_rn(tr[e], win[W::kHrp + e + k]);
        }
        x[e] = win[W::kHrp + e];
        lv[e] = tvs[e] = 0.f;
      }
#pragma unroll
      for (int k = GV + 1; k <= GV + RV; ++k) {
        const float4 l = *reinterpret_cast<const float4*>(
            scol + (i + W::kHv - k) * kK2Gates + j);
        const float4 t = *reinterpret_cast<const float4*>(
            scol + (i + W::kHv + k) * kK2Gates + j);
        lv[0] = __fadd_rn(lv[0], l.x);
        lv[1] = __fadd_rn(lv[1], l.y);
        lv[2] = __fadd_rn(lv[2], l.z);
        lv[3] = __fadd_rn(lv[3], l.w);
        tvs[0] = __fadd_rn(tvs[0], t.x);
        tvs[1] = __fadd_rn(tvs[1], t.y);
        tvs[2] = __fadd_rn(tvs[2], t.z);
        tvs[3] = __fadd_rn(tvs[3], t.w);
      }
    } else {
      // the row strip's column s of row i lies in box s / rw
      auto at = [&](int s) {
        return srow[(s / a.rw) * TV * a.rw + i * a.rw + s % a.rw];
      };
      for (int e = 0; e < 4; ++e) {
        const int s = j + e + hrp;
        lr[e] = tr[e] = lv[e] = tvs[e] = 0.f;
        for (int k = a.w.gr + 1; k <= hr; ++k) {
          lr[e] = __fadd_rn(lr[e], at(s - k));
          tr[e] = __fadd_rn(tr[e], at(s + k));
        }
        for (int k = a.w.gv + 1; k <= hv; ++k) {
          lv[e] = __fadd_rn(lv[e], scol[(i + hv - k) * kK2Gates + j + e]);
          tvs[e] = __fadd_rn(tvs[e], scol[(i + hv + k) * kK2Gates + j + e]);
        }
        x[e] = at(s);
      }
    }
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float noise_r = combine(lr[e], tr[e], a.w.inv_rr, a.w.method);
      const float noise_v = combine(lv[e], tvs[e], a.w.inv_rv, a.w.method);
      const float thr = __fmul_rn(a.w.factor, fmaxf(noise_r, noise_v));
      const bool hit = g + e >= hr && g + e < a.num_g - hr && v >= hv &&
                       v < a.num_v - hv && x[e] > thr;
      word |= (unsigned)hit << (8 * e);
      hits[e] += hit;
    }
    a.mask[(((long long)q * a.num_v + v) * a.out_cols + g) >> 2] = word;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (hits[e]) atomicAdd(&counts[j + e], hits[e]);
  __syncthreads();
  if (threadIdx.x < kK2Gates && counts[threadIdx.x])
    atomicAdd(a.rc + (long long)q * a.out_cols + c0 + threadIdx.x,
              counts[threadIdx.x]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The maps [Q, v_pad, g_pad] addressed from gate 0 (column `halo`) as a 3D
// tensor [Q][num_v][num_g]: boxes {bw gates, bh rows, 1 pair}, zeros past
// every edge.
// Encoded maps by address, shape and box, the kK2MapCache latest: the
// maps of a sweep's trials come back at the same addresses, and a map holds
// only the address, shape and box.
constexpr int kK2MapCache = 32;
struct K2MapEntry {
  long long key[8];
  CUtensorMap map;
};
K2MapEntry g_k2_maps[kK2MapCache];
int g_k2_count = 0, g_k2_next = 0;
std::mutex g_k2_mutex;    // ctypes calls run without the GIL

bool k2_map(CUtensorMap* map, const float* maps, int num_q, int v_pad,
            int g_pad, int num_v, int num_g, int halo, int bw, int bh) {
  EncodeTiled fn = encode_tiled();
  const float* base = maps + halo;
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      g_pad % 4 != 0 || bw < 4 || bw > 256 || bw % 4 != 0 || bh < 1 ||
      bh > 256)
    return false;
  const long long key[8] = {reinterpret_cast<long long>(base), num_q, v_pad,
                            g_pad, num_v, num_g, bw, bh};
  std::lock_guard<std::mutex> lock(g_k2_mutex);
  for (int i = 0; i < g_k2_count; ++i)
    if (memcmp(g_k2_maps[i].key, key, sizeof key) == 0) {
      *map = g_k2_maps[i].map;
      return true;
    }
  const cuuint64_t dims[3] = {(cuuint64_t)num_g, (cuuint64_t)num_v,
                              (cuuint64_t)num_q};
  const cuuint64_t strides[2] = {(cuuint64_t)g_pad * 4,
                                 (cuuint64_t)v_pad * g_pad * 4};
  const cuuint32_t box[3] = {(cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(g_k2_maps[g_k2_next].key, key, sizeof key);
  g_k2_maps[g_k2_next].map = *map;
  g_k2_next = (g_k2_next + 1) % kK2MapCache;
  if (g_k2_count < kK2MapCache) ++g_k2_count;
  return true;
}

constexpr int kMaxDevices = 64;
constexpr int kK2MaxSmem = 232448 - 2048;   // dynamic, beside the static

template <int GR, int RR, int GV, int RV, int TV>
cudaError_t k2_launch(const CUtensorMap& rmap, const CUtensorMap& cmap,
                      const K2Args& a, int num_q, size_t smem,
                      cudaStream_t st) {
  auto kernel = k2_kernel<GR, RR, GV, RV, TV>;
  static bool smem_set[kMaxDevices] = {};   // the attribute, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kK2MaxSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid(a.out_cols / kK2Gates, (a.num_v + TV - 1) / TV, num_q);
  kernel<<<grid, kK2Threads, smem, st>>>(rmap, cmap, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// maps [Q, v_pad, g_pad] f32 with `halo` zero columns on the left (gate g
// at column halo + g); mask [Q, num_v, g_pad - 2*halo] bool, rc
// [Q, g_pad - 2*halo] int32. method: 0 GOCA, 1 SOCA, 2 CA. instance: 0 the
// 10/5/10/5 window (guard/ref range, guard/ref Doppler), 1 10/5/4/3, 2 any
// window (run time); tv, rw, rnc, cbh, cnr: the staging geometry of
// ops/cfar_kernel.py::k2_geometry.
int k2_cfar(const void* maps, int num_q, int v_pad, int g_pad, int num_v,
            int num_g, int halo, int gr, int rr, int gv, int rv, float inv_rr,
            float inv_rv, float factor, int method, int instance, int tv,
            int rw, int rnc, int cbh, int cnr, void* mask, void* rc,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out_cols = g_pad - 2 * halo;
  const int hr = gr + rr, hv = gv + rv, hrp = (hr + 3) & ~3;
  static const int kWins[2][5] = {{10, 5, 10, 5, 32}, {10, 5, 4, 3, 32}};
  const bool fixed = instance == 0 || instance == 1;
  if (instance < 0 || instance > 2 || out_cols < kK2Gates ||
      out_cols % kK2Gates != 0 || num_g > out_cols || num_v > v_pad ||
      hr > halo || hv > halo || rnc < 1 || cnr < 1 ||
      (long long)rnc * rw < kK2Gates + 2 * hrp ||
      (long long)cnr * cbh < tv + 2 * hv || (rnc > 1 && rw != kK2Gates) ||
      (fixed && (gr != kWins[instance][0] || rr != kWins[instance][1] ||
                 gv != kWins[instance][2] || rv != kWins[instance][3] ||
                 tv != kWins[instance][4] || rnc != 1 || cnr != 1 ||
                 rw != kK2Gates + 2 * hrp)) ||
      (!fixed && tv != 16) ||
      reinterpret_cast<uintptr_t>(mask) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(rc, 0, sizeof(int) * (size_t)num_q * out_cols, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap rmap, cmap;
  const float* m = static_cast<const float*>(maps);
  if (!k2_map(&rmap, m, num_q, v_pad, g_pad, num_v, num_g, halo, rw, tv) ||
      !k2_map(&cmap, m, num_q, v_pad, g_pad, num_v, num_g, halo, kK2Gates, cbh))
    return (int)cudaErrorInvalidValue;
  K2Args a{};
  a.w = Window{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  a.num_v = num_v;
  a.num_g = num_g;
  a.out_cols = out_cols;
  a.tv = tv;
  a.hrp = hrp;
  a.rw = rw;
  a.rnc = rnc;
  a.cbh = cbh;
  a.cnr = cnr;
  const long long row_floats = ((long long)rnc * tv * rw + 31) / 32 * 32;
  const long long col_floats = (long long)cnr * cbh * kK2Gates;
  a.col_off = (int)row_floats;
  a.tx_bytes = (unsigned)(((long long)rnc * tv * rw + col_floats) * 4);
  a.mask = static_cast<unsigned*>(mask);
  a.rc = static_cast<int*>(rc);
  const size_t smem = (size_t)(row_floats + col_floats) * 4 + 128;
  if (smem > (size_t)kK2MaxSmem) return (int)cudaErrorInvalidValue;
  if (instance == 0) err = k2_launch<10, 5, 10, 5, 32>(rmap, cmap, a, num_q, smem, st);
  else if (instance == 1) err = k2_launch<10, 5, 4, 3, 32>(rmap, cmap, a, num_q, smem, st);
  else err = k2_launch<-1, -1, -1, -1, 16>(rmap, cmap, a, num_q, smem, st);
  return (int)err;
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
