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
// - K2 reads the 12 x 332 x 3404 pair maps (54 MB) and writes 13.6 MB of
//   mask and the counts: about 20 us at 3.35 TB/s.
// - K3 reads the 13 x 332 x 3404 magnitudes once (58.8 MB) and writes 13.6
//   MB of mask and 54 MB of threshold: 126 MB, >= 38 us at 3.35 TB/s.
//
// Both stage a block's tile by TMA, one thread issuing the loads,
// completion on an mbarrier, from a 3D tensor map that addresses the maps
// from their first gate, so TMA's zero fill past every edge (negative
// coordinates too) replaces per-element bounds checks, and no element's
// index is divided. The windows the repo's configs use (guard/ref range,
// guard/ref Doppler = 10/5/10/5, the full and perf configs, and 10/5/4/3)
// are template parameters: a lane owns 4 consecutive gates of a row, the
// range window of its 4 cells in registers (loaded as 16-byte vectors), the
// Doppler window read as 16-byte vectors, every loop unrolled; the mask
// goes out 4 cells a 32-bit store. One generic instantiation takes any
// other window up to HALO at run time: runtime loops, smaller tiles, a row
// strip (the tile's rows, its gates +/- the range window rounded up to 4)
// and a column strip (its gates, its rows +/- the Doppler window) loaded in
// boxes of at most 256 (TMA's limit) where the window is wide.
//
// K2 (k2_kernel): a block owns one (pair, tv-row Doppler tile, 128-gate
// tile), staged as a row strip and a column strip; the row counts are summed
// per gate over the block's rows in shared memory, then one integer
// atomicAdd per gate and block (exact and order-free, hence deterministic).
//
// K3 (k3_kernel): a block owns one (Doppler-row tile, gate tile) across a
// group of pairs and walks the beams: beam b lands by TMA in a ring of
// kK3Slots beam slots, pair b's sums are formed in place in beam b's slot
// (beam b+1's is only read: the next pair needs it), the pair's CFAR reads
// them, and the freed slot takes the load of beam b + kK3Slots, which stays
// in flight over the next two pairs. So each magnitude plane is read from
// device memory once (plus its halo), not once for each of its two pairs.
// A compiled-in window's slot is one box, the 32 x 128 tile with its whole
// halo (62 x 160 floats, 39 KB: the row and column strips' 52 KB held the
// tile twice), a warp takes two rows (their Doppler windows share 12 of
// 20 row loads: shared memory, not device memory, holds K3), and a tile's
// 12 pairs are walked in two groups of blocks (594 blocks fill 4.5 waves of
// the SMs, one group's 297 filled 2.25 in 3 waves). The generic one stages
// 16 x 32 tiles as strips (the widest window's three slots: 160 KB). The
// threshold goes out in 16-byte stores. ops/cfar_kernel.py::k3_geometry
// computes the instantiation, the boxes and the groups.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "launch.cuh"

namespace {

constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s

struct Window {
  int gr, rr, gv, rv;         // guard and ref cells, range and Doppler
  float inv_rr, inv_rv, factor;
  int method;                 // 0 GOCA, 1 SOCA, 2 CA
};

// Noise estimate of one axis from its lead and trail window sums. CA takes
// the fused multiply-add XLA makes of lead*inv + trail*inv.
__device__ __forceinline__ float combine(float lead, float trail, float inv,
                                         int method) {
  if (method == 0) return fmaxf(__fmul_rn(lead, inv), __fmul_rn(trail, inv));
  if (method == 1) return fminf(__fmul_rn(lead, inv), __fmul_rn(trail, inv));
  return __fmul_rn(0.5f, __fmaf_rn(lead, inv, __fmul_rn(trail, inv)));
}

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

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// TMA: the 3D box at (column, row, plane) of `map` into shared `dst`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The range and Doppler windows: compile-time for the instantiated windows
// (kFixed), else the run-time Window.
template <int GR, int RR, int GV, int RV>
struct Win {
  static constexpr bool kFixed = GR >= 0;
  static constexpr int kHr = GR + RR, kHv = GV + RV;
  static constexpr int kHrp = (kHr + 3) & ~3;
};

// Value x[e] and threshold thr[e] of the 4 cells (tile row i, tile gates
// j .. j+3) of a staged tile: srow the row strip ([rnc boxes][TV][rw], the
// tile's gate 0 at column hrp), scol the column strip ([TV + 2 hv][GT], the
// tile's row 0 at row hv).
template <int GR, int RR, int GV, int RV, int TV, int GT>
__device__ __forceinline__ void cells4(const float* srow, const float* scol,
                                       int i, int j, const Window& w, int hrp,
                                       int rw, float (&x)[4], float (&thr)[4]) {
  using W = Win<GR, RR, GV, RV>;
  float lr[4], tr[4], lv[4], tvs[4];
  if constexpr (W::kFixed) {
    // the range window of the 4 cells: columns j .. j + 4 + 2 hrp - 1
    constexpr int kWin = 4 + 2 * W::kHrp;
    constexpr int kRw = GT + 2 * W::kHrp;
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
      const float4 l =
          *reinterpret_cast<const float4*>(scol + (i + W::kHv - k) * GT + j);
      const float4 t =
          *reinterpret_cast<const float4*>(scol + (i + W::kHv + k) * GT + j);
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
    const int hr = w.gr + w.rr, hv = w.gv + w.rv;
    // the row strip's column s of row i lies in box s / rw
    auto at = [&](int s) { return srow[(s / rw) * TV * rw + i * rw + s % rw]; };
    for (int e = 0; e < 4; ++e) {
      const int s = j + e + hrp;
      lr[e] = tr[e] = lv[e] = tvs[e] = 0.f;
      for (int k = w.gr + 1; k <= hr; ++k) {
        lr[e] = __fadd_rn(lr[e], at(s - k));
        tr[e] = __fadd_rn(tr[e], at(s + k));
      }
      for (int k = w.gv + 1; k <= hv; ++k) {
        lv[e] = __fadd_rn(lv[e], scol[(i + hv - k) * GT + j + e]);
        tvs[e] = __fadd_rn(tvs[e], scol[(i + hv + k) * GT + j + e]);
      }
      x[e] = at(s);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float noise_r = combine(lr[e], tr[e], w.inv_rr, w.method);
    const float noise_v = combine(lv[e], tvs[e], w.inv_rv, w.method);
    thr[e] = __fmul_rn(w.factor, fmaxf(noise_r, noise_v));
  }
}

__device__ __forceinline__ bool inside_border(int v, int g, int num_v,
                                              int num_g, const Window& w) {
  const int hr = w.gr + w.rr, hv = w.gv + w.rv;
  return g >= hr && g < num_g - hr && v >= hv && v < num_v - hv;
}

// ------------------------------------------------------------------ K2

constexpr int kK2Gates = 128;       // gates per K2 block: 32 lanes x 4
constexpr int kK2Threads = 256;     // 8 warps, a Doppler row each at a time

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

template <int GR, int RR, int GV, int RV, int TV>
__global__ void __launch_bounds__(kK2Threads)
k2_kernel(const __grid_constant__ CUtensorMap rmap,
          const __grid_constant__ CUtensorMap cmap, const K2Args a) {
  using W = Win<GR, RR, GV, RV>;
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
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, a.tx_bytes);
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
    float x[4], thr[4];
    cells4<GR, RR, GV, RV, TV, kK2Gates>(srow, scol, i, j, a.w, hrp, a.rw, x,
                                         thr);
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hit = g + e >= hr && g + e < a.num_g - hr && v >= hv &&
                       v < a.num_v - hv && x[e] > thr[e];
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

// ------------------------------------------------------------------ K3

constexpr int kK3Threads = 512;     // 16 warps
constexpr int kK3Slots = 3;         // beam slots of the ring

// Values x[r][e] and thresholds thr[r][e] of the 8 cells (tile rows i + r,
// r = 0, 1; tile gates j + e, e < 4) of a compiled-in window's staged box:
// the tile with its whole halo, [TV + 2 hv][GT + 2 hrp], the tile's (0, 0)
// at (hv, hrp). The two rows share the loads of their Doppler windows.
template <int GR, int RR, int GV, int RV, int GT>
__device__ __forceinline__ void cells2x4(const float* box, int i, int j,
                                         const Window& w, float (&x)[2][4],
                                         float (&thr)[2][4]) {
  using W = Win<GR, RR, GV, RV>;
  constexpr int kLd = GT + 2 * W::kHrp;
  constexpr int kWin = 4 + 2 * W::kHrp;
  float lr[2][4], tr[2][4], lv[2][4], tvs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float win[kWin];
    const float4* r4 =
        reinterpret_cast<const float4*>(box + (W::kHv + i + r) * kLd + j);
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
      lr[r][e] = tr[r][e] = 0.f;
#pragma unroll
      for (int k = GR + 1; k <= GR + RR; ++k) {
        lr[r][e] = __fadd_rn(lr[r][e], win[W::kHrp + e - k]);
        tr[r][e] = __fadd_rn(tr[r][e], win[W::kHrp + e + k]);
      }
      x[r][e] = win[W::kHrp + e];
      lv[r][e] = tvs[r][e] = 0.f;
    }
  }
  // row i + r's lead window is box rows i + r + hv - k (k = GV+1 .. GV+RV),
  // its trail window i + r + hv + k: RV + 1 rows each for both rows
  float4 lead[RV + 1], trail[RV + 1];
#pragma unroll
  for (int m = 0; m <= RV; ++m) {
    lead[m] = *reinterpret_cast<const float4*>(box + (i + m) * kLd + W::kHrp + j);
    trail[m] = *reinterpret_cast<const float4*>(
        box + (i + W::kHv + GV + 1 + m) * kLd + W::kHrp + j);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = GV + 1; k <= GV + RV; ++k) {
      const float4 l = lead[r + W::kHv - k], t = trail[r + k - GV - 1];
      lv[r][0] = __fadd_rn(lv[r][0], l.x);
      lv[r][1] = __fadd_rn(lv[r][1], l.y);
      lv[r][2] = __fadd_rn(lv[r][2], l.z);
      lv[r][3] = __fadd_rn(lv[r][3], l.w);
      tvs[r][0] = __fadd_rn(tvs[r][0], t.x);
      tvs[r][1] = __fadd_rn(tvs[r][1], t.y);
      tvs[r][2] = __fadd_rn(tvs[r][2], t.z);
      tvs[r][3] = __fadd_rn(tvs[r][3], t.w);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float noise_r = combine(lr[r][e], tr[r][e], w.inv_rr, w.method);
      const float noise_v = combine(lv[r][e], tvs[r][e], w.inv_rv, w.method);
      thr[r][e] = __fmul_rn(w.factor, fmaxf(noise_r, noise_v));
    }
}

// The block's staging, host-computed (ops/cfar_kernel.py::k3_geometry): a
// compiled-in window's slot is one box [cbh = TV + 2 hv][rw = GT + 2 hrp];
// the generic one's the row strip [rnc][TV][rw] and, col_off floats on, the
// column strip [cnr*cbh][GT], as K2's.
struct K3Args {
  Window w;
  int num_b, num_v, num_g;
  int hrp, rw, rnc, cbh, cnr;
  int col_off;                 // floats from a slot's base to its column strip
  int slot_floats;             // floats a slot (a multiple of 32)
  unsigned tx_bytes;           // bytes a beam's strips
  bool* mask;                  // [B-1, V, G]
  float* thr;                  // [B-1, V, G]
};

// Mask (4 cells a word where rows are 16-byte multiples) and threshold of
// the 4 cells (pair q, row v, gates g .. g+3).
__device__ __forceinline__ void store4(const K3Args& a, int q, int v, int g,
                                       const float (&x)[4],
                                       const float (&thr)[4]) {
  const long long o = ((long long)q * a.num_v + v) * a.num_g + g;
  if ((a.num_g & 3) == 0) {
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      word |= (unsigned)(inside_border(v, g + e, a.num_v, a.num_g, a.w) &&
                         x[e] > thr[e])
              << (8 * e);
    *reinterpret_cast<unsigned*>(a.mask + o) = word;
    *reinterpret_cast<float4*>(a.thr + o) =
        make_float4(thr[0], thr[1], thr[2], thr[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (g + e >= a.num_g) break;
    a.mask[o + e] = inside_border(v, g + e, a.num_v, a.num_g, a.w) && x[e] > thr[e];
    a.thr[o + e] = thr[e];
  }
}

// Pairs q0 .. q1 - 1 (group blockIdx.z of gridDim.z) of one (TV-row, GT-gate)
// tile: load k brings beam beam(k) into slot k % kK3Slots; pair q (counted
// from q0) sums loads first(q) and first(q) + 1 in place in the first
// one's slot.
template <int GR, int RR, int GV, int RV, int TV, int GT>
__global__ void __launch_bounds__(kK3Threads)
k3_kernel(const __grid_constant__ CUtensorMap rmap,
          const __grid_constant__ CUtensorMap cmap, const K3Args a) {
  using W = Win<GR, RR, GV, RV>;
  static_assert(!W::kFixed || (GT == 128 && TV == 2 * kK3Threads / 32),
                "a compiled-in window's warp takes two rows of 128 gates");
  constexpr int kLanesPerRow = GT / 4;
  constexpr int kRowsPerPass = kK3Threads / kLanesPerRow;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kK3Slots];
  float* slots = reinterpret_cast<float*>(
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u));
  const int v0 = blockIdx.y * TV;
  const int c0 = blockIdx.x * GT;
  const int hv = W::kFixed ? W::kHv : a.w.gv + a.w.rv;
  const int hrp = W::kFixed ? W::kHrp : a.hrp;
  const int per = (a.num_b - 2 + gridDim.z) / gridDim.z;   // pairs a group
  const int q0 = blockIdx.z * per;
  const int q1 = min(a.num_b - 1, q0 + per);
  if (q0 >= q1) return;
  const int n_loads = q1 - q0 + 1;
  auto beam = [&](int k) { return q0 + k; };
  auto first = [](int q) { return q; };
  auto slot = [&](int k) { return slots + (k % kK3Slots) * a.slot_floats; };
  auto bar = [&](int k) { return smem_u32(&bars[k % kK3Slots]); };
  auto issue = [&](int k) {
    float* base = slot(k);
    mbar_expect_tx(bar(k), a.tx_bytes);
    if (W::kFixed) {
      tma_load3(smem_u32(base), &rmap, c0 - hrp, v0 - hv, beam(k), bar(k));
      return;
    }
    for (int ci = 0; ci < a.rnc; ++ci)
      tma_load3(smem_u32(base + ci * TV * a.rw), &rmap, c0 - hrp + ci * a.rw,
                v0, beam(k), bar(k));
    for (int ri = 0; ri < a.cnr; ++ri)
      tma_load3(smem_u32(base + a.col_off + ri * a.cbh * GT), &cmap, c0,
                v0 - hv + ri * a.cbh, beam(k), bar(k));
  };
  int issued = min(n_loads, kK3Slots);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kK3Slots; ++s) mbar_init(smem_u32(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < issued; ++k) issue(k);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = 4 * (lane % kLanesPerRow);     // the lane's first tile gate
  const int g = c0 + j;
  const int n4 = W::kFixed ? (W::kHv * 2 + TV) * (GT + 2 * W::kHrp) / 4
                           : (a.col_off + a.cnr * a.cbh * GT) / 4;
  for (int q = 0; q < q1 - q0; ++q) {
    const int k0 = first(q);
    mbar_wait(bar(k0), (k0 / kK3Slots) & 1);
    mbar_wait(bar(k0 + 1), ((k0 + 1) / kK3Slots) & 1);
    // the pair's sums, in place in the first beam's slot
    float4* s4 = reinterpret_cast<float4*>(slot(k0));
    const float4* t4 = reinterpret_cast<const float4*>(slot(k0 + 1));
    for (int idx = threadIdx.x; idx < n4; idx += kK3Threads) {
      const float4 u = s4[idx], t = t4[idx];
      s4[idx] = make_float4(__fadd_rn(u.x, t.x), __fadd_rn(u.y, t.y),
                            __fadd_rn(u.z, t.z), __fadd_rn(u.w, t.w));
    }
    __syncthreads();
    const float* box = slot(k0);
    if constexpr (W::kFixed) {
      const int i = 2 * (threadIdx.x >> 5);    // the warp's row pair
      const int v = v0 + i;
      if (v < a.num_v && g < a.num_g) {
        float x[2][4], thr[2][4];
        cells2x4<GR, RR, GV, RV, GT>(box, i, j, a.w, x, thr);
        store4(a, q0 + q, v, g, x[0], thr[0]);
        if (v + 1 < a.num_v) store4(a, q0 + q, v + 1, g, x[1], thr[1]);
      }
    } else {
      for (int i = threadIdx.x / kLanesPerRow; i < TV; i += kRowsPerPass) {
        const int v = v0 + i;
        if (v >= a.num_v || g >= a.num_g) break;
        float x[4], thr[4];
        cells4<GR, RR, GV, RV, TV, GT>(box, box + a.col_off, i, j, a.w, hrp,
                                       a.rw, x, thr);
        store4(a, q0 + q, v, g, x, thr);
      }
    }
    // the slots this pair freed take the next loads; generic-proxy writes
    // (the sums) before TMA's async-proxy writes to the same slot
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (q + 1 < q1 - q0) {
      // loads before first(q + 1) are done with; a load's slot is that of
      // the load kK3Slots before it
      const int limit = min(n_loads, first(q + 1) + kK3Slots);
      if (threadIdx.x == 0)
        for (int k = issued; k < limit; ++k) issue(k);
      issued = max(issued, limit);
    }
  }
}

// ------------------------------------------------------------------ host

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

// A 3D f32 tensor [planes][rows][cols] at `base` (row stride ld floats, plane
// stride rows_ld floats) read in boxes {bw columns, bh rows, 1 plane}, zeros
// past every edge. Encoded maps by address, shape and box, the kMapCache
// latest: the maps of a sweep's trials come back at the same addresses, and
// a map holds only the address, shape and box.
constexpr int kMapCache = 32;
struct MapEntry {
  long long key[8];
  CUtensorMap map;
};
MapEntry g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mutex;    // ctypes calls run without the GIL

bool tile_map(CUtensorMap* map, const float* base, int planes, int rows,
              int cols, long long ld, long long plane_ld, int bw, int bh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      ld % 4 != 0 || plane_ld % 4 != 0 || bw < 4 || bw > 256 || bw % 4 != 0 ||
      bh < 1 || bh > 256)
    return false;
  const long long key[8] = {reinterpret_cast<long long>(base), planes, rows,
                            cols, ld, plane_ld, bw, bh};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i)
    if (memcmp(g_maps[i].key, key, sizeof key) == 0) {
      *map = g_maps[i].map;
      return true;
    }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)plane_ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(g_maps[g_map_next].key, key, sizeof key);
  g_maps[g_map_next].map = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  return true;
}

constexpr int kMaxSmem = 232448 - 2048;   // dynamic, beside the static

template <int GR, int RR, int GV, int RV, int TV>
cudaError_t k2_launch(const CUtensorMap& rmap, const CUtensorMap& cmap,
                      const K2Args& a, int num_q, size_t smem,
                      cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(k2_kernel<GR, RR, GV, RV, TV>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.out_cols / kK2Gates, (a.num_v + TV - 1) / TV, num_q);
  k2_kernel<GR, RR, GV, RV, TV><<<grid, kK2Threads, smem, st>>>(rmap, cmap, a);
  return cudaGetLastError();
}

template <int GR, int RR, int GV, int RV, int TV, int GT>
cudaError_t k3_launch(const CUtensorMap& rmap, const CUtensorMap& cmap,
                      const K3Args& a, int groups, size_t smem,
                      cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(k3_kernel<GR, RR, GV, RV, TV, GT>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.num_g + GT - 1) / GT, (a.num_v + TV - 1) / TV, groups);
  k3_kernel<GR, RR, GV, RV, TV, GT><<<grid, kK3Threads, smem, st>>>(rmap, cmap,
                                                                     a);
  return cudaGetLastError();
}

// The compiled-in windows (guard/ref range, guard/ref Doppler) and their
// tiles (K2: rows; K3: rows, gates); the generic instance's tiles follow.
constexpr int kWins[2][4] = {{10, 5, 10, 5}, {10, 5, 4, 3}};
constexpr int kK2Tv = 32, kK2TvGeneric = 16;
constexpr int kK3Tv = 32, kK3Gt = 128, kK3TvGeneric = 16, kK3GtGeneric = 32;

bool fixed_window(int instance, int gr, int rr, int gv, int rv) {
  return gr == kWins[instance][0] && rr == kWins[instance][1] &&
         gv == kWins[instance][2] && rv == kWins[instance][3];
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
  const bool fixed = instance == 0 || instance == 1;
  if (instance < 0 || instance > 2 || out_cols < kK2Gates ||
      out_cols % kK2Gates != 0 || num_g > out_cols || num_v > v_pad ||
      hr > halo || hv > halo || rnc < 1 || cnr < 1 ||
      (long long)rnc * rw < kK2Gates + 2 * hrp ||
      (long long)cnr * cbh < tv + 2 * hv || (rnc > 1 && rw != kK2Gates) ||
      (fixed && (!fixed_window(instance, gr, rr, gv, rv) || tv != kK2Tv ||
                 rnc != 1 || cnr != 1 || rw != kK2Gates + 2 * hrp)) ||
      (!fixed && tv != kK2TvGeneric) ||
      reinterpret_cast<uintptr_t>(mask) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(rc, 0, sizeof(int) * (size_t)num_q * out_cols, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap rmap, cmap;
  const float* base = static_cast<const float*>(maps) + halo;
  if (!tile_map(&rmap, base, num_q, num_v, num_g, g_pad, (long long)v_pad * g_pad,
                rw, tv) ||
      !tile_map(&cmap, base, num_q, num_v, num_g, g_pad, (long long)v_pad * g_pad,
                kK2Gates, cbh))
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
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (instance == 0) err = k2_launch<10, 5, 10, 5, kK2Tv>(rmap, cmap, a, num_q, smem, st);
  else if (instance == 1) err = k2_launch<10, 5, 4, 3, kK2Tv>(rmap, cmap, a, num_q, smem, st);
  else err = k2_launch<-1, -1, -1, -1, kK2TvGeneric>(rmap, cmap, a, num_q, smem, st);
  return (int)err;
}

// mag [num_b, num_v, num_g] f32, row stride ld (a multiple of 4) and beam
// stride num_v * ld floats, 16-byte aligned; mask [num_b-1, num_v, num_g]
// bool and thr [num_b-1, num_v, num_g] f32, contiguous. method: 0 GOCA, 1
// SOCA, 2 CA. instance as k2_cfar's; tv, gt, rw, rnc, cbh, cnr, groups: the
// staging geometry of ops/cfar_kernel.py::k3_geometry (a compiled-in
// window: one box [cbh][rw] a beam; generic: the row and column strips).
int k3_cfar(const void* mag, int num_b, int num_v, int num_g, int ld, int gr,
            int rr, int gv, int rv, float inv_rr, float inv_rv, float factor,
            int method, int instance, int tv, int gt, int rw, int rnc, int cbh,
            int cnr, int groups, void* mask, void* thr, void* stream) {
  const int hr = gr + rr, hv = gv + rv, hrp = (hr + 3) & ~3;
  const bool fixed = instance == 0 || instance == 1;
  if (instance < 0 || instance > 2 || num_b < 2 || num_v < 1 || num_g < 1 ||
      ld < num_g || rnc < 1 || cnr < 1 || groups < 1 || groups > num_b - 1 ||
      (fixed && (!fixed_window(instance, gr, rr, gv, rv) || tv != kK3Tv ||
                 gt != kK3Gt || rnc != 1 || cnr != 1 || rw != gt + 2 * hrp ||
                 cbh != tv + 2 * hv)) ||
      (!fixed && (tv != kK3TvGeneric || gt != kK3GtGeneric ||
                  (long long)rnc * rw < gt + 2 * hrp ||
                  (long long)cnr * cbh < tv + 2 * hv || rw % 4 != 0 ||
                  (long long)tv * rw % 32 != 0 || (long long)cbh * gt % 32 != 0)) ||
      ((num_g & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) % 4 != 0 ||
                            reinterpret_cast<uintptr_t>(thr) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap rmap, cmap;
  const float* base = static_cast<const float*>(mag);
  const long long plane_ld = (long long)num_v * ld;
  if (!tile_map(&rmap, base, num_b, num_v, num_g, ld, plane_ld, rw,
                fixed ? cbh : tv) ||
      !tile_map(&cmap, base, num_b, num_v, num_g, ld, plane_ld, gt, cbh))
    return (int)cudaErrorInvalidValue;
  K3Args a{};
  a.w = Window{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  a.num_b = num_b;
  a.num_v = num_v;
  a.num_g = num_g;
  a.hrp = hrp;
  a.rw = rw;
  a.rnc = rnc;
  a.cbh = cbh;
  a.cnr = cnr;
  const long long row_floats =
      fixed ? (long long)cbh * rw : ((long long)rnc * tv * rw + 31) / 32 * 32;
  const long long col_floats = fixed ? 0 : (long long)cnr * cbh * gt;
  a.col_off = (int)row_floats;
  a.slot_floats = (int)((row_floats + col_floats + 31) / 32 * 32);
  a.tx_bytes = (unsigned)((fixed ? row_floats
                                 : (long long)rnc * tv * rw + col_floats) * 4);
  a.mask = static_cast<bool*>(mask);
  a.thr = static_cast<float*>(thr);
  const size_t smem = (size_t)kK3Slots * a.slot_floats * 4 + 128;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 0)
    err = k3_launch<10, 5, 10, 5, kK3Tv, kK3Gt>(rmap, cmap, a, groups, smem, st);
  else if (instance == 1)
    err = k3_launch<10, 5, 4, 3, kK3Tv, kK3Gt>(rmap, cmap, a, groups, smem, st);
  else
    err = k3_launch<-1, -1, -1, -1, kK3TvGeneric, kK3GtGeneric>(rmap, cmap, a,
                                                                groups, smem, st);
  return (int)err;
}

}  // extern "C"
