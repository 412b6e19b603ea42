"""K3 and K10 before and after their redesign for Hopper, and the design's
variants, on one NVIDIA GPU at full frame shapes (one JSON line).

    python3 scripts/ablate_k3_k10.py [--reps 10]

K3 (pair sum + 2D GOCA-CFAR, [13, 332, 3404] magnitudes, the full config's
window): ``old`` is the first K3 (a block per (pair, 16-row, 128-gate)
tile, plain loads with an integer division per staged element, each pair
reading both of its beam planes, one cell a thread), kept only here
(``OLD_K3``, appended to a copy of ``radar_tpu_torch/csrc/cfar.cu``);
``new`` is the port's K3 (a block walks every beam of its tile through a
ring of TMA-staged slots); ``no_walk`` is the new kernel with each pair
loading both of its beams (the lines of ``WALK`` changed in a copy of
cfar.cu). Each is held bit for bit against the plain version, then timed
in turns with CUDA events on a card kept busy by a sleep kernel (and on
an idle one), with the host's time a call and the profiler's kernel time.

K10 at bf16 (perf config, a compact white cube holding K1c's planes,
through ``noise_rdm_compact(variant="resident", mul_dtype=bf16)``):
``strip`` is the port (its PC the strip GEMM of csrc/band_pc_sm90.cu, as
K7's and K9's), ``ring`` routes the same PC through the resident ring
(``RING``, K10's PC until this comparison moved it, kept only here,
appended to a copy of csrc/rdm_sm90.cu): whether residency pays on this
card. Both are held within 3e-4
RMS of the plain version and timed in turns, with the profiler's split.

The DFT of K10 and K7 at bf16: ``wgmma`` is the port's dft_kernel
(csrc/rdm_sm90.cu), ``mma_sync`` the first bf16 DFT, mtd_gemm_tc_kernel
(synchronous scalar staging into mma.sync m16n8k16), kept only here
(``OLD_DFT``, appended to csrc/rdm_variants.cu as it was before the
mix's redesign, ``scripts/ablate_mix.py``'s ``OLD_SOURCE``, after
``ablate_k7_k8.py``'s ``OLD_HELPERS``, its mma.sync GEMM), on the same pc
planes; both held within 3e-4 RMS of the plain product and timed in
turns.

Where the ring PC spends its time (``ring``): the ring and copies of it
with one part taken out (``RING_VARIANTS``:
the DSMEM exchange, the output stores, the MMAs, the reloads of strip
stages and chunks after the first), each timed alone on each segment and
on all three at once (busy card); their outputs are wrong by design. A
copy with `globaltimer` stamps (``STAMPS``) records, for two clusters, when
each warpgroup starts a pair of tiles, ends its MMAs, has the peer's
slot free, has the peer's half, and has stored its tile (700-tap
segment); the medians of those phases over the pairs are reported.

Builds into ``build/ablate_k3_k10/``; prints the card's name and power
limit in the line. Needs the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ablate_k1 import _events, _load, _profile  # noqa: E402

# the first K3: one block per (pair, 16-row, 128-gate) tile, the pair sums
# staged with plain loads, one cell a thread
OLD_K3 = r"""
namespace {
constexpr int kVT = 16;       // Doppler rows per block
constexpr int kGT = 128;      // gates per block
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
k3_old_kernel(const float* __restrict__ mag, int num_v, int num_g, Window w,
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

extern "C" int k3_cfar_old(const void* mag, int num_b, int num_v, int num_g,
                           int gr, int rr, int gv, int rv, float inv_rr,
                           float inv_rv, float factor, int method, void* mask,
                           void* thr, void* stream) {
  const Window w{gr, rr, gv, rv, inv_rr, inv_rv, factor, method};
  const int hr = gr + rr, hv = gv + rv;
  const size_t smem = ((size_t)kVT * (kGT + 2 * hr) +
                       (size_t)(kVT + 2 * hv) * kGT) * sizeof(float);
  cudaFuncSetAttribute(k3_old_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((num_g + kGT - 1) / kGT, (num_v + kVT - 1) / kVT,
                  num_b - 1);
  k3_old_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag), num_v, num_g, w,
      static_cast<bool*>(mask), static_cast<float*>(thr));
  return (int)cudaGetLastError();
}
"""
OLD_K3_SIGNATURE = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
# the beam walk, and each pair loading both of its beams instead
WALK = ("""  const int n_loads = q1 - q0 + 1;
  auto beam = [&](int k) { return q0 + k; };
  auto first = [](int q) { return q; };
""", """  const int n_loads = 2 * (q1 - q0);
  auto beam = [&](int k) { return q0 + ((k + 1) >> 1); };
  auto first = [](int q) { return 2 * q; };
""")

# the first bf16 DFT: mtd_gemm_kernel on the tensor cores through mma.sync,
# operands staged by scalar loads
OLD_DFT = r"""
namespace {
__global__ void __launch_bounds__(kThreads)
mtd_gemm_tc_kernel(const float* __restrict__ dr, const float* __restrict__ di,
                   const __nv_bfloat16* __restrict__ pcr,
                   const __nv_bfloat16* __restrict__ pci, int num_v, int num_p,
                   int num_g, __nv_bfloat16* __restrict__ mtr,
                   __nv_bfloat16* __restrict__ mti) {
  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kBM;
  const int g0 = blockIdx.x * kBN;
  const long long base = (long long)b * num_p * num_g;
  TcAcc acc;
  tc_gemm(
      0, num_p,
      [&](int m, int k) {
        const long long off = (long long)(v0 + m) * num_p + k;
        return v0 + m < num_v ? make_float2(dr[off], di[off]) : make_float2(0.f, 0.f);
      },
      [&](int k, int n) {
        const long long off = base + (long long)k * num_g + g0 + n;
        return g0 + n < num_g ? make_float2(__bfloat162float(pcr[off]),
                                            __bfloat162float(pci[off]))
                              : make_float2(0.f, 0.f);
      },
      acc);
  tc_store(acc, [&](int m, int n, float cr, float ci) {
    const int v = v0 + m, g = g0 + n;
    if (v >= num_v || g >= num_g) return;
    const long long off = ((long long)b * num_v + v) * num_g + g;
    mtr[off] = __float2bfloat16_rn(cr);
    mti[off] = __float2bfloat16_rn(ci);
  });
}
}  // namespace

extern "C" int rv_mtd_tc(const void* dr, const void* di, const void* pcr,
                         const void* pci, int num_b, int num_v, int num_p,
                         int num_g, void* mtr, void* mti, void* stream) {
  const dim3 grid((num_g + kBN - 1) / kBN, (num_v + kBM - 1) / kBM, num_b);
  mtd_gemm_tc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<const __nv_bfloat16*>(pcr),
      static_cast<const __nv_bfloat16*>(pci), num_v, num_p, num_g,
      static_cast<__nv_bfloat16*>(mtr), static_cast<__nv_bfloat16*>(mti));
  return (int)cudaGetLastError();
}
"""
OLD_DFT_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p] * 3

# pipeline and cluster helpers of the ring and of K9's fused tail
# (scripts/ablate_k4_k9.py), appended to a copy of csrc/rdm_sm90.cu
CLUSTER = r"""
namespace {

constexpr int kMaxSmem = 232448;   // shared bytes a block may have

// A pipeline position: a slot of `n` and the parity of its current round.
struct Slot {
  int i = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) {
      i = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait at cluster scope (the phase completed by the peer's arrive).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, unsigned parity) {
  auto try_wait = [&]() {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
  };
  if (try_wait()) return;
  const unsigned long long t0 = now_ns();
  while (!try_wait())
    if (now_ns() - t0 > kTimeoutNs) __trap();
}

}  // namespace
"""

# K10's first bf16 PC, the resident ring (after CLUSTER)
RING = r"""
// K10's bf16 resident-ring PC, appended with CLUSTER to a copy of
// rdm_sm90.cu, whose helpers it uses.
//
// ring_pc_kernel. Per segment the causal convolution of the padded sample
// buffer x is the Toeplitz product Y[r, j0 + n] = sum_k X[r, j0 + k] S[k, n]
// with one strip S = M[:64 + lh - 1, :64] for every 64-gate tile (the
// plan's bf16 strip `RdmSegSpec.strip`, whose first 64 gates it is). A
// cluster of two CTAs owns 64 rows (beam, pulse) and a run of consecutive
// 64-gate tiles of one segment, and keeps the rows' samples resident: CTA
// 0 a ring of Xr, CTA 1 a ring of Xi, each `slots` = kt + 1 chunks of 64
// samples (boxes [64 rows][64 samples], 128-byte swizzle), kt = ceil((64 +
// lh - 1) / 64) the chunks a tile reads. A tile loads only its new chunk,
// into the slot of a chunk no tile in flight reads any more; so each sample
// is loaded from device memory about once per run, where the strip GEMM of
// band_pc_sm90.cu loads it (128 + lh - 1)/128 times. The strip, the same
// for every tile, streams from L2 through `stages` stages holding the
// stacked [Sr | Si] (CTA 1: [Si | Sr]) as one [128 gates][64 k] operand.
// Two producer threads issue the TMA loads (completion on mbarriers), one
// the strip stages in order, one each chunk as soon as its slot is free
// (about a pair of tiles before its use); two consumer warpgroups take
// alternate tiles, both reading each strip stage, and run wgmma
// m64n128k16 with both operands from shared memory: acc = [XrSr | XrSi]
// (CTA 1: [XiSi | XiSr]) in f32. After a tile the CTAs swap
// the halves they do not finish through distributed shared memory (16 KB,
// st.async, completion on the receiver's mbarrier): CTA 0 rounds Yr = XrSr
// - XiSi to the real bf16 plane, CTA 1 Yi = XrSi + XiSr to the imaginary
// one; the exchange slot then stages the rounded tile, so that the stores
// cover whole runs of a row (a TMA store would need the tile's first gate
// on 16 bytes; the segments start at gates 228 and 951). Slots and stages
// advance as counters with a parity bit (no division in the loop).
// Capacity is what shaped it: both planes' ring for the 700-tap
// segment (2 x 12 chunks, 192 KB) left one CTA room for only two strip
// stages, whose L2 latency then showed once a chunk; split by plane, a
// CTA's ring is 104 KB and five stages fit beside it. The m64n128k16 pair
// also reads 6 KB of shared operands a 64-clock instruction (96 B a clock)
// where two m64n64k16 needed 128. One launch covers the three segments
// through a segment table, the longest k loop first. What holds it (timed
// inside on an H100, 700-tap segment; PERF.md): a pair of tiles
// spends about as long in the exchange, the epilogue and the turn to the
// next pair as in its MMA steps, and both warpgroups reach those together,
// as they share every strip stage.

namespace {

constexpr int kMaxSeg = 3;

template <typename T>
__device__ __forceinline__ const T& pick(const T (&v)[kMaxSeg], int s) {
  return s == 0 ? v[0] : (s == 1 ? v[1] : v[2]);
}

// ------------------------------------------------------- the ring PC

constexpr int kRows = 64;                  // rows a tile (the wgmma M)
constexpr int kGates = 64;                 // gates a tile
constexpr int kChunk = 64;                 // samples a ring chunk (128 bytes)
constexpr int kBox = kRows * kChunk * 2;   // bytes of a [64][64] bf16 box
constexpr int kStageBytes = 2 * kBox;      // [Sa | Sb]: [128 n][64 k]
constexpr int kXchgBytes = kRows * kGates * 4;   // half an accumulator
constexpr int kRingWG = 2;                 // consumer warpgroups: even, odd tiles
constexpr int kRingThreads = 128 * kRingWG + 64;   // + the producer warps
constexpr int kMaxSlots = 16;
constexpr int kMaxStages = 8;

struct RingSeg {
  int blk0;               // first cluster of the segment
  int runs;               // runs of tiles a 64-row block
  int per_run;            // tiles a run
  int ntiles;             // 64-gate tiles of the segment
  int kt;                 // chunks a tile reads
  int slots, stages;      // ring slots, strip stages
  int j_len, g0;          // output gates and their offset
};

struct RingArgs {
  CUtensorMap xr[kMaxSeg], xi[kMaxSeg];   // bf16 [rows, x_cols], boxes [64][64]
  CUtensorMap sr[kMaxSeg], si[kMaxSeg];   // strip planes [128, k_pad], [64][64]
  RingSeg seg[kMaxSeg];
  int n_seg, rows, ld;                    // ld: the output's row stride
  __nv_bfloat16* outr;                    // bf16 [rows, ld], gates g0 + j
  __nv_bfloat16* outi;
};

// 16 bytes into the peer's shared memory, completion counted in bytes on
// the peer's barrier.
__device__ __forceinline__ void st_async4(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// A cluster of two CTAs per (64 rows, run of tiles): CTA 0 (the real
// plane) keeps a ring of Xr, CTA 1 (the imaginary plane) a ring of Xi. A
// tile's product with the stacked strip [Sr | Si] (CTA 1: [Si | Sr]) is
// acc = [XrSr | XrSi] (CTA 1: [XiSi | XiSr]); the CTAs swap the halves they
// do not finish, and CTA 0 writes Yr = XrSr - XiSi, CTA 1 Yi = XrSi + XiSr.
// Warpgroup w takes tiles 2u + w; both read strip stage u * kt + i, which
// goes back to the producer when both are done with it. A run with an odd
// number of tiles gets a last tile that is computed and not stored.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kRingThreads, 1)
    ring_pc_kernel(const __grid_constant__ RingArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t rank = cluster_rank();
  const int work = blockIdx.x >> 1;

  int s = 0;
  while (s + 1 < a.n_seg && work >= pick(a.seg, s + 1).blk0) ++s;
  const RingSeg sg = pick(a.seg, s);
  const int local = work - sg.blk0;
  const int m0 = (local / sg.runs) * kRows;
  const int t_first = (local % sg.runs) * sg.per_run;
  const int nt = min(sg.ntiles, t_first + sg.per_run) - t_first;
  const int pairs = (nt + 1) >> 1;
  const int kt = sg.kt, slots = sg.slots, stages = sg.stages;
  const uint32_t ring = tiles;
  const uint32_t strip = ring + slots * kBox;
  const uint32_t xchg = strip + stages * kStageBytes;
  const uint32_t bars = xchg + kRingWG * kXchgBytes;
  // barriers: the slots' full and empty, the stages' full and empty, then
  // per warpgroup the exchange's received and sent-slot-free
  auto xfull = [&](int i) { return bars + 8u * i; };            // slot i
  auto xempty = [&](int i) { return bars + 8u * (slots + i); };
  auto sfull = [&](int i) { return bars + 8u * (2 * slots + i); };   // stage i
  auto sempty = [&](int i) { return bars + 8u * (2 * slots + stages + i); };
  auto recv = [&](int w) { return bars + 8u * (2 * slots + 2 * stages + w); };
  auto sent = [&](int w) { return bars + 8u * (2 * slots + 2 * stages + kRingWG + w); };

  if (threadIdx.x == 0) {
    // a chunk goes back when both warpgroups are done with it (with kt = 1
    // only the tile of its own index reads it)
    for (int i = 0; i < slots; ++i) {
      mbar_init(xfull(i), 1);
      mbar_init(xempty(i), kt > 1 ? kRingWG : 1);
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(sfull(i), 1);
      mbar_init(sempty(i), kRingWG);
    }
    for (int w = 0; w < kRingWG; ++w) {
      mbar_init(recv(w), 1);
      mbar_init(sent(w), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // the peer's barriers exist before any remote use

  if (threadIdx.x >= 128 * kRingWG) {
    // the producers, one thread each: the strip stages in order (stage x is
    // step x % kt of pair x / kt), and the ring's chunks as soon as their
    // slots are free (chunk c of the run holds samples 64 (t_first + c) ..
    // of this CTA's plane), so a chunk lands about a pair before its use
    if (threadIdx.x == 128 * kRingWG) {
      const CUtensorMap* msa = rank == 0 ? &pick(a.sr, s) : &pick(a.si, s);
      const CUtensorMap* msb = rank == 0 ? &pick(a.si, s) : &pick(a.sr, s);
      Slot st;
      for (int x = 0, i = 0; x < pairs * kt; ++x, st.next(stages)) {
        if (x >= stages) mbar_wait(sempty(st.i), st.phase ^ 1);
        const uint32_t dst = strip + st.i * kStageBytes;
        mbar_expect_tx(sfull(st.i), kStageBytes);
        tma_load(dst, msa, kChunk * i, 0, sfull(st.i));
        tma_load(dst + kBox, msb, kChunk * i, 0, sfull(st.i));
        if (++i == kt) i = 0;
      }
    } else if (threadIdx.x == 128 * kRingWG + 32) {
      const CUtensorMap* mx = rank == 0 ? &pick(a.xr, s) : &pick(a.xi, s);
      Slot sl;
      for (int c = 0; c < 2 * pairs + kt - 1; ++c, sl.next(slots)) {
        if (c >= slots) mbar_wait(xempty(sl.i), sl.phase ^ 1);
        mbar_expect_tx(xfull(sl.i), kBox);
        tma_load(ring + sl.i * kBox, mx, kChunk * (t_first + c), m0,
                 xfull(sl.i));
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t peer = rank ^ 1u;
  const uint32_t my_xchg = xchg + wg * kXchgBytes;
  const uint32_t peer_xchg = peer_addr(my_xchg, peer);
  const uint32_t peer_recv = peer_addr(recv(wg), peer);
  const uint32_t peer_sent = peer_addr(sent(wg), peer);
  unsigned char* slot = smem_raw + (my_xchg - smem_u32(smem_raw));
  // chunk c is last read by tile c (step 0) and tile c - 1 (step 1), one of
  // each warpgroup; the run's first chunk has no tile before it
  if (wg == 1 && kt > 1 && tid == 0) mbar_arrive(xempty(0));
  float acc[64];
  Slot st;                        // the strip stage of the step
  for (int u = 0; u < pairs; ++u) {
    const int t = 2 * u + wg;
    Slot ch{t % slots, (t / slots) & 1};   // the chunk of the step, t + i
    int prev_stage = 0, first_chunk = ch.i, second_chunk = 0;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    fence_acc64(acc);
    for (int i = 0; i < kt; ++i) {
      mbar_wait(xfull(ch.i), ch.phase);
      mbar_wait(sfull(st.i), st.phase);
      __syncwarp();   // the wgmma instructions below are .sync.aligned
      const uint32_t x_t = ring + ch.i * kBox;
      const uint32_t s_t = strip + st.i * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_n128<1, 0>(acc, desc_k(x_t + 32 * kk), desc_k(s_t + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc64(acc);
      // step i - 1's MMAs are done: its strip stage goes back, and so do
      // chunks t and t + 1, which this warpgroup's next tile (t + 2) does
      // not read
      if (i > 0 && tid == 0) {
        mbar_arrive(sempty(prev_stage));
        if (i == 1) mbar_arrive(xempty(first_chunk));
        if (i == 2) mbar_arrive(xempty(second_chunk));
      }
      prev_stage = st.i;
      if (i == 1) second_chunk = ch.i;
      st.next(stages);
      ch.next(slots);
    }
    wgmma_wait<0>();
    fence_acc64(acc);
    if (tid == 0) {
      mbar_arrive(sempty(prev_stage));
      if (kt == 1) mbar_arrive(xempty(first_chunk));
      if (kt == 2) mbar_arrive(xempty(second_chunk));
    }

    // the exchange: the peer's slot is free once it has read the last pair's
    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);
    if (tid == 0) mbar_expect_tx(recv(wg), kXchgBytes);
    // CTA 0 finishes the left half (Yr) and gives the right, CTA 1 the
    // reverse (registers [0, 32) hold the left half; indices stay
    // compile-time, or the accumulators would leave the registers)
    if (rank == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        st_async4(peer_xchg + (q * 128 + tid) * 16,
                  make_float4(acc[32 + 4 * q], acc[33 + 4 * q],
                              acc[34 + 4 * q], acc[35 + 4 * q]),
                  peer_recv);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        st_async4(peer_xchg + (q * 128 + tid) * 16,
                  make_float4(acc[4 * q], acc[1 + 4 * q], acc[2 + 4 * q],
                              acc[3 + 4 * q]),
                  peer_recv);
    }
    mbar_wait(recv(wg), u & 1);
    float y[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(slot + (q * 128 + tid) * 16);
      const float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[4 * q + e] = rank == 0 ? __fsub_rn(acc[4 * q + e], o[e])
                                 : __fadd_rn(o[e], acc[32 + 4 * q + e]);
    }
    // every thread has read the slot: it stages the rounded tile
    // [64 rows][64 gates] at the 16-byte phase of its first gate in the
    // output (element j of a row at column j + sh), so that a row's whole
    // 8-gate chunks go out as 16-byte stores and only its two edge chunks
    // gate by gate. Register 4c + 2h + e of lane l in warp w holds row 16 w
    // + l/4 + 8 h, gate 8 c + 2 (l % 4) + e of the tile (c < 8).
    constexpr int kLdo = 2 * (kGates + 16);  // staged row stride, bytes
    const int j0 = kGates * (t_first + t);
    const int sh = (sg.g0 + j0) & 7;
    const int n_out = min(kGates, sg.j_len - j0);   // gates of the tile kept
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int cg = 0; cg < kGates / 8; ++cg) {
        __nv_bfloat16* st_row = reinterpret_cast<__nv_bfloat16*>(
            slot + (16 * warp + (lane >> 2) + 8 * h) * kLdo);
        const int j = 8 * cg + 2 * (lane & 3) + sh;
        st_row[j] = __float2bfloat16_rn(y[4 * cg + 2 * h]);
        st_row[j + 1] = __float2bfloat16_rn(y[4 * cg + 2 * h + 1]);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t < nt) {
      // chunk k of a staged row holds gates 8k - sh .. 8k - sh + 7 of the
      // tile, at output column g0 + j0 - sh + 8k (a 16-byte boundary)
      __nv_bfloat16* out = (rank == 0 ? a.outr : a.outi) + sg.g0 + j0 - sh;
      const int chunks = (sh + n_out + 7) >> 3;
      for (int p = tid; p < kRows * chunks; p += 128) {
        const int r = p / chunks, k = p - r * chunks;
        if (m0 + r >= a.rows) break;
        const unsigned char* src = slot + r * kLdo + 16 * k;
        __nv_bfloat16* dst = out + (long long)(m0 + r) * a.ld + 8 * k;
        if (8 * k >= sh && 8 * k + 8 <= sh + n_out) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (8 * k + e >= sh && 8 * k + e < sh + n_out)
              dst[e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
        }
      }
    }
    // the slot is read: the peer may write the next pair's half
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);
  }
}

// Ring slots and strip stages of a segment whose tiles read kt chunks:
// kt + 1 slots (two warpgroups' tiles in flight), then as many strip
// stages as fit beside them and the exchange (up to kMaxStages). Returns
// the dynamic shared memory it needs, or 0 if fewer than two stages fit.
int ring_geometry(int kt, int* slots, int* stages) {
  const int fixed = 1024 + 8 * 2 * (kMaxSlots + kMaxStages + kRingWG) +
                    kRingWG * kXchgBytes;
  *slots = kt + 1;
  *stages = (kMaxSmem - fixed - *slots * kBox) / kStageBytes;
  if (*stages > kMaxStages) *stages = kMaxStages;
  if (*slots > kMaxSlots || *stages < 2) return 0;
  return *slots * kBox + *stages * kStageBytes + kRingWG * kXchgBytes + 1024 +
         8 * 2 * (*slots + *stages + kRingWG);
}

}  // namespace

// K10's ring PC over n_seg (1..3) segments in one launch (clusters of two
// CTAs, one a plane). tab holds 10
// values a segment: the bf16 sample buffers xr, xi [rows, x_cols] (row
// stride x_ld, a multiple of 8; 16-byte aligned), x_cols, x_ld, the strip
// [2, 128, k_pad] bf16 (k contiguous; k_pad a multiple of 64), k_pad, the
// filter's taps lh, the segment's gates j_len, their offset g0 in the
// output, and the 64-gate tiles a block walks. Writes the rounded bf16
// planes outr, outi [rows, ld] at gates g0 .. g0 + j_len - 1.
extern "C" int rs_ring_pc(int n_seg, const long long* tab, int rows, int ld, void* outr,
               void* outi, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 || ld < 1 || outr == nullptr ||
      outi == nullptr)
    return (int)cudaErrorInvalidValue;
  int order[kMaxSeg] = {0, 1, 2};
  for (int i = 0; i < n_seg; ++i)      // longest k loop first
    for (int j = i + 1; j < n_seg; ++j)
      if (tab[10 * order[j] + 6] > tab[10 * order[i] + 6]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  RingArgs a{};
  const int row_blocks = (rows + kRows - 1) / kRows;
  long long blocks = 0;
  int smem = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 10 * order[i];
    const long long k_pad = t[5], lh = t[6], j_len = t[7], per_run = t[9];
    const int kt = (int)((kGates + lh - 1 + kChunk - 1) / kChunk);
    int slots = 0, stages = 0;
    const int need = ring_geometry(kt, &slots, &stages);
    if (lh < 1 || j_len < 1 || per_run < 1 || t[8] < 0 || t[8] + j_len > ld || k_pad < (long long)kt * kChunk ||
        k_pad % kChunk != 0 || need == 0 ||
        !make_map(&a.xr[i], t[0], t[2], rows, t[3], kRows) ||
        !make_map(&a.xi[i], t[1], t[2], rows, t[3], kRows) ||
        !make_map(&a.sr[i], t[4], k_pad, 128, k_pad, kGates) ||
        !make_map(&a.si[i], t[4] + 2 * 128 * k_pad, k_pad, 128, k_pad, kGates))
      return (int)cudaErrorInvalidValue;
    const int ntiles = (int)((j_len + kGates - 1) / kGates);
    const int runs = (ntiles + (int)per_run - 1) / (int)per_run;
    a.seg[i] = RingSeg{(int)blocks, runs, (int)per_run, ntiles, kt, slots,
                       stages, (int)j_len, (int)t[8]};
    blocks += (long long)row_blocks * runs;   // clusters of two CTAs
    if (need > smem) smem = need;
  }
  if (2 * blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.n_seg = n_seg;
  a.rows = rows;
  a.ld = ld;
  a.outr = static_cast<__nv_bfloat16*>(outr);
  a.outi = static_cast<__nv_bfloat16*>(outi);
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(ring_pc_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  ring_pc_kernel<<<(unsigned)(2 * blocks), kRingThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

"""
RING_SIGNATURE = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
RING_TILE = 64      # gates of a ring tile
RING_RUN = 10       # most such tiles a ring block walks

# copies of the ring with a part taken out: (old, new) text pairs
RING_VARIANTS = {
    "no_exchange": (
        ("    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n"
         "    if (tid == 0) mbar_expect_tx(recv(wg), kXchgBytes);\n",
         "    if (false) {\n"),
        ("    mbar_wait(recv(wg), u & 1);\n", "    }\n"),
        ("    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n",
         "")),
    "no_store": (("    if (t < nt) {\n      // chunk k of a staged row",
                  "    if (false) {\n      // chunk k of a staged row"),),
    "no_mma": (("        wgmma_n128<1, 0>(acc, desc_k(x_t + 32 * kk), "
                "desc_k(s_t + 32 * kk));\n", ""),),
    "loads_once": (
        ("x < pairs * kt; ++x, st.next(stages))",
         "x < stages; ++x, st.next(stages))"),
        ("      mbar_wait(sfull(st.i), st.phase);\n",
         "      if (u * kt + i < stages) mbar_wait(sfull(st.i), st.phase);\n"),
        ("c < 2 * pairs + kt - 1; ++c, sl.next(slots))",
         "c < slots; ++c, sl.next(slots))"),
        ("      mbar_wait(xfull(ch.i), ch.phase);\n",
         "      if (t + i < slots) mbar_wait(xfull(ch.i), ch.phase);\n")),
}
# the stamped copy: a stamp array and its reader, and five stamps a pair
STAMP = ("if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == 200)) "
         "g_stamp[(blockIdx.x ? 2048 : 0) + wg * 1024 + u * 8 + {k}] = "
         "now_ns();\n")
STAMPS = (
    ("__global__ void __cluster_dims__(2, 1, 1)",
     "__device__ unsigned long long g_stamp[4096];\n"
     "__global__ void __cluster_dims__(2, 1, 1)"),
    ("  cluster_sync();   // the peer",
     "  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == 200)) "
     "g_stamp[(blockIdx.x ? 2048 : 0) + 1023] = now_ns();\n"
     "  cluster_sync();   // the peer"),
    ("    const int t = 2 * u + wg;\n",
     "    const int t = 2 * u + wg;\n    " + STAMP.format(k=0)),
    ("    wgmma_wait<0>();\n    fence_acc64(acc);\n    if (tid == 0) {\n"
     "      mbar_arrive(sempty(prev_stage));",
     "    wgmma_wait<0>();\n    fence_acc64(acc);\n    " + STAMP.format(k=1)
     + "    if (tid == 0) {\n      mbar_arrive(sempty(prev_stage));"),
    ("    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n",
     "    if (u > 0) mbar_wait_cluster(sent(wg), (u - 1) & 1);\n    "
     + STAMP.format(k=2)),
    ("    mbar_wait(recv(wg), u & 1);\n",
     "    mbar_wait(recv(wg), u & 1);\n    " + STAMP.format(k=3)),
    ("    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n",
     "    " + STAMP.format(k=4)
     + "    if (tid == 0 && u + 1 < pairs) mbar_arrive_peer(peer_sent);\n"),
    ('extern "C" int rs_ring_pc(',
     'extern "C" int rs_stamps(void* out) {\n  return (int)cudaMemcpyFromSymbol('
     'out, g_stamp, sizeof(g_stamp));\n}\nextern "C" int rs_ring_pc('),
)


def build(build_dir: str) -> dict:
    """The copies of cfar.cu (the old K3 appended; the walk off), of
    rdm_variants.cu (the old DFT appended) and of rdm_sm90.cu (the ring
    appended, and its variants), each built with its source's flags (one
    nvcc each, all at once) and loaded."""
    from ablate_k7_k8 import OLD_HELPERS
    from ablate_mix import OLD_SOURCE

    from radar_tpu_torch import _build

    src = lambda name: open(os.path.join(_build._CSRC, name + ".cu")).read()
    cfar = src("cfar")
    if cfar.count(WALK[0]) != 1:
        raise RuntimeError("cfar.cu no longer has the text no_walk changes")
    sources = {"k3_old": (cfar + OLD_K3, "cfar"),
               "k3_no_walk": (cfar.replace(*WALK), "cfar"),
               "dft_old": (OLD_SOURCE + OLD_HELPERS + OLD_DFT,
                           "rdm_variants")}
    ring = src("rdm_sm90") + CLUSTER + RING
    sources["ring_shipped"] = (ring, "rdm_sm90")
    for name, cuts in list(RING_VARIANTS.items()) + [("stamps", STAMPS)]:
        text = ring
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"rdm_sm90.cu no longer has the text "
                                   f"{name} changes: {old[:60]!r}")
            text = text.replace(old, new, 1)
        sources[f"ring_{name}"] = (text, "rdm_sm90")
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, (text, base) in sources.items():
        cu = os.path.join(build_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(build_dir, f"lib{name}.so")
        procs[name] = (so, base, subprocess.Popen(
            [_build._nvcc(), *_build._COMMON, *_build._EXTRA[base], "-I",
             _build._CSRC, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, base, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = _load(so, base)
    libs["k3_old"].k3_cfar_old.argtypes = OLD_K3_SIGNATURE
    libs["k3_old"].k3_cfar_old.restype = ctypes.c_int
    libs["dft_old"].rv_mtd_tc.argtypes = OLD_DFT_SIGNATURE
    libs["dft_old"].rv_mtd_tc.restype = ctypes.c_int
    libs["ring_stamps"].rs_stamps.argtypes = [ctypes.c_void_p]
    libs["ring_stamps"].rs_stamps.restype = ctypes.c_int
    for name in libs:
        if name.startswith("ring_"):
            libs[name].rs_ring_pc.argtypes = RING_SIGNATURE
            libs[name].rs_ring_pc.restype = ctypes.c_int
    return libs


def ring_pc(lib, segments, rows: int, ld: int, outr, outi) -> None:
    """Launch the ring PC of ``lib`` over up to three segments at once.
    ``segments``: (xr, xi, strip, lh, j_len, g0) each, as ``strip_pc``'s
    with the filter length ``lh``. Writes gates g0 .. g0+j_len-1 of each row
    of the rounded bfloat16 planes ``outr``, ``outi`` [rows, ld] (ld a
    multiple of 8)."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    dev = outr.device
    if not 1 <= len(segments) <= 3 or ld % 8 or any(
            t.device != dev or t.dtype != torch.bfloat16
            or not t.is_contiguous() or t.numel() != rows * ld
            or t.data_ptr() % 16 for t in (outr, outi)):
        raise ValueError("ring_pc takes 1-3 segments and contiguous bfloat16 "
                         f"planes of {rows} x {ld} (a multiple of 8)")
    vals = []
    for xr, xi, strip, lh, j_len, g0 in segments:
        nr._check_samples(xr, xi, rows, dev)
        nr.check_strip(strip, dev)
        ntiles = -(-j_len // RING_TILE)
        per_run = -(-ntiles // -(-ntiles // RING_RUN))
        vals += [xr.data_ptr(), xi.data_ptr(), xr.shape[1], xr.stride(0),
                 strip.data_ptr(), strip.shape[2], lh, j_len, g0, per_run]
    _build.check(lib, lib.rs_ring_pc(
        len(segments), (ctypes.c_longlong * len(vals))(*vals), rows, ld,
        outr.data_ptr(), outi.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rs_ring_pc")


def in_turns(calls: dict, reps: int) -> dict:
    """Busy-card and idle-card events and host ms a call of each of
    ``calls`` in turns (forwards, then backwards), medians."""
    import torch

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    t = {k: {"busy": [], "idle": [], "host": []} for k in calls}
    for _ in range(reps):
        for k in list(calls) + list(calls)[::-1]:
            for mode in ("idle", "busy"):
                dev_ms, host_ms = _events(calls[k], mode == "busy")
                t[k][mode].append(dev_ms)
                if mode == "busy":
                    t[k]["host"].append(host_ms)
    return {k: {"busy_ms": statistics.median(v["busy"]),
                "idle_ms": statistics.median(v["idle"]),
                "host_ms": statistics.median(v["host"])}
            for k, v in t.items()}


def k3(libs, reps: int) -> dict:
    """The old K3, the new K3 and the new without the beam walk, on
    exponential magnitudes with strong cells."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import full_config
    from radar_tpu_torch.ops import cfar_kernel as ck

    params = full_config().cfar
    g = torch.Generator(device="cuda").manual_seed(3)
    mag = torch.empty((13, 332, 3404), device="cuda").exponential_(
        generator=g)
    mag.view(-1)[torch.randint(0, mag.numel(), (200,), generator=g,
                               device="cuda")] += 60.0
    num_b, num_v, num_g = mag.shape
    window = ck._window_args(params, num_b)[:8]

    def old():
        mask = torch.empty((num_b - 1, num_v, num_g), dtype=torch.bool,
                           device="cuda")
        thr = torch.empty((num_b - 1, num_v, num_g), device="cuda")
        lib = libs["k3_old"]
        _build.check(lib, lib.k3_cfar_old(
            mag.data_ptr(), num_b, num_v, num_g, *window, mask.data_ptr(),
            thr.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "k3_cfar_old")
        return mask.permute(1, 2, 0), thr.permute(1, 2, 0)

    shipped = _build.load("cfar")

    def no_walk():
        _build._libs["cfar"] = libs["k3_no_walk"]
        try:
            return ck.goca_cfar_2d_fused(mag, params)
        finally:
            _build._libs["cfar"] = shipped

    calls = {"old": old, "new": lambda: ck.goca_cfar_2d_fused(mag, params),
             "no_walk": no_walk}
    want = ck.goca_cfar_2d_fused_plain(mag, params)
    identical = {}
    for k, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        identical[k] = bool(torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1]))
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["identical_to_plain"] = identical[k]
        out[k]["profile_ms"] = _profile(fn, reps=10)
    out["hits"] = int(want[0].sum())
    return out


def k10(libs, reps: int):
    """K10 at bf16 with its strip-GEMM PC and with the resident ring;
    returns (the results, the plan, K1c's planes)."""
    import torch

    from radar_tpu_torch.config.params import perf_config
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.waveform.precompute import precompute

    bf = torch.bfloat16
    lr = make_lowrank_stages(perf_config(), precompute(perf_config()),
                             device="cuda")
    plan, lmat = lr.rplan, lr.l_factor
    num_b = lmat.shape[0]
    planes = nr.gen_noise_planes(plan, nr.seed_words(4242), num_b,
                                 device="cuda")
    z = torch.zeros((num_b, plan.n_pulses, plan.s_compact),
                    dtype=torch.complex64, device="cuda")
    for seg, (xr, xi) in zip(plan.segments, planes):
        sl = slice(seg.pad_front, seg.pad_front + seg.r_len)
        z[:, :, seg.c0:seg.c0 + seg.r_len] = torch.complex(xr[..., sl],
                                                           xi[..., sl])
    strip = nr.strip_pc
    taps = {(seg.j_len, seg.g0): seg.taps.shape[0] for seg in plan.segments}

    def through_ring(segs, rows, ld, *, outr, outi):
        ring_pc(libs["ring_shipped"], [(xr, xi, st, taps[(j, g0)], j, g0)
                                       for xr, xi, st, j, g0 in segs],
                rows, ld, outr, outi)

    def ring():
        nr.strip_pc = through_ring
        try:
            return nr.noise_rdm_compact(z, plan, lmat, variant="resident",
                                        mul_dtype=bf)
        finally:
            nr.strip_pc = strip

    calls = {"ring": ring, "strip": lambda: nr.noise_rdm_compact(
        z, plan, lmat, variant="resident", mul_dtype=bf)}
    ref = nr.noise_rdm_plain(plan, lmat, nr.planes_from_compact(z, plan, bf),
                             mul_dtype=bf).permute(1, 2, 0)
    rms = float(ref.abs().pow(2).mean().sqrt())
    err = {k: float((fn() - ref).abs().pow(2).mean().sqrt()) / rms
           for k, fn in calls.items()}
    del ref
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["rms_err_over_rms"] = err[k]
        out[k]["profile_ms"] = _profile(fn)
    return out, plan, planes


def dft(libs, plan, planes, reps: int) -> dict:
    """The bf16 DFT: the port's wgmma GEMM against the first, mma.sync GEMM on
    the pc planes of K10's ring PC."""
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    num_b, num_p = planes[0][0].shape[:2]
    num_v, num_g = plan.n_dop, plan.n_gates
    ld = -(-num_g // 8) * 8
    pcr = torch.empty((num_b, num_p, ld), dtype=bf, device="cuda")
    pci = torch.empty_like(pcr)
    segs = [(nr._rows16(xr.to(bf)), nr._rows16(xi.to(bf)), seg.strip,
             seg.taps.shape[0], seg.j_len, seg.g0)
            for seg, (xr, xi) in zip(plan.segments, planes)]
    ring_pc(libs["ring_shipped"], segs, num_b * num_p, ld, pcr, pci)
    # the old kernel reads [B, P, G] planes and D as f32 planes
    pr_g = pcr[..., :num_g].contiguous()
    pi_g = pci[..., :num_g].contiguous()
    d16 = nr.round_mul(plan.d, bf)
    dr, di = d16.real.contiguous(), d16.imag.contiguous()
    mt = [torch.empty((num_b, num_v, num_g), dtype=bf, device="cuda")
          for _ in range(4)]
    lib = libs["dft_old"]
    calls = {
        "wgmma": lambda: nr.dft(plan, pcr, pci, num_g, mt[0], mt[1]),
        "mma_sync": lambda: _build.check(lib, lib.rv_mtd_tc(
            dr.data_ptr(), di.data_ptr(), pr_g.data_ptr(), pi_g.data_ptr(),
            num_b, num_v, num_p, num_g, mt[2].data_ptr(), mt[3].data_ptr(),
            torch.cuda.current_stream().cuda_stream), "rv_mtd_tc")}
    for fn in calls.values():
        fn()
    pc = torch.complex(pr_g.float(), pi_g.float())
    want = nr.round_mul(torch.matmul(nr.round_mul(plan.d, bf), pc), bf)
    rms = float(want.abs().pow(2).mean().sqrt())
    err = {k: float((torch.complex(a.float(), b.float()) - want).abs()
                    .pow(2).mean().sqrt()) / rms
           for k, (a, b) in (("wgmma", mt[:2]), ("mma_sync", mt[2:]))}
    out = in_turns(calls, reps)
    for k, fn in calls.items():
        out[k]["rms_err_over_rms"] = err[k]
        out[k]["profile_ms"] = _profile(fn, reps=10)
    return out


def ring(libs, plan, planes, reps: int) -> dict:
    """The ring PC alone, as K10 ran it and with parts taken out, per segment
    and all three at once (busy-card events, medians), and the stamped
    copy's phases of a pair of tiles on the 700-tap segment."""
    import numpy as np
    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.ops import noise_rdm as nr

    bf = torch.bfloat16
    num_b, num_p = planes[0][0].shape[:2]
    rows, ld = num_b * num_p, -(-plan.n_gates // 8) * 8
    pcr = torch.empty((rows, ld), dtype=bf, device="cuda")
    pci = torch.empty_like(pcr)
    segs = [(nr._rows16(xr.to(bf)), nr._rows16(xi.to(bf)), seg.strip,
             seg.taps.shape[0], seg.j_len, seg.g0)
            for seg, (xr, xi) in zip(plan.segments, planes)]
    out = {}
    for name in ["shipped", *RING_VARIANTS]:
        lib = libs[f"ring_{name}"]
        calls = {f"seg{i}": (lambda i=i: ring_pc(lib, [segs[i]], rows, ld,
                                                 pcr, pci))
                 for i in range(len(segs))}
        calls["all"] = lambda: ring_pc(lib, segs, rows, ld, pcr, pci)
        out[name] = {k: v["busy_ms"] for k, v in
                     in_turns(calls, max(2, reps // 2)).items()}
    lib = libs["ring_stamps"]
    ring_pc(lib, [segs[-1]], rows, ld, pcr, pci)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 4096)()
    _build.check(lib, lib.rs_stamps(ctypes.addressof(buf)), "rs_stamps")
    st = np.frombuffer(buf, dtype=np.uint64).astype(np.int64)
    phases = {"mma_us": [], "peer_slot_free_us": [], "peer_half_us": [],
              "epilogue_us": [], "to_next_pair_us": []}
    for base in (0, 2048):
        for wg in range(2):
            p = st[base + wg * 1024: base + wg * 1024 + 1016].reshape(-1, 8)
            p = p[(p[:, :5] > 0).all(1)][:, :5] / 1e3
            phases["mma_us"] += list(p[:, 1] - p[:, 0])
            phases["peer_slot_free_us"] += list(p[:, 2] - p[:, 1])
            phases["peer_half_us"] += list(p[:, 3] - p[:, 2])
            phases["epilogue_us"] += list(p[:, 4] - p[:, 3])
            phases["to_next_pair_us"] += list(p[1:, 0] - p[:-1, 4])
    out["pair_phases_700_tap"] = {k: float(np.median(v)) if v else None
                                  for k, v in phases.items()}
    return out


def main() -> int:
    import torch

    from radar_tpu_torch import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k3_k10: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["cfar", "rdm_sm90", "rdm_variants", "band_pc_sm90",
                      "noise_rdm"])
    libs = build(os.path.join(os.path.dirname(_build.BUILD_DIR),
                              "ablate_k3_k10"))
    res = {"card": card, "k3": k3(libs, args.reps)}
    res["k10"], plan, planes = k10(libs, args.reps)
    res["dft"] = dft(libs, plan, planes, args.reps)
    res["ring"] = ring(libs, plan, planes, args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
