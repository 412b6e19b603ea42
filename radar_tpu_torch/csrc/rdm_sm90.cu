// K10's resident-ring pulse compression and the bf16 DFT GEMM of K10 and
// K7, for NVIDIA Hopper (sm_90a): TMA + wgmma on bf16 operands, f32 sums.
//
// Replaces, for bf16 operands (rdm_variants.cu keeps the f32 schedules):
//   ring_pc_kernel: the PC stage of radar_tpu/ops/pallas_rdm.py::
//       noise_rdm_pallas_planes(variant="resident") (pallas_call :789, body
//       _make_kernel_resident :482), whose resident buffer keeps a row's
//       samples in fast memory while its gate tiles slide along;
//   dft_kernel: the MTD DFT stage of that kernel and of _call_stacked
//       (:627, K7), mt[b] = D [V, P] @ pc[b] [P, G] rounded to bf16.
// Both compute in the TPU's bf16 arithmetic (rdm_variants.cu's header):
// bf16 operands, whose products are exact in f32, sums in f32, results
// rounded to bf16 planes. (wgmma's f32 sums are not IEEE-sequential: each
// instruction rounds its sum toward zero.)
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
//
// dft_kernel. A block computes a 128 (Doppler) x 128 (gate) tile of one
// beam: a producer warp loads, per 64-deep k step, D's rounded planes (A,
// K-major boxes [128 rows][64 pulses]; the plan's `d_bf16`) and pc's rows
// as they lie in memory (B, MN-major: boxes [64 pulses][64 gates], two per
// plane), 3 stages of 64 KB; two consumer warpgroups (64 Doppler rows each)
// run wgmma m64n128k16 with B transposed. The epilogue rounds to bf16
// through shared memory, so that each warp writes whole runs of a row.
//
// What bounds them at full width (13 beams, 332 pulses, 3404 gates,
// filters of 35/200/700 taps): operations. The convolutions are 8.1e9
// complex MACs (65 GFLOP, 0.066 ms at 989 TFLOP/s bf16; the 64-gate tiles
// walk 4352 rows x the k chunks: ~86 GFLOP), the DFT 4.9e9 (39 GFLOP, 0.04
// ms); the DFT's bytes (pc read, mt written: 0.12 GB) take 0.035 ms at
// 3.35 TB/s.
//
// Gotchas (as band_pc_sm90.cu's): no printf (any call) in a wgmma kernel,
// or ptxas serializes the wgmma pipeline; every mbarrier wait is bounded
// (4 s) and traps; TMA needs 16-byte aligned bases and row strides that
// are multiples of 8 bf16 elements (and a TMA store a 16-byte aligned
// first column); index an accumulator array only at compile-time offsets,
// or ptxas moves it to local memory (a stack frame in its -v line).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s
constexpr int kMaxSeg = 3;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;

// ------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// Wait for the phase of parity `parity`; longer than kTimeoutNs is a bug,
// so it traps (no printf: it would serialize the wgmma pipeline).
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > kTimeoutNs) __trap();
}

// TMA: the 2D box at (c0 = column, c1 = row) of `map` into shared `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
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

// wgmma descriptor of a K-major tile as TMA writes it with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte
// offset); a 16-deep k slice starts 32 bytes further into the rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major tile of 64-wide MN blocks as TMA writes
// boxes [k rows][64 elements] with 128-byte swizzle: k rows 128 bytes apart,
// 8-row k groups 1024 bytes apart (stride byte offset), MN blocks
// kMnBlockBytes apart (leading byte offset); a 16-deep k slice starts 16
// rows (2048 bytes) further.
constexpr uint32_t kMnBlockBytes = 8192;
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kMnBlockBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

#define ACC64(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32) += A B, A 64 x 16 K-major and B 16 x 128 (both 128-byte
// swizzle), K-major or, with kTransB, MN-major; B scaled by kScaleB.
template <int kScaleB, int kTransB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, %67, 0, %68;\n"
      "}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(1), "n"(kScaleB), "n"(kTransB));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs that own them.
__device__ __forceinline__ void fence_acc64(float (&d)[64]) {
  asm volatile("" : ACC64(d) : : "memory");
}

template <typename T>
__device__ __forceinline__ const T& pick(const T (&v)[kMaxSeg], int s) {
  return s == 0 ? v[0] : (s == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

// 16 bytes into the peer's shared memory, completion counted in bytes on
// the peer's barrier.
__device__ __forceinline__ void st_async4(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
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

// ------------------------------------------------------------ the DFT

constexpr int kDM = 128, kDN = 128, kDK = 64;   // block tile; k depth a stage
constexpr int kDStages = 3;
constexpr int kDConsumers = 2;                  // warpgroups of 64 rows
constexpr int kDThreads = 128 * kDConsumers + 32;
constexpr int kDTileA = kDM * kDK * 2;          // bytes of a D plane's box
constexpr int kDTileB = kDK * kDN * 2;          // bytes of a pc plane's two boxes
constexpr int kDStageBytes = 2 * kDTileA + 2 * kDTileB;
constexpr size_t kDSmem = (size_t)kDStages * kDStageBytes + 1024 + 2 * kDStages * 8;

struct DftArgs {
  CUtensorMap dr, di;         // bf16 [V, P] (row stride p_ld), boxes [128][64]
  CUtensorMap pr, pi;         // bf16 [B][P][G] (row stride ld), boxes [64][64]
  int num_v, num_g, k_tiles;
  __nv_bfloat16* mtr;         // bf16 [B, V, G]
  __nv_bfloat16* mti;
};

__global__ void __launch_bounds__(kDThreads, 1)
    dft_kernel(const __grid_constant__ DftArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t bars = tiles + kDStages * kDStageBytes;   // full, then empty
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kDStages + st); };
  const int b = blockIdx.z;
  const int v0 = blockIdx.y * kDM;
  const int g0 = blockIdx.x * kDN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kDStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kDConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kDConsumers) {
    if (threadIdx.x == 128 * kDConsumers) {
      for (int kt = 0; kt < a.k_tiles; ++kt) {
        const int st = kt % kDStages;
        if (kt >= kDStages) mbar_wait(empty(st), ((kt / kDStages) - 1) & 1);
        const uint32_t base = tiles + st * kDStageBytes;
        mbar_expect_tx(full(st), kDStageBytes);
        tma_load(base, &a.dr, kt * kDK, v0, full(st));
        tma_load(base + kDTileA, &a.di, kt * kDK, v0, full(st));
        const uint32_t pb = base + 2 * kDTileA;
        for (int h = 0; h < 2; ++h) {
          tma_load3(pb + h * kMnBlockBytes, &a.pr, g0 + 64 * h, kt * kDK, b,
                    full(st));
          tma_load3(pb + kDTileB + h * kMnBlockBytes, &a.pi, g0 + 64 * h,
                    kt * kDK, b, full(st));
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  float accr[64], acci[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accr[i] = acci[i] = 0.f;
  fence_acc64(accr);
  fence_acc64(acci);
  for (int kt = 0; kt < a.k_tiles; ++kt) {
    const int st = kt % kDStages;
    mbar_wait(full(st), (kt / kDStages) & 1);
    __syncwarp();
    const uint32_t dr_t = tiles + st * kDStageBytes + wg * (kDTileA / kDConsumers);
    const uint32_t di_t = dr_t + kDTileA;
    const uint32_t pr_t = tiles + st * kDStageBytes + 2 * kDTileA;
    const uint32_t pi_t = pr_t + kDTileB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDK / 16; ++kk) {
      const uint64_t ar = desc_k(dr_t + 32 * kk), ai = desc_k(di_t + 32 * kk);
      const uint64_t br = desc_mn(pr_t + 2048 * kk), bi = desc_mn(pi_t + 2048 * kk);
      wgmma_n128<1, 1>(accr, ar, br);
      wgmma_n128<-1, 1>(accr, ai, bi);
      wgmma_n128<1, 1>(acci, ar, bi);
      wgmma_n128<1, 1>(acci, ai, br);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc64(accr);
    fence_acc64(acci);
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty((kt + kDStages - 1) % kDStages));
  }
  wgmma_wait<0>();
  fence_acc64(accr);
  fence_acc64(acci);

  // Epilogue through shared memory (the stages are free once both
  // warpgroups' MMAs are done and every load has landed): the rounded
  // planes as a bf16 tile [2][128 rows][128 gates], rows padded by 16 bytes
  // (the fragments' 4-byte writes hit 32 banks), then 64 threads a row, 2
  // gates each, write 256 contiguous bytes of each plane.
  constexpr int kLdo = 2 * kDN + 16;         // tile row stride, bytes
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kDConsumers) : "memory");
  unsigned char* out_t = smem_raw + (tiles - raw);
  {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int c = 0; c < kDN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (r0 + 8 * h) * kLdo + (8 * c + 2 * (lane & 3)) * 2;
        *reinterpret_cast<uint32_t*>(out_t + off) =
            pack_bf16(accr[4 * c + 2 * h], accr[4 * c + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(out_t + kDM * kLdo + off) =
            pack_bf16(acci[4 * c + 2 * h], acci[4 * c + 2 * h + 1]);
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kDConsumers) : "memory");
  const int n = 2 * (threadIdx.x & 63);      // this thread's gates n, n + 1
  const int g = g0 + n;
  if (g >= a.num_g) return;
  const bool pair = g + 1 < a.num_g && (a.num_g & 1) == 0;
  for (int r = threadIdx.x >> 6; r < kDM; r += 128 * kDConsumers / 64) {
    const int v = v0 + r;
    if (v >= a.num_v) break;
    const long long o = ((long long)b * a.num_v + v) * a.num_g + g;
    const uint32_t wr = *reinterpret_cast<const uint32_t*>(out_t + r * kLdo + 2 * n);
    const uint32_t wi =
        *reinterpret_cast<const uint32_t*>(out_t + (kDM + r) * kLdo + 2 * n);
    if (pair) {
      *reinterpret_cast<uint32_t*>(a.mtr + o) = wr;
      *reinterpret_cast<uint32_t*>(a.mti + o) = wi;
    } else {
      const __nv_bfloat16* hr = reinterpret_cast<const __nv_bfloat16*>(&wr);
      const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(&wi);
      a.mtr[o] = hr[0];
      a.mti[o] = hi[0];
      if (g + 1 < a.num_g) {
        a.mtr[o + 1] = hr[1];
        a.mti[o + 1] = hi[1];
      }
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

// Encoded maps by (pointer, shape, strides, box), the kMapCache latest: a
// ring PC call needs up to 12 maps and a DFT call 4, and the plan's
// constants and the caching allocator's buffers come back at the same
// addresses call after call. A map holds only the address, shape and box,
// so a hit is the map encoding would give.
constexpr int kMapCache = 64;
struct MapEntry {
  long long key[7];
  CUtensorMap map;
};
MapEntry g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mutex;   // ctypes calls run without the GIL

// A bf16 tensor [planes][rows][cols] (row stride ld elements, plane stride
// plane_ld), read in boxes {64 columns, box_rows rows, 1 plane} with
// 128-byte swizzle; out-of-bounds reads are 0. planes == 1: a 2D map.
bool make_map(CUtensorMap* map, long long ptr, long long cols, long long rows,
              long long ld, int box_rows, long long planes = 1,
              long long plane_ld = 0) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ptr % 16 != 0 || ld % 8 != 0 || plane_ld % 8 != 0 ||
      cols < 1 || rows < 1 || planes < 1)
    return false;
  const long long key[7] = {ptr, cols, rows, ld, box_rows, planes, plane_ld};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i)
    if (memcmp(g_maps[i].key, key, sizeof key) == 0) {
      *map = g_maps[i].map;
      return true;
    }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)plane_ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, planes > 1 ? 3 : 2,
         reinterpret_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(g_maps[g_map_next].key, key, sizeof key);
  g_maps[g_map_next].map = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  return true;
}

// The dynamic shared-memory attribute of `kernel`, set once a device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
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

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K10's ring PC over n_seg (1..3) segments in one launch (clusters of two
// CTAs, one a plane). tab holds 10
// values a segment: the bf16 sample buffers xr, xi [rows, x_cols] (row
// stride x_ld, a multiple of 8; 16-byte aligned), x_cols, x_ld, the strip
// [2, 128, k_pad] bf16 (k contiguous; k_pad a multiple of 64), k_pad, the
// filter's taps lh, the segment's gates j_len, their offset g0 in the
// output, and the 64-gate tiles a block walks. Writes the rounded bf16
// planes outr, outi [rows, ld] at gates g0 .. g0 + j_len - 1.
int rs_ring_pc(int n_seg, const long long* tab, int rows, int ld, void* outr,
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

// mt [B, V, G] = D [V, P] @ pc[b] [P, G], rounded to bf16 planes mtr, mti
// (contiguous). d: D's bf16 planes [2, V, p_ld] (p_ld a multiple of 8);
// pcr, pci: bf16 [B, P, ld] (ld a multiple of 8), 16-byte aligned.
int rs_dft(const void* d, int num_v, int num_p, int p_ld, const void* pcr,
           const void* pci, int num_b, int num_g, int ld, void* mtr, void* mti,
           void* stream) {
  if (num_v < 1 || num_p < 1 || num_b < 1 || num_g < 1 || mtr == nullptr ||
      mti == nullptr || (num_g % 2 == 0 &&
                         (reinterpret_cast<uintptr_t>(mtr) % 4 != 0 ||
                          reinterpret_cast<uintptr_t>(mti) % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  DftArgs a{};
  const long long dp = reinterpret_cast<long long>(d);
  if (!make_map(&a.dr, dp, num_p, num_v, p_ld, kDM) ||
      !make_map(&a.di, dp + 2LL * num_v * p_ld, num_p, num_v, p_ld, kDM) ||
      !make_map(&a.pr, reinterpret_cast<long long>(pcr), num_g, num_p, ld, kDK,
                num_b, (long long)num_p * ld) ||
      !make_map(&a.pi, reinterpret_cast<long long>(pci), num_g, num_p, ld, kDK,
                num_b, (long long)num_p * ld))
    return (int)cudaErrorInvalidValue;
  a.num_v = num_v;
  a.num_g = num_g;
  a.k_tiles = (num_p + kDK - 1) / kDK;
  a.mtr = static_cast<__nv_bfloat16*>(mtr);
  a.mti = static_cast<__nv_bfloat16*>(mti);
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(dft_kernel, (int)kDSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_g + kDN - 1) / kDN, (num_v + kDM - 1) / kDM, num_b);
  dft_kernel<<<grid, kDThreads, kDSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
