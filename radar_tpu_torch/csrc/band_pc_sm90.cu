// K8's banded bf16 pulse compression redesigned for NVIDIA Hopper (sm_90a),
// shared with the bf16 PC of K10, K7 (planes and draw mode) and K9, and
// K8's staging at f32.
//
// Replaces:
//   K8: radar_tpu/studies/pallas_pc.py::pulse_compress_noise_pallas, body
//       _make_seg_kernel (pallas_call :150): the banded PC of a compact
//       white cube, complex64 out (at f32 this file stages the cube and K1's
//       3xTF32 strip GEMM in noise_rdm_sm90.cu, k8_pc_kernel, multiplies);
//   the bf16 PC stage of K7 (radar_tpu/ops/pallas_rdm.py::_call_stacked,
//       :627, and the stacked=True products of the rolling draw kernel
//       _make_kernel_gen_rolling, pallas_call :980) and K9 (_call_allbeams,
//       :1088): rounded bf16 planes out.
//
// The function. Per segment, the causal convolution of the padded segment
// buffer x (pad_front zeros of history, the samples, zeros) is the banded
// product with M[k, n] = h[n + lh - 1 - k], which is Toeplitz: M[k+d, n+d] =
// M[k, n]. So a block of BN consecutive gates j0 .. j0+BN-1 of any row needs
// only that row's samples j0 .. j0+BN+lh-2 and one strip S = M[:BN+lh-1,
// :BN], the same for every block, row and segment position:
//   Y[r, j0 + n] = sum_k X[r, j0 + k] S[k, n].
// The TPU's [W, T] windows per 512-gate tile existed to size its DMAs; here
// the (beam, pulse) rows of a segment form one M dimension (13 x 332 = 4316
// rows at full width, 4352 in 128-row blocks) and the strip, rounded to bf16
// once per plan, is read by every block from L2.
//
// stage_kernel (K8 only): compact complex64 z [B, P, s_compact] -> the
//   planes [2, B*P, ld], every segment's buffer side by side (zero history,
//   samples, zeros to a multiple of 8 columns): bf16, each sample rounded
//   once to nearest even as round_mul does, or f32 for K8's 3xTF32 GEMM
//   (the same layout: 8-column widths keep f32 rows 16-byte aligned too).
//   Bound by bytes.
// strip_pc_kernel: the strip GEMM. A block owns 128 rows x 128 gates of one
//   segment. A producer warp keeps kStages stages in flight with TMA (the Xr
//   and Xi boxes [128 rows, 64 samples] at column j0 + k0, the strip's Sr
//   and Si boxes [128 gates, 64 k] at (k0, 0), all with 128-byte swizzle),
//   completion on mbarriers. Two consumer warpgroups (64 rows each) run
//   wgmma m64n128k16 on bf16 operands from shared memory into f32
//   accumulators: Yr = Xr Sr + Xi (-Si) (the negation is wgmma's
//   imm-scale-b, exact), Yi = Xr Si + Xi Sr: 128 accumulator registers a
//   thread, in a 288-thread block (224 registers a thread; no setmaxnreg is
//   needed). One stage's MMAs stay in flight while the next stage's issue.
//   The k loop covers the band only, k < 128 + lh - 1, rounded up to 64
//   (the strip is zero beyond). TMA fills boxes beyond a segment's columns
//   or the last row with zeros. Epilogue: complex64 [B, P, num_g] at the
//   segment's gate offset (K8) or bf16-rounded planes (K7, K9), staged
//   through shared memory so that each warp writes whole runs of a row
//   (writing the fragments straight from registers, 8 rows of 64 bytes a
//   warp instruction, took a third of the kernel's time). One launch covers
//   up to three segments through a per-block segment table, the longest k
//   loop first (a persistent block per SM walking the tiles in turn measured
//   slower: its static order balanced the SMs worse than the hardware's
//   block scheduler). Tensor maps are encoded on every call (cheap; reached
//   through cudaGetDriverEntryPoint, so no -lcuda); the shared-memory
//   attribute is set once per device.
// What bounds them at full width: the GEMM by operations (the band walked
// in 128 x 128 blocks is 86 GFLOP, 0.087 ms at 989 TFLOP/s bf16; the
// convolution's own MACs are 65 GFLOP); K8 as a whole by bytes (z read and
// Y written, 0.27 GB, 0.08 ms at 3.35 TB/s).
//
// Draw mode (strip_pc_kernel<true>: K7's PC in noise_rdm(seed=,
// stacked=True, mul_dtype=bf16), whose noise is not in memory): the
// producer warp gives way to two drawing producer warpgroups (setmaxnreg:
// 88 registers for them, 168 for the consumers) that make each stage's Xr
// and Xi boxes themselves, Philox draws keyed as K1c's, rounded to bf16, in
// the 128-byte swizzle TMA writes, then fence.proxy.async and an arrive on
// the stage's full barrier (257 arrivals: 256 draws and thread 0's
// expect_tx of the strip's two TMA boxes); K4's producer pattern
// (noise_rdm_sm90.cu). The consumers are the planes mode's, so draw mode
// equals planes mode on K1c's planes bit for bit. One launch covers the
// three segments. What holds it: its draws, not its MMAs. Each sample is
// drawn once for every 128-gate block whose window holds it (83.4 M draws
// at full width for 18.6 M samples), 66 instructions each in the SASS of
// the producers' loop (chip_smoke.py reads it): 0.165 ms of issue on an
// H100's 132 SMs at 1980 MHz, beside the bf16 band's 0.087 ms of MMAs. The
// function itself needs each sample drawn once (K1c's 51 instructions a
// sample: ~0.03 ms), as the TPU's rolling kernel draws it, once, into a
// circular buffer of 128-sample chunks; this kernel reuses no draw.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "philox.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;   // block tile; k depth a stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32; // + the producer warp
// draw mode: two drawing producer warpgroups, which give registers to the
// consumers (setmaxnreg: 256 x 88 + 256 x 168 = 512 x 128, the entry
// budget of 512 threads; the consumers need 154)
constexpr int kDrawers = 256;
constexpr int kDrawThreads = 128 * kConsumers + kDrawers;
constexpr int kProducerRegs = 88, kConsumerRegs = 168;
constexpr int kDrawLanes = 4;                   // Philox chains a drawing thread runs
                                                // at once: 8 samples, a chunk
constexpr int kDrawRows = kBM / (kDrawers / 8); // rows a drawing thread fills a stage
constexpr int kMaxSeg = 3;
constexpr int kTileA = kBM * kBK * 2;           // bytes of an X plane's box
constexpr int kTileB = kBN * kBK * 2;           // bytes of a strip plane's box
constexpr int kStageBytes = 2 * kTileA + 2 * kTileB;
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s

struct Seg {
  int blk0;             // first block of the segment
  int nb_n;             // 128-gate column blocks
  int k_tiles;          // 64-deep k steps of the band
  int j_len, g0;        // output gates and their offset
  int pad_front;        // draw mode: zero samples before the draws,
  int x_cols;           //   zeros from sample x_cols on,
  int seg_id;           //   the segment's index (Philox counter word 3)
};

struct StripArgs {
  CUtensorMap xr[kMaxSeg], xi[kMaxSeg];   // bf16 [rows, x_cols], row stride ld
  CUtensorMap sr[kMaxSeg], si[kMaxSeg];   // bf16 strip planes [128, k_pad]
  Seg seg[kMaxSeg];
  int n_seg, rows, num_g, round_out;
  int num_p;                              // draw mode: row = b * num_p + p
  uint2 key;                              //   Philox key
  float scale;                            //   uniform_rail's scale
  __nv_bfloat16* outr;                    // round_out: bf16 [rows, num_g]
  __nv_bfloat16* outi;
  float2* out;                            // else complex64 [rows, num_g]
};

template <typename T>
__device__ __forceinline__ const T& pick(const T (&v)[kMaxSeg], int s) {
  return s == 0 ? v[0] : (s == 1 ? v[1] : v[2]);
}

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

// Wait for the phase of parity `parity` of the barrier to complete; a wait
// longer than kTimeoutNs is a bug (a phase that never completes), so it
// traps: the launch fails with an error instead of hanging the card. (No
// printf: any call in the kernel makes ptxas serialize the wgmma pipeline.
// The trap after the loop, not in it: in the loop it made ptxas spill the
// draw-mode consumers' accumulators, 616 bytes a thread.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  for (;;) {
    if (mbar_try_wait(bar, parity)) return;
    if (now_ns() - t0 > kTimeoutNs) break;
  }
  __trap();
}

// TMA: the 2D box at (c0 = column, c1 = row) of `map` into shared `dst`,
// completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile stored as TMA writes it
// with 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (stride byte offset), start address 16-byte granular; a 16-deep k slice
// starts 32 bytes further into the rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 f32, the warpgroup's accumulator fragment) += A B with A the
// 64 x 16 bf16 tile of descriptor da, B the 16 x 128 bf16 tile of db (both
// K-major, 128-byte swizzle), B scaled by kScaleB (+1 or -1: exact).
template <int kScaleB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, %67, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kScaleB));
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

// Barrier of the consumer warpgroups only (the producer warp may have left).
__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs that own them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
  asm volatile(""
               :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               :
               : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Draw mode: drawing thread t makes its share of a stage's Xr and Xi boxes
// [128 rows][64 samples] bf16 at samples n0 .. n0 + 63: chunk ch = t % 8
// (8 consecutive samples, 16 bytes of a row) of the kDrawRows rows
// t / 8 + 32 i, the samples keyed as K1c's, two a Philox block (counter (n /
// 2, p, b, seg): words 0, 1 of the block give sample n, words 2, 3 sample n
// + 1, so a block is one bf16 pair of each plane; rails by uniform_rail,
// zeros before pad_front, from x_cols on and past the last row), rounded to
// bf16 (nearest even), stored in the 128-byte swizzle TMA writes (16-byte
// chunk c of row r at chunk c ^ (r % 8)). (b0, p0) is the beam and pulse of
// the thread's first row.
__device__ __forceinline__ void draw_stage(unsigned char* xr, int t, int m0,
                                           int b0, int p0, int n0, const Seg& sg,
                                           const StripArgs& a) {
  const int ch = t & 7;
  int b = b0, p = p0;
#pragma unroll 1
  for (int i = 0; i < kDrawRows; ++i) {
    const int r = (t >> 3) + (kDrawers / 8) * i;
    if (i > 0) {   // the next row of this thread: kDrawers / 8 rows on
      p += kDrawers / 8;
      while (p >= a.num_p) {
        p -= a.num_p;
        ++b;
      }
    }
    uint32_t pr[4] = {}, pi[4] = {};   // the chunk's 8 samples, bf16 pairs
    if (m0 + r < a.rows) {
#pragma unroll
      for (int h = 0; h < 4; h += kDrawLanes) {
        const int nb = n0 + 8 * ch + 2 * h;   // the first sample of these lanes
        unsigned m[kDrawLanes];
        uint4 w[kDrawLanes];
#pragma unroll
        for (int e = 0; e < kDrawLanes; ++e) m[e] = (unsigned)(nb / 2 + e);
        philox_lanes(m, (unsigned)p, (unsigned)b, (unsigned)sg.seg_id, a.key, w);
#pragma unroll
        for (int e = 0; e < kDrawLanes; ++e) {
          const int n = nb + 2 * e;
          const bool keep0 = n >= sg.pad_front && n < sg.x_cols;
          const bool keep1 = n + 1 >= sg.pad_front && n + 1 < sg.x_cols;
          __nv_bfloat162 hr = __floats2bfloat162_rn(
              keep0 ? uniform_rail(w[e].x, a.scale) : 0.f,
              keep1 ? uniform_rail(w[e].z, a.scale) : 0.f);
          __nv_bfloat162 hi = __floats2bfloat162_rn(
              keep0 ? uniform_rail(w[e].y, a.scale) : 0.f,
              keep1 ? uniform_rail(w[e].w, a.scale) : 0.f);
          pr[h + e] = *reinterpret_cast<uint32_t*>(&hr);
          pi[h + e] = *reinterpret_cast<uint32_t*>(&hi);
        }
      }
    }
    const uint32_t o = r * 128 + (((ch ^ r) & 7) << 4);
    *reinterpret_cast<uint4*>(xr + o) = make_uint4(pr[0], pr[1], pr[2], pr[3]);
    *reinterpret_cast<uint4*>(xr + kTileA + o) = make_uint4(pi[0], pi[1], pi[2], pi[3]);
  }
}

template <bool kDraw>
__global__ void __launch_bounds__(kDraw ? kDrawThreads : kThreads, 1)
    strip_pc_kernel(const __grid_constant__ StripArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t bars = tiles + kStages * kStageBytes;   // full, then empty
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kStages + st); };

  int s = 0;
  while (s + 1 < a.n_seg && (int)blockIdx.x >= pick(a.seg, s + 1).blk0) ++s;
  const Seg sg = pick(a.seg, s);
  const int local = blockIdx.x - sg.blk0;
  const int m0 = (local / sg.nb_n) * kBM;
  const int j0 = (local % sg.nb_n) * kBN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kDraw ? kDrawers + 1 : 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // the producers: in planes mode one lane of a warp issues every load;
    // in draw mode two warpgroups draw the data's boxes (then a proxy fence
    // and an arrive each: kDrawers + 1 arrivals with thread 0's expect_tx)
    // and thread 0 loads the strip's boxes by TMA
    if constexpr (kDraw) setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x - 128 * kConsumers;
    if (!kDraw && t != 0) return;
    const CUtensorMap* mxr = &pick(a.xr, s);
    const CUtensorMap* mxi = &pick(a.xi, s);
    const CUtensorMap* msr = &pick(a.sr, s);
    const CUtensorMap* msi = &pick(a.si, s);
    int b0 = 0, p0 = 0;   // the beam and pulse of this thread's first row
    if (kDraw) {
      const int row = m0 + (t >> 3);
      b0 = row / a.num_p;
      p0 = row - b0 * a.num_p;
    }
    for (int kt = 0; kt < sg.k_tiles; ++kt) {
      const int st = kt % kStages;
      if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) - 1) & 1);
      const uint32_t base = tiles + st * kStageBytes;
      if (t == 0) {
        mbar_expect_tx(full(st), kDraw ? 2 * kTileB : kStageBytes);
        if (!kDraw) {
          tma_load(base, mxr, j0 + kt * kBK, m0, full(st));
          tma_load(base + kTileA, mxi, j0 + kt * kBK, m0, full(st));
        }
        tma_load(base + 2 * kTileA, msr, kt * kBK, 0, full(st));
        tma_load(base + 2 * kTileA + kTileB, msi, kt * kBK, 0, full(st));
      }
      if (kDraw) {
        draw_stage(smem_raw + (base - raw), t, m0, b0, p0, j0 + kt * kBK, sg, a);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows m0 + 64 wg .. m0 + 64 wg + 63
  if constexpr (kDraw) setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  float accr[64], acci[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accr[i] = acci[i] = 0.f;
  fence_acc(accr);
  fence_acc(acci);
  for (int kt = 0; kt < sg.k_tiles; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full(st), (kt / kStages) & 1);
    __syncwarp();   // the wgmma instructions below are .sync.aligned
    const uint32_t xr_t = tiles + st * kStageBytes + wg * (kTileA / kConsumers);
    const uint32_t xi_t = xr_t + kTileA;
    const uint32_t sr_t = tiles + st * kStageBytes + 2 * kTileA;
    const uint32_t si_t = sr_t + kTileB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dxr = sw128_desc(xr_t + 32 * kk), dxi = sw128_desc(xi_t + 32 * kk);
      const uint64_t dsr = sw128_desc(sr_t + 32 * kk), dsi = sw128_desc(si_t + 32 * kk);
      wgmma_m64n128k16<1>(accr, dxr, dsr);
      wgmma_m64n128k16<-1>(accr, dxi, dsi);
      wgmma_m64n128k16<1>(acci, dxr, dsi);
      wgmma_m64n128k16<1>(acci, dxi, dsr);
    }
    wgmma_commit();
    // one stage's MMAs stay in flight: those of stage kt - 1 are done, so
    // its buffers go back to the producer
    wgmma_wait<1>();
    fence_acc(accr);
    fence_acc(acci);
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty((kt + kStages - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(accr);
  fence_acc(acci);

  // Epilogue through shared memory (the stage buffers are free once both
  // warpgroups' MMAs are done): the accumulator fragments go to a float2
  // tile [128 rows][128 gates], rows padded by 64 bytes (no bank conflicts
  // for the fragments' 16-byte writes), then every warp writes 32
  // consecutive gates of a row at a time, so each store instruction covers
  // 256 contiguous bytes (K8) or 64 bytes of each bf16 plane (K7, K9).
  // Register 4c + 2h + e of lane l in warp w of the m64nNk16 fragment holds
  // row 16 w + l/4 + 8 h, column 8 c + 2 (l % 4) + e.
  constexpr int kTileRowBytes = 2 * kBN * 4 + 64;   // a tile row, bytes
  named_sync_consumers();
  unsigned char* out_t = smem_raw + (tiles - raw);
  {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(out_t + (r0 + 8 * h) * kTileRowBytes +
                                   (8 * c + 2 * (lane & 3)) * 8) =
            make_float4(accr[4 * c + 2 * h], acci[4 * c + 2 * h],
                        accr[4 * c + 2 * h + 1], acci[4 * c + 2 * h + 1]);
  }
  named_sync_consumers();
  const int n = threadIdx.x & (kBN - 1);   // this thread's gate
  const int j = j0 + n;
  if (j >= sg.j_len) return;
  for (int r = threadIdx.x / kBN; r < kBM; r += 128 * kConsumers / kBN) {
    const int row = m0 + r;
    if (row >= a.rows) break;
    const float2 v = *reinterpret_cast<const float2*>(out_t + r * kTileRowBytes + n * 8);
    const long long off = (long long)row * a.num_g + sg.g0 + j;
    if (a.round_out) {
      a.outr[off] = __float2bfloat16_rn(v.x);
      a.outi[off] = __float2bfloat16_rn(v.y);
    } else {
      a.out[off] = v;
    }
  }
}

// ---------------------------------------------------------------- staging

struct StageSeg {
  int c0, r_len, pad_front;   // compact slice and its zero history
  int off, width;             // columns of the segment's buffer in X
};

struct StageArgs {
  StageSeg seg[kMaxSeg];
  int n_seg, rows, ld;
  long long s_c;
};

// 8 values of a plane to p (16-byte aligned): one 16-byte store of bf16
// (each rounded once, nearest even), two of f32.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One thread per 8 consecutive columns of a row: 8 complex samples (or
// zeros) -> 16 or 32 bytes of each plane.
template <typename T>
__global__ void __launch_bounds__(256)
    stage_kernel(const float2* __restrict__ z, const __grid_constant__ StageArgs a,
                 T* __restrict__ xr, T* __restrict__ xi) {
  const int groups = a.ld >> 3;
  const int total = a.rows * groups;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int r = i / groups;
    const int c = (i - r * groups) << 3;
    int s = 0;
    while (s + 1 < a.n_seg && c >= pick(a.seg, s + 1).off) ++s;
    const StageSeg sg = pick(a.seg, s);
    const float2* zr = z + (long long)r * a.s_c + sg.c0;
    const int n0 = c - sg.off - sg.pad_front;
    float vr[8], vi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + e;
      const float2 v = (n >= 0 && n < sg.r_len) ? zr[n] : make_float2(0.f, 0.f);
      vr[e] = v.x;
      vi[e] = v.y;
    }
    const long long o = (long long)r * a.ld + c;
    store8(xr + o, vr);
    store8(xi + o, vi);
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

// The strip GEMM's launch on `blocks` blocks, the shared-memory attribute
// set once a device and instantiation.
template <bool kDraw>
int launch_strip(const StripArgs& a, long long blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(strip_pc_kernel<kDraw>, (int)kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  strip_pc_kernel<kDraw><<<(unsigned)blocks, kDraw ? kDrawThreads : kThreads, kSmem,
                           stream>>>(a);
  return (int)cudaGetLastError();
}

// A bf16 matrix [rows, cols] with row stride ld elements, read in boxes of
// 64 columns x 128 rows with 128-byte swizzle; out-of-bounds reads are 0.
bool make_map(CUtensorMap* map, long long ptr, long long cols, long long rows,
              long long ld) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ptr % 16 != 0 || ld % 8 != 0 || cols < 1 || rows < 1)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            reinterpret_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K8's staging kernel on planes xr, xi of T (tab as sp_stage's).
template <typename T>
int launch_stage(const void* z, long long s_c, int rows, int n_seg,
                 const int* tab, int ld, T* xr, T* xi, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 || ld < 8 || ld % 8 != 0 ||
      (long long)rows * (ld / 8) > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(xr) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xi) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  StageArgs a{};
  int end = 0;
  for (int s = 0; s < n_seg; ++s) {
    const int* t = tab + 5 * s;
    a.seg[s] = StageSeg{t[0], t[1], t[2], t[3], t[4]};
    if (t[3] != end || t[3] % 8 != 0 || t[4] % 8 != 0 || t[4] < 8)
      return (int)cudaErrorInvalidValue;
    end += t[4];
  }
  if (end != ld) return (int)cudaErrorInvalidValue;
  a.n_seg = n_seg;
  a.rows = rows;
  a.ld = ld;
  a.s_c = s_c;
  const long long total = (long long)rows * (ld / 8);
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16);
  stage_kernel<T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(z), a, xr, xi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The strip GEMM over n_seg (1..3) segments in one launch. tab holds 8
// values a segment: the bf16 sample buffers xr, xi [rows, x_cols] (row
// stride x_ld, a multiple of 8; 16-byte aligned), their x_cols, x_ld, the
// strip [2, 128, k_pad] bf16 (real and imaginary planes, k contiguous;
// k_pad a multiple of 64), k_pad, the segment's gates j_len and their
// offset g0 in the output. round_out: bf16 planes outr, outi [rows, num_g];
// else complex64 out [rows, num_g].
int sp_band_pc(int n_seg, const long long* tab, int rows, int num_g,
               int round_out, void* outr, void* outi, void* out, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 ||
      (round_out ? (outr == nullptr || outi == nullptr) : out == nullptr))
    return (int)cudaErrorInvalidValue;
  int order[kMaxSeg];
  longest_first(n_seg, tab, 8, 5, order);
  StripArgs a{};
  const int nb_m = (rows + kBM - 1) / kBM;
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 8 * order[i];
    const long long k_pad = t[5], j_len = t[6];
    if (k_pad < kBK || k_pad % kBK != 0 || j_len < 1 ||
        !make_map(&a.xr[i], t[0], t[2], rows, t[3]) ||
        !make_map(&a.xi[i], t[1], t[2], rows, t[3]) ||
        !make_map(&a.sr[i], t[4], k_pad, kBN, k_pad) ||
        !make_map(&a.si[i], t[4] + 2 * kBN * k_pad, k_pad, kBN, k_pad))
      return (int)cudaErrorInvalidValue;
    const int nb_n = (int)((j_len + kBN - 1) / kBN);
    a.seg[i] = Seg{(int)blocks, nb_n, (int)(k_pad / kBK), (int)j_len, (int)t[7],
                   0, 0, 0};
    blocks += (long long)nb_m * nb_n;
  }
  a.n_seg = n_seg;
  a.rows = rows;
  a.num_g = num_g;
  a.round_out = round_out;
  a.outr = static_cast<__nv_bfloat16*>(outr);
  a.outi = static_cast<__nv_bfloat16*>(outi);
  a.out = static_cast<float2*>(out);
  return launch_strip<false>(a, blocks, static_cast<cudaStream_t>(stream));
}

// The strip GEMM in draw mode (K7's draw-mode PC at bf16) over n_seg (1..3)
// segments in one launch: the data's boxes drawn in the block (Philox keyed
// by (s0, s1), counter (n / 2, p, b, seg) for samples n, uniform_rail's
// scale, bf16) for
// rows b * num_p + p of num_b beams, the rounded bf16 planes outr, outi
// [rows, num_g] out. tab holds 7 values a segment: the strip [2, 128,
// k_pad] bf16, k_pad, the segment's gates j_len, their offset g0 in the
// output, pad_front, x_cols (the samples a row has: zeros from there on)
// and the segment's index (the Philox counter's fourth word).
int sp_band_pc_draw(int n_seg, const long long* tab, int num_b, int num_p,
                    int num_g, unsigned s0, unsigned s1, float scale,
                    void* outr, void* outi, void* stream) {
  const long long rows = (long long)num_b * num_p;
  if (n_seg < 1 || n_seg > kMaxSeg || num_b < 1 || num_p < 1 ||
      rows > 0x7fffffff || outr == nullptr || outi == nullptr)
    return (int)cudaErrorInvalidValue;
  int order[kMaxSeg];
  longest_first(n_seg, tab, 7, 1, order);
  StripArgs a{};
  const int nb_m = (int)((rows + kBM - 1) / kBM);
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 7 * order[i];
    const long long k_pad = t[1], j_len = t[2];
    if (k_pad < kBK || k_pad % kBK != 0 || j_len < 1 || t[3] < 0 ||
        t[3] + j_len > num_g || t[4] < 0 || t[5] < 1 || t[6] < 0 ||
        !make_map(&a.sr[i], t[0], k_pad, kBN, k_pad) ||
        !make_map(&a.si[i], t[0] + 2 * kBN * k_pad, k_pad, kBN, k_pad))
      return (int)cudaErrorInvalidValue;
    const int nb_n = (int)((j_len + kBN - 1) / kBN);
    a.seg[i] = Seg{(int)blocks, nb_n, (int)(k_pad / kBK), (int)j_len, (int)t[3],
                   (int)t[4], (int)t[5], (int)t[6]};
    blocks += (long long)nb_m * nb_n;
  }
  a.n_seg = n_seg;
  a.rows = (int)rows;
  a.num_g = num_g;
  a.round_out = 1;
  a.num_p = num_p;
  a.key = make_uint2(s0, s1);
  a.scale = scale;
  a.outr = static_cast<__nv_bfloat16*>(outr);
  a.outi = static_cast<__nv_bfloat16*>(outi);
  return launch_strip<true>(a, blocks, static_cast<cudaStream_t>(stream));
}

// K8's staging kernel: compact complex64 z [rows, s_c] -> the two planes
// x [2, rows, ld] (16-byte aligned, ld a multiple of 8), bf16 (each value
// rounded once) or, with f32, float32. tab holds 5 values a segment: c0,
// r_len, pad_front (the compact slice of z after pad_front zeros), off,
// width (the segment's columns in the planes; multiples of 8 covering [0,
// ld) in order). The strip GEMM (bf16) or K1's 3xTF32 strip GEMM (f32,
// k8_tf32_pc in noise_rdm_sm90.cu) then reads segment s of plane p at x +
// (p * rows * ld + off) elements.
int sp_stage(const void* z, long long s_c, int rows, int n_seg, const int* tab,
             int ld, void* x, int f32, void* stream) {
  if (f32) {
    float* xr = static_cast<float*>(x);
    return launch_stage(z, s_c, rows, n_seg, tab, ld, xr, xr + (size_t)rows * ld,
                        stream);
  }
  __nv_bfloat16* xr = static_cast<__nv_bfloat16*>(x);
  return launch_stage(z, s_c, rows, n_seg, tab, ld, xr, xr + (size_t)rows * ld,
                      stream);
}

}  // extern "C"
