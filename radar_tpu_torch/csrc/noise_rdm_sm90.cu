// K1 and K4, and the f32 schedules K10, K7 and K9: the fused noise
// range-Doppler map redesigned for NVIDIA Hopper (sm_90a): pulse
// compression and slow-time DFT as 3xTF32 GEMMs on the tensor cores.
//
// K1 replaces the TPU kernels radar_tpu/ops/pallas_rdm.py::
// noise_rdm_pallas_gen (rolling=True, signal=...; pallas_call :980) and its
// planes-input sibling noise_rdm_pallas_planes (:789), as noise_rdm.cu's
// CUDA-core K1 did before. K4 (k4_pc_kernel, below) replaces the same
// function with rolling=False (body _make_kernel_gen :269), whose TPU
// kernel draws each window itself and keeps no noise cube in HBM: K1's
// strip GEMM with its data stage drawn in the block (Philox, K1c's keying)
// by a producer warpgroup instead of loaded from K1c's planes, the same
// consumers, mix and DFT.
// Per PC segment the map is
//
//   rdm[b] = D @ (sum_c L[b,c] * PC_seg(x_c)) + sum_k st[k,b] * dv[k] (x) pb[k]
//
// Launch sequence, all on the caller's stream:
//   0. (draw mode) K1c's planes_kernel (noise_rdm.cu) writes the white
//      planes that draw mode draws, so draw mode is planes mode on them and
//      the two agree bit for bit;
//   1. pc_gemm_kernel<false>, <true> (the main and the correction pass, one
//      launch each for the three segments): the
//      causal convolution of each segment's planes as a Toeplitz-strip GEMM
//      (band_pc_sm90.cu's schedule: Y[r, j0 + n] = sum_k X[r, j0 + k] S[k, n]
//      with S = M[:128 + lh - 1, :128] the same strip for every 128-gate
//      block), written transposed as the un-mixed planes pcT [B, G, P4]
//      (P4: P rounded up to 4, TMA's 16-byte row stride);
//   2. mix_planes_kernel: pcT[b] <- sum_c L[b,c] pcT[c] (pcT the sum of the
//      two passes' planes), into the main pass's planes;
//   3. dft_gemm_kernel<false>, <true>: out^T[b] [G, V] = pcT[b] [G, P] @
//      D^T, i.e. one GEMM of M = B*G rows, N = V, K = P, written as the
//      [B, V, G] complex64 map; add_kernel adds the correction and the
//      rank-K signal to the main pass's. With emit_maps (cfg.kernel_maps)
//      or bf16 output (cfg.kernel_out_bf16), add_maps_kernel does instead:
//      it walks the beams of a (v, g), rounds the map to bf16 values and
//      writes the adjacent-beam sum maps |y_b| + |y_b+1| of the unrounded
//      map into K2's padded qvg buffer.
//
// The planes kernel's other schedules at f32 (ops/noise_rdm.py::
// _variant_tf32: K10 variant="resident", noise_rdm_pallas_planes's body
// _make_kernel_resident :482; K7 "stacked", _call_stacked :627, and its
// draw mode, the stacked=True products of _make_kernel_gen_rolling :980;
// K9 "allbeams", _call_allbeams :1088) compute the same map with the beam
// mix AFTER the DFT, the TPU's order for them. They take these GEMMs in
// one sequence, so they agree bit for bit, as the TPU's schedules do at
// f32: step 1 (in draw mode K4's PC at one beam a block), then join_kernel
// (pcT <- the sum of the two passes, no mix), step 3's GEMMs on the
// un-mixed pcT, and mix_after_kernel in place of add_kernel (the DFT's two
// passes added, the beams mixed by L, the rank-K signal added and, for K10
// and K7's draw mode with out_dtype=bf16, the result rounded). Their bf16
// paths run band_pc_sm90.cu, rdm_sm90.cu and rdm_variants.cu.
//
// K8 at f32 (k8_pc_kernel, k8_tf32_pc; radar_tpu/studies/pallas_pc.py::
// pulse_compress_noise_pallas, pallas_call :150, at mul_dtype=f32): the
// banded PC of a compact white cube, complex64 [B, P, G] out. After K8's
// staging kernel (band_pc_sm90.cu) has written each segment's buffer as
// f32 planes, K4's planes-mode PC (below) runs on them with the B*P rows as
// one beam, the main and the correction pass in one block, and an
// epilogue of its own: the passes added in shared memory and stored in
// runs along the gates. At full width its 8.07 G complex MACs take 0.391
// ms as 3 TF32 products (0.9635 ms as f32 FMAs on the CUDA cores); bytes:
// z read and the PC written 0.0796 ms, 0.169 with the staged planes.
//
// 3xTF32. Each f32 operand x is split into TF32 parts hi = rna(x) and
// lo = rna(x - hi) (rna: round to nearest on the top 19 bits, ties away);
// a product is hi*hi + hi*lo + lo*hi, each an exact TF32 product, so the
// dropped lo*lo and the split leave a relative error near 2^-21. The
// constant operand (the strip, D) is split once per plan
// (ops/noise_rdm.py::strip_tf32, RdmPlan.d_tf32) into four f32 planes
// re_hi, re_lo, im_hi, im_lo; the data operand (the planes, pcT) is split
// in registers as it is read. The tensor cores' f32 sums are the trouble
// spot: each wgmma rounds its sum toward zero, so the error grows with the
// wgmmas that add into an accumulator; all three products in one put the
// noise-only map 1.26e-5 RMS-relative from the f32 plain version on an
// H100 (scripts/ablate_k1.py, variant one_pass), over K1's hold of 1e-5.
// So each GEMM runs twice (4.3e-6): the main pass adds only the hi*hi
// products (2 wgmmas a k8 step into each accumulator instead of 6), the
// correction pass hi*lo + lo*hi (2^-11 of the product, so its own
// rounding does not show), each into a buffer of its own, one f32 add
// joining the two (in the mix or join_kernel for the PC, add_kernel or
// mix_after_kernel for the DFT).
//
// The GEMM (both kernels, gemm_body). A block owns 128 M-rows x 128
// N-columns. A producer warp keeps two stages in flight with TMA: the data
// operand's re and im boxes [128 rows, 32 k] (128 bytes a row, 128-byte
// swizzle) and the constant's hi planes (main pass) or all four [128 N,
// 32 k], completion on mbarriers. Two consumer warpgroups (64 rows each)
// read their A fragments from the swizzled stage into registers (wgmma's
// .tf32 takes only K-major operands from shared memory, and A from
// registers in any order), split them, and issue wgmma m64n128k8 .tf32 with
// A from registers and B (the constant, K-major) from shared memory: 4
// MMAs a k8 step in the main pass (the 4 real products of the complex
// pair), 8 in the correction pass (4 of them with the data's hi straight
// from the stage, SS), -Ai for the real part by wgmma's imm-scale-a
// (exact). More A registers than one part's 8 a step and ptxas, budgeting
// 168 registers a thread for 288 threads, serializes the wgmmas.
// Accumulators: 2 x 64 f32 a thread. The epilogue goes through shared
// memory so that each warp writes runs along M, the output's contiguous
// axis in both modes (pcT's pulses, the map's gates).
//   PC: A = X planes of a segment [B*P rows, xlen], columns from the
//       block's first gate j0 (Toeplitz), B = the segment's strip.
//   DFT: A = pcT [B*G rows, P], B = D [V rows, P] (the transposed product
//       keeps both operands K-major with no transpose of the data).
// Boxes past a matrix's edge read as zeros (TMA), so ragged rows, gates,
// pulses and Doppler bins need no masks in the main loop.
//
// What bounds it on this card: at the full perf shape (13 beams, 332
// pulses, 3404 gates, filters of 35/200/700 taps) the useful complex MACs
// are 1.3e10 (the same for the f32 schedules, which mix after the DFT):
// 0.637 ms as 3 TF32 products each at 495 TFLOP/s (1.569 ms as f32 FMAs
// at 67 TFLOP/s on the CUDA cores). The band the PC walks in
// 128 x 128 blocks is ~3 x 86 GFLOP, the padded DFT ~3 x 48 GFLOP. Bytes:
// the planes read and the map written once, 0.28 GB, 0.084 ms at 3.35
// TB/s; with the pcT and correction buffers this design also moves
// (written, mixed, read, added), ~1.7 GB, 0.52 ms. So the tensor cores
// bind. K4 has no input to read: its draws are integer work, one Philox
// block two samples a use, (128 + lh - 1)/128 uses a sample (6.5 on the
// 700-tap segment), for both passes at once, issued by the producer
// warpgroup beside the consumers' asynchronous MMAs (measured: about as
// long as the MMAs of a stage, PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "launch.cuh"
#include "philox.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;   // block tile; k of a stage
constexpr int kStages = 2;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32; // + the producer warp
constexpr int kMaxSeg = 3;
constexpr int kTileA = kBM * kBK * 4;           // bytes of a data plane's box
constexpr int kTileB = kBN * kBK * 4;           // bytes of a constant plane's box
constexpr int kStageBytes = 2 * kTileA + 4 * kTileB;
constexpr int kLdo = kBM + 4;                   // epilogue tile row (floats)
constexpr int kEpiBytes = 2 * kBN * kLdo * 4;
constexpr int kBufBytes = kStages * kStageBytes > kEpiBytes ? kStages * kStageBytes
                                                            : kEpiBytes;
constexpr size_t kSmem = (size_t)kBufBytes + 1024 + 2 * kStages * 8;
constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s
constexpr int kMaxB = 16;                       // beams the mix holds in registers

struct Seg {
  int blk0;             // first block of the segment
  int nb_n;             // 128-column N blocks
  int k_tiles;          // 32-deep k steps
  int n_len, n_off;     // valid N columns; output offset of column 0
  int b_rows;           // rows of each constant plane (a multiple of 128)
  int toeplitz;         // 1: A's k columns start at the block's n0 (PC)
};

struct GemmArgs {
  CUtensorMap a_re[kMaxSeg], a_im[kMaxSeg];   // f32 data planes [m_len, cols]
  CUtensorMap b[kMaxSeg];                     // f32 [4 * b_rows, k] constant
  Seg seg[kMaxSeg];
  int n_seg, m_len, mode;                     // 0: pc_gemm, 1: dft_gemm
  // element (m, n) lands at (m / q) * s_q + (m % q) + (n_off + n) * s_n
  int q;
  long long s_q, s_n;
  float* out_re;                              // PC: pcT planes (main pass)
  float* out_im;
  float* corr_re;                             //     and the correction's
  float* corr_im;
  float2* out;                                // DFT: the map (main pass)
  float2* corr;                               //      and the correction
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

// A phase that never completes is a bug: trap after kTimeoutNs instead of
// hanging the card (no printf: a call makes ptxas serialize the wgmmas).
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > kTimeoutNs) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile as TMA writes it with 128-byte
// swizzle: rows of 128 bytes (32 f32), 8-row groups 1024 bytes apart; a
// k8 slice of TF32 starts 32 bytes further into the rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 f32 accumulator fragment) += kScaleA A B, A the 64 x 8 TF32
// tile in registers (a[0..3]: rows g and g + 8 of the warp's 16, columns t
// and t + 4, g = lane / 4, t = lane % 4), B the 8 x 128 TF32 tile of
// descriptor db (K-major, 128-byte swizzle); kScaleA +1 or -1 (exact).
template <int kScaleA>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, %70, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kScaleA));
}

// The same with A the 64 x 8 tile of descriptor da in shared memory (K-major,
// 128-byte swizzle): its f32 values enter as TF32, their low 13 bits
// ignored.
template <int kScaleA>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, %67, 1;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(kScaleA));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The split of four data values: hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// Byte offset of element (row r, k) of a [rows, 32] f32 box stored with
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).
__device__ __forceinline__ uint32_t sw128_off(int r, int k) {
  return (uint32_t)(r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2));
}

// The constant's planes a pass loads: the hi ones (0, 2) in the main pass,
// all four in the correction pass.
__host__ __device__ constexpr int plane_step(bool corr) { return corr ? 1 : 2; }

// The constant's planes of stage kt to b0, the stage's constant part
// (rows b_row on in each plane of b_rows rows).
template <bool kCorr>
__device__ __forceinline__ void load_constant(uint32_t b0, const CUtensorMap* mb,
                                              int kt, int b_rows, int b_row,
                                              uint32_t bar) {
#pragma unroll
  for (int p = 0; p < 4; p += plane_step(kCorr))
    tma_load(b0 + p * kTileB, mb, kt * kBK, p * b_rows + b_row, bar);
}

// The MMAs of one stage (kBK deep) of a consumer warpgroup into accr,
// acci: the stage at `base` holds the data's re and im boxes [kRows][kBK]
// (are: its generic address), then the constant's planes; the warpgroup's
// 64 rows start at row0; fr, ft the thread's fragment row and column.
// kCorr: the correction pass's products, else the main pass's.
template <bool kCorr, int kRows>
__device__ __forceinline__ void mma_stage(float (&accr)[64], float (&acci)[64],
                                          uint32_t base, const unsigned char* are,
                                          int row0, int fr, int ft) {
  constexpr int kTile = kRows * kBK * 4;
  const unsigned char* aim = are + kTile;
  const uint32_t b0 = base + 2 * kTile;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    uint32_t rh[4], rl[4], ih[4], il[4];
    {   // A from registers: the data's hi or lo part
      float xr[4], xi[4];
      const int k0 = 8 * kk + ft;
      const uint32_t o[4] = {sw128_off(fr, k0), sw128_off(fr + 8, k0),
                             sw128_off(fr, k0 + 4), sw128_off(fr + 8, k0 + 4)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = *reinterpret_cast<const float*>(are + o[i]);
        xi[i] = *reinterpret_cast<const float*>(aim + o[i]);
      }
      split4(xr, rh, rl);
      split4(xi, ih, il);
    }
    const uint64_t dar = sw128_desc(base + row0 * kBK * 4 + 32 * kk);
    const uint64_t dai = sw128_desc(base + kTile + row0 * kBK * 4 + 32 * kk);
    const uint64_t brh = sw128_desc(b0 + 32 * kk);
    const uint64_t brl = sw128_desc(b0 + kTileB + 32 * kk);
    const uint64_t bih = sw128_desc(b0 + 2 * kTileB + 32 * kk);
    const uint64_t bil = sw128_desc(b0 + 3 * kTileB + 32 * kk);
    wgmma_fence();
    // Yr += Ar Br - Ai Bi; Yi += Ar Bi + Ai Br (-Ai: wgmma's imm-scale-a,
    // exact). The correction pass takes the data's hi for the constant's
    // lo straight from the stage (SS: the tensor cores drop its low 13
    // bits instead of rounding, 2^-10 of A in a term 2^-11 of the
    // product, so 2^-21), which keeps its A registers to the lo parts
    if (!kCorr) {
      wgmma_tf32<1>(accr, rh, brh);
      wgmma_tf32<-1>(accr, ih, bih);
      wgmma_tf32<1>(acci, rh, bih);
      wgmma_tf32<1>(acci, ih, brh);
    } else {
      wgmma_tf32_ss<1>(accr, dar, brl);
      wgmma_tf32_ss<-1>(accr, dai, bil);
      wgmma_tf32_ss<1>(acci, dar, bil);
      wgmma_tf32_ss<1>(acci, dai, brl);
      wgmma_tf32<1>(accr, rl, brh);
      wgmma_tf32<-1>(accr, il, bih);
      wgmma_tf32<1>(acci, rl, bih);
      wgmma_tf32<1>(acci, il, brh);
    }
    wgmma_commit();
    // the A registers are rewritten at the next step: wait for these MMAs
    // (the other warpgroup's keep the tensor cores busy meanwhile)
    wgmma_wait0();
    fence_acc(accr);
    fence_acc(acci);
  }
}

// The GEMM of both modes; kDft: the DFT's epilogue (rank-K signal,
// complex64 map), else the PC's (pcT planes). kCorr: the correction pass
// (the data times the constant's lo, the data's lo times the constant's
// hi; added to the output the main pass wrote), else the main pass (the
// hi parts' products).
template <bool kDft, bool kCorr>
__device__ __forceinline__ void gemm_body(const GemmArgs& a) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t bars = tiles + kBufBytes;   // full, then empty
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kStages + st); };

  int s = 0;
  while (s + 1 < a.n_seg && (int)blockIdx.x >= pick(a.seg, s + 1).blk0) ++s;
  const Seg sg = pick(a.seg, s);
  const int local = blockIdx.x - sg.blk0;
  const int m0 = (local / sg.nb_n) * kBM;
  const int n0 = (local % sg.nb_n) * kBN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // the producer warp: one lane issues every load
    if (threadIdx.x == 128 * kConsumers) {
      const CUtensorMap* mar = &pick(a.a_re, s);
      const CUtensorMap* mai = &pick(a.a_im, s);
      const CUtensorMap* mb = &pick(a.b, s);
      const int a_col = sg.toeplitz ? n0 : 0;
      const int b_row = sg.toeplitz ? 0 : n0;
      for (int kt = 0; kt < sg.k_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) - 1) & 1);
        const uint32_t base = tiles + st * kStageBytes;
        mbar_expect_tx(full(st), 2 * kTileA + (4 / plane_step(kCorr)) * kTileB);
        tma_load(base, mar, a_col + kt * kBK, m0, full(st));
        tma_load(base + kTileA, mai, a_col + kt * kBK, m0, full(st));
        load_constant<kCorr>(base + 2 * kTileA, mb, kt, sg.b_rows, b_row,
                             full(st));
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int fr = 64 * wg + 16 * warp + (lane >> 2);   // fragment row (and + 8)
  const int ft = lane & 3;                            // fragment column (and + 4)
  float accr[64], acci[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accr[i] = acci[i] = 0.f;
  fence_acc(accr);
  fence_acc(acci);
  for (int kt = 0; kt < sg.k_tiles; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full(st), (kt / kStages) & 1);
    __syncwarp();   // the wgmma instructions below are .sync.aligned
    const uint32_t base = tiles + st * kStageBytes;
    mma_stage<kCorr, kBM>(accr, acci, base, smem_raw + (base - raw), 64 * wg,
                          fr, ft);
    // every MMA reading this stage is done: its buffers go back
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty(st));
  }

  // Epilogue through shared memory (free once both warpgroups are done):
  // re and im tiles [128 N][kLdo], M contiguous, then each thread writes
  // one M row's values, consecutive threads on consecutive M (the output's
  // contiguous axis). Register 4c + 2h + e of the fragment holds row
  // fr + 8h, column 8c + 2 ft + e.
  named_sync_consumers();
  float* er = reinterpret_cast<float*>(smem_raw + (tiles - raw));
  float* ei = er + kBN * kLdo;
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = (8 * c + 2 * ft + e) * kLdo + fr + 8 * h;
        er[idx] = accr[4 * c + 2 * h + e];
        ei[idx] = acci[4 * c + 2 * h + e];
      }
  named_sync_consumers();
  const int m = threadIdx.x & (kBM - 1);
  const int gm = m0 + m;
  if (gm >= a.m_len) return;
  const int mq = gm / a.q;
  const long long mo = (long long)mq * a.s_q + (gm - mq * a.q);
  // each pass stores its own result (reading the main pass's output here
  // cost the correction more than its MMAs: the epilogue does not overlap
  // them): the mix adds the PC's two, add_kernel the DFT's
  float* dst_re = kCorr ? a.corr_re : a.out_re;
  float* dst_im = kCorr ? a.corr_im : a.out_im;
  float2* dst = kCorr ? a.corr : a.out;
  for (int n = threadIdx.x / kBM; n < kBN; n += 128 * kConsumers / kBM) {
    const int gn = n0 + n;
    if (gn >= sg.n_len) break;
    const long long off = mo + (long long)(sg.n_off + gn) * a.s_n;
    const float yr = er[n * kLdo + m], yi = ei[n * kLdo + m];
    if (kDft) {
      dst[off] = make_float2(yr, yi);
    } else {
      dst_re[off] = yr;
      dst_im[off] = yi;
    }
  }
}

template <bool kCorr>
__global__ void __launch_bounds__(kThreads, 1)
    pc_gemm_kernel(const __grid_constant__ GemmArgs a) {
  gemm_body<false, kCorr>(a);
}

template <bool kCorr>
__global__ void __launch_bounds__(kThreads, 1)
    dft_gemm_kernel(const __grid_constant__ GemmArgs a) {
  gemm_body<true, kCorr>(a);
}

// ------------------------------------------------------------------ K4

// K4's PC: K1's strip GEMM (K1's stage layout and consumer code) on a
// block that owns a 128-gate tile, a 64-pulse tile and a group of bps
// beams, which it walks: for each beam of the group the k loop of the
// strip, then the rows' stores straight from the accumulators (pcT's pulses
// are contiguous, so a warp's store covers four 32-byte runs), while the
// producer already fills the next beam's stages. Its two consumer
// warpgroups run the two passes on the same 64 rows, the main pass (hi*hi)
// and the correction (hi*lo + lo*hi), so each sample is drawn once for
// both (two launches of a pass each, as K1's, drew everything twice, and
// the draws held them). The producer is two warpgroups (one drawing warp a
// scheduler could not keep up with the MMAs: PERF.md): in draw mode their
// 256 threads make the data's stage themselves (kDraw), Philox draws keyed
// as K1c's (counter (n / 2, p, b, seg), sample n from words 0, 1 of the
// block if n is even, 2, 3 if odd; rails, zeros before pad_front and past
// the segment's samples), written with st.shared into the
// 128-byte-swizzled [64 rows][32 k] layout TMA writes, then
// fence.proxy.async (wgmma reads through the async proxy) and an arrive on
// the stage's full barrier (257 arrivals: the 256 draws and the expect_tx
// of the constant's TMA loads); in planes mode one thread loads the given
// planes by TMA, as K1. The consumers read the same bits either way, so
// draw mode equals planes mode on K1c's planes bit for bit, and both equal
// K1 (the same products in the same order for every row).
constexpr int kK4Rows = 64;                          // pulses of a block
constexpr int kK4TileA = kK4Rows * kBK * 4;          // a data plane's box
constexpr int kK4StageBytes = 2 * kK4TileA + 4 * kTileB;
constexpr size_t kK4Smem = (size_t)kStages * kK4StageBytes + 1024 + 2 * kStages * 8;
constexpr int kK4Producers = 256;                    // two producer warpgroups
constexpr int kK4Threads = 128 * kConsumers + kK4Producers;
// setmaxnreg: the producers give registers to the consumers (256 x 88 +
// 256 x 168 = 512 x 128, the entry budget of 512 threads; 168 is K1's)
constexpr int kProducerRegs = 88, kConsumerRegs = 168;
constexpr int kDrawBlocks = 4;  // Philox blocks (chains) a producer thread runs
                                // at once: 8 samples, two a block

struct K4Seg {
  int blk0;             // first block of the segment
  int nb_n;             // 128-gate tiles
  int k_tiles;          // 32-deep k steps of the strip
  int j_len, g0;        // output gates and their offset
  int pad_front;        // zero samples before the draws
  int x_cols;           // samples of a row (zeros past them)
  int seg_id;           // the segment's index in the plan (Philox counter)
};

struct K4Args {
  CUtensorMap a_re[kMaxSeg], a_im[kMaxSeg];   // planes mode: f32 [B*P, x_cols]
  CUtensorMap b[kMaxSeg];                     // f32 [4 * 128, k_pad] strip
  K4Seg seg[kMaxSeg];
  int n_seg, num_b, num_p, num_g, p4, bps, p_tiles;
  uint2 key;
  float scale;
  float* out_re;        // pcT planes [B, G, p4] (main pass)
  float* out_im;
  float* corr_re;       // and the correction pass's
  float* corr_im;
  float2* out;          // K8 (k8_pc_kernel): complex64 [num_p, num_g]
};

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A pipeline position: a stage and the parity of its current round.
struct Slot {
  int i = 0, phase = 0;
  __device__ __forceinline__ void next() {
    if (++i == kStages) {
      i = 0;
      phase ^= 1;
    }
  }
};

// Producer thread t of kK4Producers draws its part of the data's stage: 8
// consecutive samples (two 16-byte chunks of a row) a step from kDrawBlocks
// Philox blocks, two samples a block (philox.cuh), rows p0 .. p0 + 63 of
// beam b, samples n0 .. n0 + 31; zeros past the pulses, before pad_front
// and past the row's samples.
__device__ __forceinline__ void draw_stage(unsigned char* are, int t, int p0,
                                           int b, int n0, const K4Seg& sg,
                                           const K4Args& a) {
  const int ch = 2 * (t & 3);   // the thread's first chunk of 8
  const int nb = n0 + 4 * ch;   // its first sample (even)
#pragma unroll 1
  for (int r = t >> 2; r < kK4Rows; r += kK4Producers / 4) {
    const int p = p0 + r;
    float v[2][2 * kDrawBlocks];
    if (p < a.num_p) {
      unsigned m[kDrawBlocks];
      uint4 w[kDrawBlocks];
#pragma unroll
      for (int e = 0; e < kDrawBlocks; ++e) m[e] = (unsigned)(nb / 2 + e);
      philox_lanes(m, (unsigned)p, (unsigned)b, (unsigned)sg.seg_id, a.key, w);
#pragma unroll
      for (int e = 0; e < kDrawBlocks; ++e) {
        const int n = nb + 2 * e;
        const bool keep0 = n >= sg.pad_front && n < sg.x_cols;
        const bool keep1 = n + 1 >= sg.pad_front && n + 1 < sg.x_cols;
        v[0][2 * e] = keep0 ? uniform_rail(w[e].x, a.scale) : 0.f;
        v[1][2 * e] = keep0 ? uniform_rail(w[e].y, a.scale) : 0.f;
        v[0][2 * e + 1] = keep1 ? uniform_rail(w[e].z, a.scale) : 0.f;
        v[1][2 * e + 1] = keep1 ? uniform_rail(w[e].w, a.scale) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2 * kDrawBlocks; ++e) v[0][e] = v[1][e] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t o = sw128_off(r, 4 * (ch + q));
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
        *reinterpret_cast<float4*>(are + pl * kK4TileA + o) =
            make_float4(v[pl][4 * q], v[pl][4 * q + 1], v[pl][4 * q + 2],
                        v[pl][4 * q + 3]);
    }
  }
}

// K8's epilogue (k8_pc_kernel: one beam of num_p rows, complex64 out
// [num_p, num_g]): the correction warpgroup puts its accumulators into
// shared memory (the stages are free once both passes' MMAs are done), the
// main warpgroup adds its own to them (main + correction, as K1's join),
// then both write the tile in runs of a row's gates, the output's
// contiguous axis (from the fragments a warp store would cover 8 rows of
// 64 bytes). Register 4c + 2h + e holds row p0 + fr + 8h, gate n0 + 8c +
// 2ft + e; the tile [64 rows][128 gates] float2, rows padded by 64 bytes
// (no bank conflicts for the fragments' 16-byte accesses).
template <bool kCorr>
__device__ __forceinline__ void k8_store(const K4Args& a, const K4Seg& sg,
                                         unsigned char* tile, float (&accr)[64],
                                         float (&acci)[64], int p0, int n0,
                                         int fr, int ft) {
  constexpr int kTileRowBytes = 2 * kBN * 4 + 64;   // a tile row, bytes
  auto frag = [&](int c, int h) {
    return reinterpret_cast<float4*>(tile + (fr + 8 * h) * kTileRowBytes +
                                     (8 * c + 2 * ft) * 8);
  };
  named_sync_consumers();
  if (kCorr) {
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *frag(c, h) = make_float4(accr[4 * c + 2 * h], acci[4 * c + 2 * h],
                                  accr[4 * c + 2 * h + 1], acci[4 * c + 2 * h + 1]);
  }
  named_sync_consumers();
  if (!kCorr) {
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 e = *frag(c, h);
        *frag(c, h) = make_float4(accr[4 * c + 2 * h] + e.x, acci[4 * c + 2 * h] + e.y,
                                  accr[4 * c + 2 * h + 1] + e.z,
                                  acci[4 * c + 2 * h + 1] + e.w);
      }
  }
  named_sync_consumers();
  const int n = threadIdx.x & (kBN - 1);   // this thread's gate
  const int j = n0 + n;
  if (j >= sg.j_len) return;
  for (int r = threadIdx.x / kBN; r < kK4Rows; r += 128 * kConsumers / kBN) {
    const int p = p0 + r;
    if (p >= a.num_p) break;
    a.out[(long long)p * a.num_g + sg.g0 + j] =
        *reinterpret_cast<const float2*>(tile + r * kTileRowBytes + n * 8);
  }
}

// The k loop of a beam's 64 rows (pass kCorr) and its stores: register
// 4c + 2h + e holds pulse p0 + fr + 8h, gate n0 + 8c + 2ft + e (kK8: K8's
// epilogue, k8_store).
template <bool kCorr, bool kK8>
__device__ __forceinline__ void k4_beam(const K4Args& a, const K4Seg& sg,
                                        uint32_t tiles, uint32_t bars,
                                        unsigned char* smem_raw,
                                        uint32_t raw, Slot& sl, int b, int p0,
                                        int n0, int fr, int ft) {
  float accr[64], acci[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accr[i] = acci[i] = 0.f;
  fence_acc(accr);
  fence_acc(acci);
  for (int kt = 0; kt < sg.k_tiles; ++kt, sl.next()) {
    mbar_wait(bars + 8u * sl.i, sl.phase);
    __syncwarp();   // the wgmma instructions below are .sync.aligned
    const uint32_t base = tiles + sl.i * kK4StageBytes;
    mma_stage<kCorr, kK4Rows>(accr, acci, base, smem_raw + (base - raw), 0,
                              fr, ft);
    if ((threadIdx.x & 127) == 0) mbar_arrive(bars + 8u * (kStages + sl.i));
  }
  if (kK8) {
    k8_store<kCorr>(a, sg, smem_raw + (tiles - raw), accr, acci, p0, n0, fr, ft);
    return;
  }
  float* dst_re = kCorr ? a.corr_re : a.out_re;
  float* dst_im = kCorr ? a.corr_im : a.out_im;
  const long long row = (long long)b * a.num_g + sg.g0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + fr + 8 * h;
    if (p >= a.num_p) continue;
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n0 + 8 * c + 2 * ft + e;
        if (j < sg.j_len) {
          const long long off = (row + j) * a.p4 + p;
          dst_re[off] = accr[4 * c + 2 * h + e];
          dst_im[off] = acci[4 * c + 2 * h + e];
        }
      }
  }
}

// K4's PC (kK8 false) or K8's at f32 (kK8: planes mode, one beam, complex64
// out through k8_store).
template <bool kDraw, bool kK8>
__device__ __forceinline__ void k4_body(const K4Args& a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t bars = tiles + kStages * kK4StageBytes;   // full, then empty
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kStages + st); };

  int s = 0;
  while (s + 1 < a.n_seg && (int)blockIdx.x >= pick(a.seg, s + 1).blk0) ++s;
  const K4Seg sg = pick(a.seg, s);
  const int local = blockIdx.x - sg.blk0;
  const int n0 = (local % sg.nb_n) * kBN;
  const int rest = local / sg.nb_n;
  const int p0 = (rest % a.p_tiles) * kK4Rows;
  const int b0 = (rest / a.p_tiles) * a.bps;
  const int b1 = min(b0 + a.bps, a.num_b);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kDraw ? kK4Producers + 1 : 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x - 128 * kConsumers;
    if (!kDraw && t != 0) return;
    const CUtensorMap* mar = &pick(a.a_re, s);
    const CUtensorMap* mai = &pick(a.a_im, s);
    const CUtensorMap* mb = &pick(a.b, s);
    Slot sl;
    int n = 0;
    for (int b = b0; b < b1; ++b)
      for (int kt = 0; kt < sg.k_tiles; ++kt, ++n, sl.next()) {
        if (n >= kStages) mbar_wait(empty(sl.i), sl.phase ^ 1);
        const uint32_t base = tiles + sl.i * kK4StageBytes;
        if (t == 0) {
          mbar_expect_tx(full(sl.i), (kDraw ? 0 : 2 * kK4TileA) + 4 * kTileB);
          if (!kDraw) {
            tma_load(base, mar, n0 + kt * kBK, b * a.num_p + p0, full(sl.i));
            tma_load(base + kK4TileA, mai, n0 + kt * kBK, b * a.num_p + p0,
                     full(sl.i));
          }
          load_constant<true>(base + 2 * kK4TileA, mb, kt, kBN, 0, full(sl.i));
        }
        if (kDraw) {
          draw_stage(smem_raw + (base - raw), t, p0, b, n0 + kt * kBK, sg, a);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full(sl.i));
        }
      }
    return;
  }

  // the consumers: warpgroup 0 the main pass, 1 the correction, on the
  // block's 64 rows
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int fr = 16 * warp + (lane >> 2);   // fragment row (and + 8)
  const int ft = lane & 3;                  // fragment column (and + 4)
  Slot sl;
  for (int b = b0; b < b1; ++b) {
    if (wg == 0)
      k4_beam<false, kK8>(a, sg, tiles, bars, smem_raw, raw, sl, b, p0, n0, fr, ft);
    else
      k4_beam<true, kK8>(a, sg, tiles, bars, smem_raw, raw, sl, b, p0, n0, fr, ft);
  }
}

template <bool kDraw>
__global__ void __launch_bounds__(kK4Threads, 1)
    k4_pc_kernel(const __grid_constant__ K4Args a) {
  k4_body<kDraw, false>(a);
}

// K8 at f32 (studies/pallas_pc.py): K4's planes-mode PC on the staged f32
// planes of every segment (one beam of B*P rows), both passes in one
// launch, the passes joined in shared memory into complex64 rows.
__global__ void __launch_bounds__(kK4Threads, 1)
    k8_pc_kernel(const __grid_constant__ K4Args a) {
  k4_body<false, true>(a);
}

// The beam mix of the PC's two passes into pr, pi [B, n]: x = p + c (the
// main pass's result and the correction), y[b] = sum_c L[b,c] x[c], c
// ascending. (Four values a thread in 16-byte vectors measured slower: the
// registers cut the blocks in flight.)
__global__ void __launch_bounds__(256)
mix_planes_kernel(float* __restrict__ pr, float* __restrict__ pi,
                  const float* __restrict__ cr, const float* __restrict__ ci,
                  const float2* __restrict__ lmat, int num_b, long long n) {
  __shared__ float2 sl[kMaxB * kMaxB];
  for (int i = threadIdx.x; i < num_b * num_b; i += blockDim.x) sl[i] = lmat[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xr[kMaxB], xi[kMaxB];
#pragma unroll
    for (int c = 0; c < kMaxB; ++c) {
      xr[c] = c < num_b ? pr[c * n + i] + cr[c * n + i] : 0.f;
      xi[c] = c < num_b ? pi[c * n + i] + ci[c * n + i] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b >= num_b) continue;
      float yr = 0.f, yi = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxB; ++c) {
        if (c < num_b) {
          const float2 l = sl[b * num_b + c];
          yr = fmaf(l.x, xr[c], yr);
          yr = fmaf(-l.y, xi[c], yr);
          yi = fmaf(l.x, xi[c], yi);
          yi = fmaf(l.y, xr[c], yi);
        }
      }
      pr[b * n + i] = yr;
      pi[b * n + i] = yi;
    }
  }
}

// The join of the PC's two passes without a mix (the f32 schedules mix
// after the DFT): pr += cr, pi += ci over n4 float4s of each plane. Bound
// by bytes (four planes read, two written: 0.105 ms at the perf shape), so
// 16-byte accesses and nothing else.
__global__ void __launch_bounds__(256)
join_kernel(float4* __restrict__ pr, float4* __restrict__ pi,
            const float4* __restrict__ cr, const float4* __restrict__ ci,
            long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 y = pr[i];
    const float4 c = cr[i];
    pr[i] = make_float4(y.x + c.x, y.y + c.y, y.z + c.z, y.w + c.w);
    y = pi[i];
    const float4 d = ci[i];
    pi[i] = make_float4(y.x + d.x, y.y + d.y, y.z + d.z, y.w + d.w);
  }
}

// One element of K1's map: out + corr (the DFT's two passes) + the rank-K
// signal sum_k st[k,b] dv[k,v] pb[k,g]. add_kernel and add_maps_kernel
// both form it here, so the two write the same map bit for bit.
__device__ __forceinline__ float2 k1_element(
    const float2 y, const float2 c, const float2* __restrict__ dv,
    const float2* __restrict__ pb, const float2* __restrict__ st, int num_k,
    int num_b, int num_v, int num_g, int b, int v, int g) {
  float yr = y.x + c.x, yi = y.y + c.y;
  for (int k = 0; k < num_k; ++k) {
    const float2 a = dv[k * num_v + v], p = pb[k * num_g + g];
    const float2 w = st[k * num_b + b];
    const float orr = a.x * p.x - a.y * p.y, oi = a.x * p.y + a.y * p.x;
    yr += w.x * orr - w.y * oi;
    yi += w.x * oi + w.y * orr;
  }
  return make_float2(yr, yi);
}

// The map out [B, V, G] += corr (the DFT's two passes) + the rank-K
// signal. (In the GEMM's epilogue the signal's loads cost a fifth of the
// DFT.)
__global__ void __launch_bounds__(256)
add_kernel(float2* __restrict__ out, const float2* __restrict__ corr,
           const float2* __restrict__ dv, const float2* __restrict__ pb,
           const float2* __restrict__ st, int num_k, int num_b, int num_v,
           int num_g) {
  const long long n = (long long)num_b * num_v * num_g;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int b = 0, v = 0, g = 0;
    if (num_k > 0) {
      const long long bv = i / num_g;
      g = (int)(i - bv * num_g);
      b = (int)(bv / num_v);
      v = (int)(bv - (long long)b * num_v);
    }
    out[i] = k1_element(out[i], corr[i], dv, pb, st, num_k, num_b, num_v,
                        num_g, b, v, g);
  }
}

// K1's epilogue for the kernel-maps tail (cfg.kernel_maps) and bf16
// output (cfg.kernel_out_bf16); replaces the emit_maps and out_dtype
// modes of radar_tpu/ops/pallas_rdm.py::noise_rdm_pallas_gen (:469-478,
// the maps from the resident f32 tiles before the cast). A thread owns a
// (v, g) and walks the beams in order: y[b] = k1_element(...) (add_kernel's
// sum), out[b] = y[b], rounded to bf16 values (nearest even) with
// round_out; with maps, maps[b-1] = |y[b-1]| + |y[b]| from the UNROUNDED
// f32 y, the previous beam's magnitude kept in a register. The magnitude
// is sqrt(re*re + im*im) rounded at each step (the build contracts, so the
// intrinsics keep it the plain version's bit for bit). maps points at
// column 0 of pair 0's interior in K2's padded qvg layout (row stride ld,
// plane stride plane); the wrapper zeroes its halo and padding. With g
// fastest in the thread index, every beam plane's loads and the maps'
// stores are coalesced. Bound by bytes: out and corr read, out and the
// maps' interior written (0.1214 ms at the perf shape).
__global__ void __launch_bounds__(256)
add_maps_kernel(float2* __restrict__ out, const float2* __restrict__ corr,
                const float2* __restrict__ dv, const float2* __restrict__ pb,
                const float2* __restrict__ st, int num_k, int num_b,
                int num_v, int num_g, float* __restrict__ maps, long long ld,
                long long plane, int round_out) {
  const long long pg = (long long)num_v * num_g;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pg;
       i += stride) {
    const int v = (int)(i / num_g), g = (int)(i - (long long)v * num_g);
    float* m = maps == nullptr ? nullptr : maps + (long long)v * ld + g;
    float prev = 0.f;
    for (int b = 0; b < num_b; ++b) {
      const long long j = (long long)b * pg + i;
      float2 y = k1_element(out[j], corr[j], dv, pb, st, num_k, num_b, num_v,
                            num_g, b, v, g);
      if (m != nullptr) {
        const float mag = __fsqrt_rn(
            __fadd_rn(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)));
        if (b > 0) m[(long long)(b - 1) * plane] = __fadd_rn(prev, mag);
        prev = mag;
      }
      if (round_out) {
        y.x = __bfloat162float(__float2bfloat16_rn(y.x));
        y.y = __bfloat162float(__float2bfloat16_rn(y.y));
      }
      out[j] = y;
    }
  }
}

// The f32 schedules' epilogue (the mix AFTER the DFT), in place on the map
// out [B, V, G]: x[c] = out[c] + corr[c] (the DFT's two passes), y[b] =
// sum_c L[b,c] x[c] as the TPU's two real contractions (L's real and
// imaginary parts, combined once), plus the rank-K signal, rounded to bf16
// (nearest even) with round_out. A thread reads a (v, g) of every beam
// before it writes any. Bound by bytes (two maps read, one written: 0.105
// ms at the perf shape). (In the DFT GEMM's epilogue the mix would need
// every beam's tile in one block.)
__global__ void __launch_bounds__(256)
mix_after_kernel(float2* __restrict__ out, const float2* __restrict__ corr,
                 const float2* __restrict__ lmat, const float2* __restrict__ dv,
                 const float2* __restrict__ pb, const float2* __restrict__ st,
                 int num_k, int num_b, int num_v, int num_g, int round_out) {
  __shared__ float2 sl[kMaxB * kMaxB];
  for (int i = threadIdx.x; i < num_b * num_b; i += blockDim.x) sl[i] = lmat[i];
  __syncthreads();
  const long long pg = (long long)num_v * num_g;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pg;
       i += stride) {
    float2 x[kMaxB];
#pragma unroll
    for (int c = 0; c < kMaxB; ++c) {
      x[c] = make_float2(0.f, 0.f);
      if (c < num_b) {
        const float2 y = out[c * pg + i], e = corr[c * pg + i];
        x[c] = make_float2(y.x + e.x, y.y + e.y);
      }
    }
    const int v = (int)(i / num_g), g = (int)(i - (long long)v * num_g);
    for (int b = 0; b < num_b; ++b) {
      float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxB; ++c) {
        if (c < num_b) {
          const float2 l = sl[b * num_b + c];
          rr = fmaf(l.x, x[c].x, rr);
          ii = fmaf(l.y, x[c].y, ii);
          ri = fmaf(l.x, x[c].y, ri);
          ir = fmaf(l.y, x[c].x, ir);
        }
      }
      float yr = rr - ii, yi = ri + ir;
      for (int k = 0; k < num_k; ++k) {
        const float2 a = dv[k * num_v + v], p = pb[k * num_g + g];
        const float2 w = st[k * num_b + b];
        const float orr = a.x * p.x - a.y * p.y, oi = a.x * p.y + a.y * p.x;
        yr += w.x * orr - w.y * oi;
        yi += w.x * oi + w.y * orr;
      }
      if (round_out) {
        yr = __bfloat162float(__float2bfloat16_rn(yr));
        yi = __bfloat162float(__float2bfloat16_rn(yi));
      }
      out[b * pg + i] = make_float2(yr, yi);
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

// Encoded maps by (pointer, cols, rows, ld, box rows), the kMapCache
// latest: a call
// needs 9 maps, and the plan's constants and the caching allocator's
// buffers come back at the same addresses call after call. A map holds
// only the address, shape and box, so a hit is the map encoding would give.
constexpr int kMapCache = 64;
struct MapEntry {
  long long key[5];
  CUtensorMap map;
};
MapEntry g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mutex;   // ctypes calls run without the GIL

// An f32 matrix [rows, cols] with row stride ld elements, read in boxes of
// 32 columns x box_rows rows with 128-byte swizzle; out-of-bounds reads are
// 0.
bool make_map(CUtensorMap* map, long long ptr, long long cols, long long rows,
              long long ld, int box_rows = kBM) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ptr % 16 != 0 || ld % 4 != 0 || cols < 1 || rows < 1 ||
      cols > ld)
    return false;
  const long long key[5] = {ptr, cols, rows, ld, box_rows};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i)
    if (memcmp(g_maps[i].key, key, sizeof key) == 0) {
      *map = g_maps[i].map;
      return true;
    }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, reinterpret_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(g_maps[g_map_next].key, key, sizeof key);
  g_maps[g_map_next].map = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  return true;
}

cudaError_t launch_gemm(const GemmArgs& a, long long blocks,
                        cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  static bool smem_set[4][kMaxDevices] = {};   // the attributes, once a device
  const int bytes = (int)kSmem;
  cudaError_t err = allow_smem(pc_gemm_kernel<false>, bytes, smem_set[0]);
  if (err == cudaSuccess) err = allow_smem(pc_gemm_kernel<true>, bytes, smem_set[1]);
  if (err == cudaSuccess) err = allow_smem(dft_gemm_kernel<false>, bytes, smem_set[2]);
  if (err == cudaSuccess) err = allow_smem(dft_gemm_kernel<true>, bytes, smem_set[3]);
  if (err != cudaSuccess) return err;
  // the main pass, then the correction pass adding to its output
  const unsigned grid = (unsigned)blocks;
  if (a.mode == 0) {
    pc_gemm_kernel<false><<<grid, kThreads, kSmem, stream>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess) pc_gemm_kernel<true><<<grid, kThreads, kSmem, stream>>>(a);
  } else {
    dft_gemm_kernel<false><<<grid, kThreads, kSmem, stream>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess) dft_gemm_kernel<true><<<grid, kThreads, kSmem, stream>>>(a);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The PC over n_seg (1..3) segments in one launch. tab holds 8 values a
// segment: the f32 planes xr, xi [rows, x_cols] (row stride x_ld, a multiple
// of 4; 16-byte aligned), x_cols, x_ld, the strip [4, 128, k_pad] f32
// (re_hi, re_lo, im_hi, im_lo; k contiguous, k_pad a multiple of 32), k_pad,
// the segment's gates j_len and their offset g0. Row r = b * num_p + p,
// gate g0 + j lands in the planes pr, pi [num_b, num_g, p4] at
// (b * num_g + g0 + j) * p4 + p (the main pass), and in cr, ci (the
// correction); k1_tf32_mix adds the two.
int k1_tf32_pc(int n_seg, const long long* tab, int num_b, int num_p,
               int num_g, int p4, void* pr, void* pi, void* cr, void* ci,
               void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || num_b < 1 || num_p < 1 || p4 < num_p ||
      p4 % 4 != 0 || pr == nullptr || pi == nullptr || cr == nullptr ||
      ci == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)num_b * num_p;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int order[kMaxSeg];
  longest_first(n_seg, tab, 8, 5, order);
  GemmArgs a{};
  const int nb_m = (int)((rows + kBM - 1) / kBM);
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 8 * order[i];
    const long long k_pad = t[5], j_len = t[6];
    if (k_pad < kBK || k_pad % kBK != 0 || j_len < 1 || t[7] < 0 ||
        t[7] + j_len > num_g ||
        !make_map(&a.a_re[i], t[0], t[2], rows, t[3]) ||
        !make_map(&a.a_im[i], t[1], t[2], rows, t[3]) ||
        !make_map(&a.b[i], t[4], k_pad, 4 * kBN, k_pad))
      return (int)cudaErrorInvalidValue;
    const int nb_n = (int)((j_len + kBN - 1) / kBN);
    a.seg[i] = Seg{(int)blocks, nb_n, (int)(k_pad / kBK), (int)j_len,
                   (int)t[7], kBN, 1};
    blocks += (long long)nb_m * nb_n;
  }
  a.n_seg = n_seg;
  a.m_len = (int)rows;
  a.mode = 0;
  a.q = num_p;
  a.s_q = (long long)num_g * p4;
  a.s_n = p4;
  a.out_re = static_cast<float*>(pr);
  a.out_im = static_cast<float*>(pi);
  a.corr_re = static_cast<float*>(cr);
  a.corr_im = static_cast<float*>(ci);
  return (int)launch_gemm(a, blocks, static_cast<cudaStream_t>(stream));
}

// K4's PC over n_seg (1..3) segments, the main and the correction pass in
// one launch. tab holds 10 values a segment: the f32 planes xr,
// xi [num_b * num_p, x_cols] (row stride x_ld, a multiple of 4; 16-byte
// aligned), or 0, 0 in draw mode (every segment alike), x_cols (draw mode:
// the segment's samples a row), x_ld, the strip [4, 128, k_pad] f32 (as
// k1_tf32_pc's), k_pad, the segment's gates j_len, their offset g0, its
// pad_front and its index in the plan (the Philox counter's fourth word).
// A block walks bps beams; draws are keyed by (s0, s1). The outputs as
// k1_tf32_pc's: pr, pi the main pass, cr, ci the correction.
int k4_tf32_pc(int n_seg, const long long* tab, int num_b, int num_p,
               int num_g, int p4, int bps, unsigned s0, unsigned s1,
               float scale, void* pr, void* pi, void* cr, void* ci,
               void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || num_b < 1 || num_p < 1 || bps < 1 ||
      bps > num_b || p4 < num_p || p4 % 4 != 0 || pr == nullptr ||
      pi == nullptr || cr == nullptr || ci == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)num_b * num_p;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool draw = tab[0] == 0;
  int order[kMaxSeg];
  longest_first(n_seg, tab, 10, 5, order);
  K4Args a{};
  a.p_tiles = (num_p + kK4Rows - 1) / kK4Rows;
  const long long groups = (num_b + bps - 1) / bps;
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 10 * order[i];
    const long long k_pad = t[5], j_len = t[6];
    if (k_pad < kBK || k_pad % kBK != 0 || j_len < 1 || t[7] < 0 ||
        t[7] + j_len > num_g || t[2] < 1 || t[8] < 0 || t[9] < 0 ||
        (draw ? (t[0] != 0 || t[1] != 0)
              : (!make_map(&a.a_re[i], t[0], t[2], rows, t[3], kK4Rows) ||
                 !make_map(&a.a_im[i], t[1], t[2], rows, t[3], kK4Rows))) ||
        !make_map(&a.b[i], t[4], k_pad, 4 * kBN, k_pad))
      return (int)cudaErrorInvalidValue;
    const int nb_n = (int)((j_len + kBN - 1) / kBN);
    a.seg[i] = K4Seg{(int)blocks, nb_n, (int)(k_pad / kBK), (int)j_len,
                     (int)t[7], (int)t[8], (int)t[2], (int)t[9]};
    blocks += (long long)nb_n * a.p_tiles * groups;
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.n_seg = n_seg;
  a.num_b = num_b;
  a.num_p = num_p;
  a.num_g = num_g;
  a.p4 = p4;
  a.bps = bps;
  a.key = make_uint2(s0, s1);
  a.scale = scale;
  a.out_re = static_cast<float*>(pr);
  a.out_im = static_cast<float*>(pi);
  a.corr_re = static_cast<float*>(cr);
  a.corr_im = static_cast<float*>(ci);
  static bool smem_set[2][kMaxDevices] = {};   // the attributes, once a device
  cudaError_t err = allow_smem(k4_pc_kernel<true>, (int)kK4Smem, smem_set[0]);
  if (err == cudaSuccess) err = allow_smem(k4_pc_kernel<false>, (int)kK4Smem, smem_set[1]);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (draw)
    k4_pc_kernel<true><<<grid, kK4Threads, kK4Smem, st>>>(a);
  else
    k4_pc_kernel<false><<<grid, kK4Threads, kK4Smem, st>>>(a);
  return (int)cudaGetLastError();
}

// K8's PC at f32 (k8_pc_kernel) over n_seg (1..3) segments in one launch:
// K4's planes mode on `rows` rows (one beam), both passes in one block, the
// passes joined in its epilogue, complex64 out [rows, num_g]. tab holds 8
// values a segment, as k1_tf32_pc's: the f32 planes xr, xi [rows, x_cols]
// (row stride x_ld, a multiple of 4; 16-byte aligned; K8's staging kernel
// writes them), x_cols, x_ld, the strip [4, 128, k_pad] f32 (re_hi, re_lo,
// im_hi, im_lo), k_pad, the segment's gates j_len and their offset g0.
int k8_tf32_pc(int n_seg, const long long* tab, int rows, int num_g, void* out,
               void* stream) {
  if (n_seg < 1 || n_seg > kMaxSeg || rows < 1 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  int order[kMaxSeg];
  longest_first(n_seg, tab, 8, 5, order);
  K4Args a{};
  a.p_tiles = (rows + kK4Rows - 1) / kK4Rows;
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* t = tab + 8 * order[i];
    const long long k_pad = t[5], j_len = t[6];
    if (k_pad < kBK || k_pad % kBK != 0 || j_len < 1 || t[7] < 0 ||
        t[7] + j_len > num_g ||
        !make_map(&a.a_re[i], t[0], t[2], rows, t[3], kK4Rows) ||
        !make_map(&a.a_im[i], t[1], t[2], rows, t[3], kK4Rows) ||
        !make_map(&a.b[i], t[4], k_pad, 4 * kBN, k_pad))
      return (int)cudaErrorInvalidValue;
    const int nb_n = (int)((j_len + kBN - 1) / kBN);
    a.seg[i] = K4Seg{(int)blocks, nb_n, (int)(k_pad / kBK), (int)j_len,
                     (int)t[7], 0, (int)t[2], 0};
    blocks += (long long)nb_n * a.p_tiles;
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.n_seg = n_seg;
  a.num_b = 1;
  a.num_p = rows;
  a.num_g = num_g;
  a.bps = 1;
  a.out = static_cast<float2*>(out);
  static bool smem_set[kMaxDevices] = {};   // the attribute, once a device
  const cudaError_t err = allow_smem(k8_pc_kernel, (int)kK4Smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  k8_pc_kernel<<<(unsigned)blocks, kK4Threads, kK4Smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The beam mix by L [B, B] (row-major complex64) of the planes pr + cr,
// pi + ci [num_b, n] (the PC's two passes) into pr, pi; with lmat null
// their join alone, pr += cr, pi += ci (n a multiple of 4, the planes
// 16-byte aligned).
int k1_tf32_mix(void* pr, void* pi, const void* cr, const void* ci,
                const void* lmat, int num_b, long long n, void* stream) {
  if (num_b < 1 || num_b > kMaxB || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lmat == nullptr) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(pr) |
                          reinterpret_cast<uintptr_t>(pi) |
                          reinterpret_cast<uintptr_t>(cr) |
                          reinterpret_cast<uintptr_t>(ci);
    if (n % 4 != 0 || any % 16 != 0) return (int)cudaErrorInvalidValue;
    const long long n4 = num_b * n / 4;
    long long blocks = (n4 + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    join_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<float4*>(pr), static_cast<float4*>(pi),
        static_cast<const float4*>(cr), static_cast<const float4*>(ci), n4);
    return (int)cudaGetLastError();
  }
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  mix_planes_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<float*>(pr), static_cast<float*>(pi),
      static_cast<const float*>(cr), static_cast<const float*>(ci),
      static_cast<const float2*>(lmat), num_b, n);
  return (int)cudaGetLastError();
}

// The DFT: out [B, V, G] complex64 = D @ pc[b] + sum_k st[k,b] dv[k,v]
// pb[k,g], from the mixed planes pr, pi [B, G, p4] (pulses p < num_p) and
// D's split planes d4 [4, v_rows, p4] f32 (v_rows a multiple of 128, rows
// beyond num_v zero); corr [B, V, G] complex64 is scratch (the correction
// pass's result, which add_kernel adds, with the signal, to the main
// pass's in out). With lmat [B, B] (the f32 schedules: pr, pi joined, not
// mixed) out = sum_c L[b,c] (D @ pc[c]) + the signal instead
// (mix_after_kernel), rounded to bf16 values with round_out. Without lmat
// (K1), maps (the interior's first element of K2's padded qvg maps, row
// stride maps_ld, plane stride maps_plane floats) or round_out take
// add_maps_kernel in place of add_kernel: K1's emit_maps and bf16-output
// modes.
int k1_tf32_dft(const void* pr, const void* pi, const void* d4, int v_rows,
                int num_b, int num_v, int num_p, int num_g, int p4,
                const void* dv, const void* pb, const void* st, int num_k,
                const void* lmat, int round_out, void* out, void* corr,
                void* maps, long long maps_ld, long long maps_plane,
                void* stream) {
  if (num_b < 1 || num_v < 1 || v_rows < num_v || v_rows % kBN != 0 ||
      p4 < num_p || p4 % 4 != 0 || out == nullptr || corr == nullptr ||
      (num_k > 0 && (dv == nullptr || pb == nullptr || st == nullptr)) ||
      (lmat != nullptr && num_b > kMaxB) ||
      (lmat != nullptr && maps != nullptr) ||
      (maps != nullptr && (maps_ld < num_g || maps_plane < maps_ld * num_v)))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)num_b * num_g;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  GemmArgs a{};
  const long long ptr_r = reinterpret_cast<long long>(pr);
  const long long ptr_i = reinterpret_cast<long long>(pi);
  if (!make_map(&a.a_re[0], ptr_r, num_p, rows, p4) ||
      !make_map(&a.a_im[0], ptr_i, num_p, rows, p4) ||
      !make_map(&a.b[0], reinterpret_cast<long long>(d4), num_p,
                4LL * v_rows, p4))
    return (int)cudaErrorInvalidValue;
  const int nb_n = (num_v + kBN - 1) / kBN;
  a.seg[0] = Seg{0, nb_n, (num_p + kBK - 1) / kBK, num_v, 0, v_rows, 0};
  a.n_seg = 1;
  a.m_len = (int)rows;
  a.mode = 1;
  a.q = num_g;
  a.s_q = (long long)num_v * num_g;
  a.s_n = num_g;
  a.out = static_cast<float2*>(out);
  a.corr = static_cast<float2*>(corr);
  const long long blocks = (rows + kBM - 1) / kBM * nb_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm(a, blocks, s);
  if (err != cudaSuccess) return (int)err;
  const bool walk = lmat != nullptr || maps != nullptr || round_out;
  const long long n = walk ? (long long)num_v * num_g : rows * num_v;
  long long blocks_e = (n + 255) / 256;
  if (blocks_e > 132 * 16) blocks_e = 132 * 16;
  if (lmat != nullptr)
    mix_after_kernel<<<(unsigned)blocks_e, 256, 0, s>>>(
        a.out, a.corr, static_cast<const float2*>(lmat),
        static_cast<const float2*>(dv), static_cast<const float2*>(pb),
        static_cast<const float2*>(st), num_k, num_b, num_v, num_g, round_out);
  else if (walk)
    add_maps_kernel<<<(unsigned)blocks_e, 256, 0, s>>>(
        a.out, a.corr, static_cast<const float2*>(dv),
        static_cast<const float2*>(pb), static_cast<const float2*>(st), num_k,
        num_b, num_v, num_g, static_cast<float*>(maps), maps_ld, maps_plane,
        round_out);
  else
    add_kernel<<<(unsigned)blocks_e, 256, 0, s>>>(
        a.out, a.corr, static_cast<const float2*>(dv),
        static_cast<const float2*>(pb), static_cast<const float2*>(st), num_k,
        num_b, num_v, num_g);
  return (int)cudaGetLastError();
}

}  // extern "C"
