// The bf16 DFT GEMM of K10, K7 and K9 for NVIDIA Hopper (sm_90a): TMA +
// wgmma on bf16 operands, f32 sums.
//
// Replaces, for bf16 operands (rdm_variants.cu keeps the f32 schedules):
//   dft_kernel: the MTD DFT stage of radar_tpu/ops/pallas_rdm.py::
//       noise_rdm_pallas_planes(variant="resident") (pallas_call :789, body
//       _make_kernel_resident :482), of _call_stacked (:627, K7) and of
//       _call_allbeams (:1088, K9, body _make_kernel_allbeams :661),
//       mt[b] = D [V, P] @ pc[b] [P, G] rounded to bf16 (rdm_variants.cu's
//       mix_kernel then mixes the beams).
// All compute in the TPU's bf16 arithmetic (rdm_variants.cu's header):
// bf16 operands, whose products are exact in f32, sums in f32, results
// rounded to bf16 planes. (wgmma's f32 sums are not IEEE-sequential: each
// instruction rounds its sum toward zero.) Two designs measured slower and
// live only in the ablation scripts, appended to copies of this file:
// K10's resident-ring PC (scripts/ablate_k3_k10.py; the strip GEMM of
// band_pc_sm90.cu was faster) and K9's DFT + mix as one kernel, every
// beam's rounded tile kept in shared memory and mixed there
// (scripts/ablate_k4_k9.py; 64 x 32 tiles leave 32 KB of pc in flight,
// and this GEMM plus the mix was faster).
//
// dft_kernel. A block computes a 128 (Doppler) x 128 (gate) tile of one
// beam: a producer warp loads, per 64-deep k step, D's rounded planes (A,
// K-major boxes [128 rows][64 pulses]; the plan's `d_bf16`) and pc's rows
// as they lie in memory (B, MN-major: boxes [64 pulses][64 gates], two per
// plane), 3 stages of 64 KB; two consumer warpgroups (64 Doppler rows each)
// run wgmma m64n128k16 with B transposed. The epilogue rounds to bf16
// through shared memory, so that each warp writes whole runs of a row.
//
// What bounds it at full width (13 beams, 332 pulses, 3404 gates): the
// DFT is 4.9e9 complex MACs (39 GFLOP, 0.04 ms at 989 TFLOP/s bf16) and
// its bytes (pc read, mt written: 0.12 GB) take 0.035 ms at 3.35 TB/s: so
// operations.
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

#include "launch.cuh"

namespace {

constexpr unsigned long long kTimeoutNs = 4000000000ull;   // 4 s

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
// DFT call needs 4, and the plan's constants and the caching
// allocator's buffers come back at the same addresses call after call. A
// map holds only the address, shape and box, so a hit is the map encoding
// would give.
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
// 128-byte swizzle; out-of-bounds reads are 0. plane_ld == 0: a 2D map.
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
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, plane_ld > 0 ? 3 : 2,
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

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
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
