// K6: ring halo exchange by peer stores, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel radar_tpu/parallel/pallas_ring.py::
// halo_right_permute (pl.pallas_call at :80). Each rank of a ring holds a
// local block [rows, s_local] of a fast-time-sharded signal; the overlap-save
// pulse compression of the next rank needs its trailing `halo` samples of
// every row. The TPU kernel sends them with one make_async_remote_copy per
// chip, straight into the output; here every rank's push kernel stores them
// straight into a receive buffer that its right neighbour allocated, mapped
// into this process by CUDA IPC (cudaIpcOpenMemHandle). The same code
// serves ranks that share one card (separate processes, one context each)
// and ranks on separate cards of one host (the peer stores then travel over
// NVLink). No library collective and no host copy carries the halo.
//
// Layout. Each rank owns one cudaMalloc allocation, zeroed once: a 256-byte
// control block, then two receive slots of rows x width elements (double
// buffering by the parity of the call's sequence number s = 1, 2, ...). A
// slot row is the input of the receiver's overlap-save FFT: columns
// [0, halo) take the left neighbour's halo, [halo, halo + s_local) the
// receiver's own shard, and the rest stay zero (width = nfft).
//
// Protocol, call s, slot p = s & 1:
//   push (this rank, writing into the RIGHT neighbour's allocation): wait
//     until right.consumed >= s - 2 (the slot's last reader is done), store
//     the trailing halo of every row into columns [0, halo) of right.slot[p]
//     (nothing when the right neighbour is the ring's first rank: its halo
//     is the causal edge's zeros, which the slot holds from the start), then
//     a block barrier and one acq_rel count per block; the last block to
//     finish release-stores s into right.flag[p];
//   fill (this rank, its OWN allocation): first release-store consumed =
//     s - 1 (whatever read slot (s - 1) & 1, the FFT of the last fill, ran
//     before it on the stream); then block 0 waits until own.flag[p] == s
//     (acquire) while every block copies the rank's own shard into columns
//     [halo, halo + s_local) of slot p. The stream runs the FFT that reads
//     the slot after the whole kernel, so the one acquire orders the
//     neighbour's stores before it: the halo is read where it landed.
// Each kernel's flags, counts and waits take the scope of the neighbour it
// pairs with: the push the right neighbour's (whose slot and flag it
// writes), the fill the left neighbour's (whose push sets the flag and
// reads `consumed`): the GPU's when that neighbour shares the card, the
// system's when it does not. Every wait is bounded by the global
// nanosecond timer. On timeout the kernel records a code and the sequence
// number once (atomicCAS in the own control block) into a status word in
// mapped pinned host memory, and returns; the wrapper reads that word
// without a host sync and raises. The ranks of one card are time-sliced
// contexts, so a spinning block yields nothing to the others but is cut
// after the timeout; the fill is a kernel of its own, so no block ever
// waits for another block of the same launch.
//
// What bounds it on this card: bytes. At the range-sharded PC of a full
// frame (13 x 332 = 4316 rows of complex64, s_local 1455, halo 699, nfft
// 4096) the push reads 24,135,072 B and writes as many: >= 0.0144 ms at
// 3.35 TB/s on one card, or 0.0536 ms for the 24.1 MB at NVLink's 450 GB/s
// each way between cards; the fill reads and writes the 50.2 MB shard
// (0.030 ms), work that replaces the consumer's concatenation and the FFT's
// zero padding. The design: one warp per row, each lane keeping 64 bytes
// of loads in flight before it stores; 16-byte vectors where the source
// and destination rows share their 16-byte alignment, 8-byte ones where
// they share 8 (complex64 rows of odd length against the slot's aligned
// rows), 4-byte words otherwise; one wave of blocks (three of 256 threads
// an SM) with the rows dealt out evenly, so the signalling (a wait, a
// barrier and an atomic per block) is paid once per resident block and no
// short second wave trails.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;   // <= 80 registers: three blocks an SM, no spills
constexpr int kLaneBytes = 64;    // bytes of loads a lane keeps in flight
constexpr long long kCtrlBytes = 256;
constexpr long long kMaxRowBytes = 1LL << 30;  // rows are copied with int offsets
constexpr int kTimeoutSlot = 1;   // push: the right neighbour never freed the slot
constexpr int kTimeoutHalo = 2;   // receive: the left neighbour's halo never came

struct Ctrl {
  unsigned long long flag[2];     // 0: s of the halo in slot p (left writes)
  unsigned long long pad0[6];
  unsigned long long consumed;    // 64: slots up to this s are read (left reads)
  unsigned long long pad1[7];
  unsigned int push_blocks;       // 128: finished blocks of this rank's push
  unsigned int pad2[15];
  int failed;                     // 192: 0 until the first timeout
};
static_assert(sizeof(Ctrl) <= kCtrlBytes, "control block");

// In mapped pinned host memory: the wrapper reads it without a sync.
struct Status {
  int code;                       // 0, kTimeoutSlot or kTimeoutHalo
  int pad;
  unsigned long long seq;         // the call that timed out
};

// Acquire loads, release stores and acq_rel atomics at the scope of the
// peer: the GPU when both ranks share a card (one L2 holds both sides),
// the system when the peer's buffer lies on another card.
template <bool kSys>
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  if constexpr (kSys)
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

template <bool kSys>
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  if constexpr (kSys)
    asm volatile("atom.acq_rel.sys.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(p), "r"(v) : "memory");
  else
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= want (at_least) or *p == want; false after timeout_ns.
template <bool kSys>
__device__ bool wait_for(const unsigned long long* p, unsigned long long want,
                         bool at_least, long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (true) {
    const unsigned long long v = ld_acquire<kSys>(p);
    if (at_least ? v >= want : v == want) return true;
    if ((long long)(now_ns() - t0) > timeout_ns) return false;
    __nanosleep(200);
  }
}

__device__ void fail(Ctrl* own, Status* st, int code, unsigned long long seq) {
  if (atomicCAS(&own->failed, 0, 1) == 0) {
    volatile Status* v = st;
    v->seq = seq;
    __threadfence_system();
    v->code = code;
    __threadfence_system();
  }
}

// nvec vectors of type V from s to d by the 32 lanes of a warp, each lane
// keeping kLaneBytes of loads in flight before its stores (at most 8
// loads: registers bound the blocks an SM holds).
template <typename V>
__device__ __forceinline__ void copy_vectors(V* d, const V* s, int nvec,
                                             int lane) {
  constexpr int kUnroll =
      kLaneBytes / (int)sizeof(V) < 8 ? kLaneBytes / (int)sizeof(V) : 8;
  for (int i0 = lane; i0 < nvec; i0 += 32 * kUnroll) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * 32 < nvec) r[u] = s[i0 + u * 32];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * 32 < nvec) d[i0 + u * 32] = r[u];
  }
}

// One row of n bytes from s to d by one warp. n and both pointers are
// multiples of 4 bytes; the widest vector both alignments allow.
__device__ __forceinline__ void copy_row(char* d, const char* s, int n,
                                         int lane) {
  const unsigned mis = (unsigned)(((uintptr_t)s ^ (uintptr_t)d) & 15);
  const int w = mis == 0 ? 16 : (mis & 7) == 0 ? 8 : 4;
  int head = (w - (int)((uintptr_t)d & (w - 1))) & (w - 1);
  if (head > n) head = n;
  const int body = (n - head) / w * w;
  for (int i = lane * 4; i < head; i += 32 * 4)
    *reinterpret_cast<unsigned*>(d + i) =
        *reinterpret_cast<const unsigned*>(s + i);
  if (w == 16)
    copy_vectors(reinterpret_cast<uint4*>(d + head),
                 reinterpret_cast<const uint4*>(s + head), body / 16, lane);
  else if (w == 8)
    copy_vectors(reinterpret_cast<uint2*>(d + head),
                 reinterpret_cast<const uint2*>(s + head), body / 8, lane);
  else
    copy_vectors(reinterpret_cast<unsigned*>(d + head),
                 reinterpret_cast<const unsigned*>(s + head), body / 4, lane);
  for (int i = head + body + lane * 4; i < n; i += 32 * 4)
    *reinterpret_cast<unsigned*>(d + i) =
        *reinterpret_cast<const unsigned*>(s + i);
}

__device__ __forceinline__ char* slot_of(void* base, long long slot_bytes,
                                         int p) {
  return static_cast<char*>(base) + kCtrlBytes + p * slot_bytes;
}

// Publish that the slot of call seq - 1 has been read (see the protocol).
template <bool kSys>
__device__ __forceinline__ void release_previous(Ctrl* own,
                                                 unsigned long long seq) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && seq > 1)
    st_release<kSys>(&own->consumed, seq - 1);
}

// Row r's bytes [0, row_bytes) at src + r * src_stride go to the right
// neighbour's slot p at r * dst_stride, when `send`.
template <bool kSys>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
push_kernel(const char* __restrict__ src, long long src_stride, int rows,
            long long row_bytes, char* peer, long long slot_bytes,
            long long dst_stride, int send, unsigned long long seq,
            long long timeout_ns, Ctrl* own, Status* status) {
  __shared__ int ok;
  Ctrl* right = reinterpret_cast<Ctrl*>(peer);
  const int p = (int)(seq & 1);
  if (threadIdx.x == 0)
    ok = seq < 3 ||
         wait_for<kSys>(&right->consumed, seq - 2, true, timeout_ns);
  __syncthreads();
  if (!ok) {
    if (threadIdx.x == 0) fail(own, status, kTimeoutSlot, seq);
    return;
  }
  if (send) {
    char* dst = slot_of(peer, slot_bytes, p);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
         r += (long long)gridDim.x * kWarps)
      copy_row(dst + r * dst_stride, src + r * src_stride, (int)row_bytes,
               lane);
  }
  // The block's stores are ordered before its count by the barrier and the
  // count's release (cumulative), as in a cooperative grid sync, not by a
  // fence in every thread; the last block's acquire orders every block's
  // stores before its release of the flag.
  __syncthreads();
  if (threadIdx.x == 0 &&
      atom_add_acq_rel<kSys>(&own->push_blocks, 1u) == gridDim.x - 1) {
    own->push_blocks = 0;
    st_release<kSys>(&right->flag[p], seq);
  }
}

// The receiver's overlap-save input: its own shard (rows of shard_bytes at
// x + r * x_stride) into columns from halo_bytes of slot p; block 0 waits
// for the halo.
template <bool kSys>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fill_kernel(Ctrl* own, long long slot_bytes, long long slot_stride, int rows,
            const char* __restrict__ x, long long x_stride,
            long long halo_bytes, long long shard_bytes,
            unsigned long long seq, long long timeout_ns, Status* status) {
  const int p = (int)(seq & 1);
  release_previous<kSys>(own, seq);
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      !wait_for<kSys>(&own->flag[p], seq, false, timeout_ns))
    fail(own, status, kTimeoutHalo, seq);
  char* slot = slot_of(own, slot_bytes, p) + halo_bytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps)
    copy_row(slot + r * slot_stride, x + r * x_stride, (int)shard_bytes,
             lane);
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int k6_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// One allocation on `device`, zeroed: the control block and two slots of
// slot_bytes (a multiple of 256). Writes its base to *base, its IPC handle
// (k6_handle_bytes() bytes) to handle, and a zeroed status word in mapped
// pinned host memory to *status (the host address, which with unified
// addressing the kernels take as it is).
int k6_alloc(int device, long long slot_bytes, void** base, void* handle,
             void** status) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostAlloc(status, sizeof(Status), cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  memset(*status, 0, sizeof(Status));
  void* dev_status = nullptr;
  e = cudaHostGetDevicePointer(&dev_status, *status, 0);
  if (e == cudaSuccess && dev_status != *status) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaMalloc(base, kCtrlBytes + 2 * slot_bytes);
  if (e != cudaSuccess) {
    cudaFreeHost(*status);
    return (int)e;
  }
  e = cudaMemset(*base, 0, kCtrlBytes + 2 * slot_bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *base);
  if (e != cudaSuccess) {
    cudaFree(*base);
    cudaFreeHost(*status);
  }
  return (int)e;
}

// Map another process's allocation (its handle bytes) into this one.
int k6_open(int device, const void* handle, void** peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(peer, h, cudaIpcMemLazyEnablePeerAccess);
}

int k6_close(void* peer) { return (int)cudaIpcCloseMemHandle(peer); }

int k6_free(void* base, void* status) {
  cudaError_t e = cudaFree(base);
  cudaError_t h = cudaFreeHost(status);
  return (int)(e != cudaSuccess ? e : h);
}

// Blocks for `rows` rows on `device`: one wave of resident blocks (the
// occupancy of the wider of the two kernels), with the rows dealt out
// evenly over their warps.
int k6_blocks(int device, int rows, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device);
  int occ[2] = {0, 0};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0],
                                                      push_kernel<true>,
                                                      kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[1],
                                                      fill_kernel<true>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  per_sm = occ[0] < occ[1] ? occ[0] : occ[1];
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * sms * kWarps;
  const long long rows_per_warp = (rows + warps - 1) / warps;
  const long long per_block = rows_per_warp * kWarps;
  *blocks = (int)((rows + per_block - 1) / per_block);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

// Call `seq`'s push on `blocks` blocks: rows of row_bytes at src +
// r * src_stride (multiples of 4 bytes) into slot seq & 1 of the allocation
// at `peer`, rows dst_stride apart; only the signal when send == 0; `sys`
// when the right neighbour lies on another card.
int k6_push(const void* src, long long src_stride, int rows,
            long long row_bytes, void* peer, long long slot_bytes,
            long long dst_stride, int send, unsigned long long seq,
            long long timeout_ns, void* own, void* status, int sys,
            int blocks, void* stream) {
  if (row_bytes > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  auto kernel = sys ? push_kernel<true> : push_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), src_stride, rows, row_bytes,
      static_cast<char*>(peer), slot_bytes, dst_stride, send, seq, timeout_ns,
      static_cast<Ctrl*>(own), static_cast<Status*>(status));
  return (int)cudaGetLastError();
}

// Call `seq`'s fill: the shard (rows of shard_bytes at x + r * x_stride)
// into slot seq & 1 of the own allocation from column byte halo_bytes, rows
// slot_stride apart, once the halo of call seq has landed; `sys` when the
// left neighbour lies on another card.
int k6_fill(void* own, long long slot_bytes, long long slot_stride, int rows,
            const void* x, long long x_stride, long long halo_bytes,
            long long shard_bytes, unsigned long long seq,
            long long timeout_ns, void* status, int sys, int blocks,
            void* stream) {
  if (shard_bytes > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  auto kernel = sys ? fill_kernel<true> : fill_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Ctrl*>(own), slot_bytes, slot_stride, rows,
      static_cast<const char*>(x), x_stride, halo_bytes, shard_bytes, seq,
      timeout_ns, static_cast<Status*>(status));
  return (int)cudaGetLastError();
}

}  // extern "C"
