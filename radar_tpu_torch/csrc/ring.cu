// K6: ring halo exchange by peer stores, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel radar_tpu/parallel/pallas_ring.py::
// halo_right_permute (pl.pallas_call at :80). Each rank of a ring holds a
// local block [rows, s_local] of a fast-time-sharded signal; the overlap-save
// pulse compression of the next rank needs its trailing `halo` samples of
// every row. The TPU kernel sends them with one make_async_remote_copy per
// chip; here every rank's kernel stores them straight into a receive buffer
// that its right neighbour allocated, mapped into this process by CUDA IPC
// (cudaIpcOpenMemHandle). The same code serves ranks that share one card
// (separate processes, one context each) and ranks on separate cards of one
// host (the peer stores then travel over NVLink). No library collective and
// no host copy carries the halo.
//
// Protocol. Each rank owns one cudaMalloc allocation: a 256-byte control
// block, then two receive slots of rows*halo elements (double buffering by
// the parity of the call's sequence number s = 1, 2, ...). Call s, slot
// p = s & 1:
//   push (this rank, writing into the RIGHT neighbour's allocation):
//     wait until right.consumed >= s - 2 (the slot's last halo was read),
//     copy the trailing halo of every row into right.slot[p], then a block
//     barrier and one __threadfence_system() per block; the last block to
//     finish release-stores s into right.flag[p] (system scope);
//   pull (this rank, reading its OWN allocation):
//     wait until own.flag[p] == s (acquire, system scope), copy slot p into
//     a fresh output (or write zeros on the ring's first rank: the causal
//     edge), and the last block release-stores s into own.consumed.
// Every wait is bounded by the global nanosecond timer; on timeout the
// kernel records a code and the sequence number in its own control block
// and returns, and the wrapper raises. The ranks of one card are time-sliced
// contexts, so a spinning block yields nothing to the others but is cut
// after the timeout; the pull runs as its own kernel, so no block ever waits
// for another block of the same launch.
//
// What bounds it on this card: bytes. At the range-sharded PC of a full
// frame (13 x 332 = 4316 rows of complex64, halo 699) it reads 24,135,072 B
// and writes as many: >= 0.0144 ms at 3.35 TB/s on one card, or 0.0536 ms
// for the 24.1 MB at NVLink's 450 GB/s each way between cards. The design:
// one warp per row, 16-byte vector loads and stores wherever the source and
// destination rows share their alignment (interleaved complex64 needs no
// split into planes), 4-byte words otherwise. This first version is a plain
// copy; overlapping the push with the local FFT is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kCtrlBytes = 256;
constexpr int kTimeoutSlot = 1;   // push: the right neighbour never freed the slot
constexpr int kTimeoutHalo = 2;   // pull: the left neighbour's halo never came

struct Ctrl {
  unsigned long long flag[2];     // 0: s of the halo in slot p (left writes)
  unsigned long long pad0[6];
  unsigned long long consumed;    // 64: last s copied out (left reads)
  unsigned long long pad1[7];
  unsigned int push_blocks;       // 128: finished blocks of this rank's push
  unsigned int pull_blocks;       // 132: finished blocks of this rank's pull
  unsigned int pad2[14];
  int status;                     // 192: 0, kTimeoutSlot or kTimeoutHalo
  int pad3;
  unsigned long long status_seq;  // 200: the call that timed out
};
static_assert(sizeof(Ctrl) <= kCtrlBytes, "control block");

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= want (at_least) or *p == want; false after timeout_ns.
__device__ bool wait_for(const unsigned long long* p, unsigned long long want,
                         bool at_least, long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while (true) {
    const unsigned long long v = ld_acquire_sys(p);
    if (at_least ? v >= want : v == want) return true;
    if ((long long)(now_ns() - t0) > timeout_ns) return false;
    __nanosleep(200);
  }
}

__device__ void fail(Ctrl* own, int code, unsigned long long seq) {
  if (atomicCAS(&own->status, 0, code) == 0) own->status_seq = seq;
}

// n bytes from s to d over `lanes` cooperating threads. n and both pointers
// are multiples of 4 bytes. L2 loads (__ldcg) when the source is a receive
// slot that another context or card stored into.
template <bool kFromPeer>
__device__ __forceinline__ void copy_bytes(char* d, const char* s, long long n,
                                           long long lane, long long lanes) {
  const unsigned ms = (unsigned)((uintptr_t)s & 15);
  const unsigned md = (unsigned)((uintptr_t)d & 15);
  long long head = n, body = 0;
  if (ms == md) {
    head = (16 - md) & 15;
    if (head > n) head = n;
    body = (n - head) & ~15LL;
  }
  for (long long i = lane * 4; i < head; i += lanes * 4) {
    const unsigned* src = reinterpret_cast<const unsigned*>(s + i);
    *reinterpret_cast<unsigned*>(d + i) = kFromPeer ? __ldcg(src) : *src;
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(s + head);
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  for (long long i = lane; i < body / 16; i += lanes)
    d4[i] = kFromPeer ? __ldcg(s4 + i) : s4[i];
  for (long long i = head + body + lane * 4; i < n; i += lanes * 4) {
    const unsigned* src = reinterpret_cast<const unsigned*>(s + i);
    *reinterpret_cast<unsigned*>(d + i) = kFromPeer ? __ldcg(src) : *src;
  }
}

__device__ __forceinline__ void zero_bytes(char* d, long long n,
                                           long long lane, long long lanes) {
  long long head = (16 - ((uintptr_t)d & 15)) & 15;
  if (head > n) head = n;
  const long long body = (n - head) & ~15LL;
  for (long long i = lane * 4; i < head; i += lanes * 4)
    *reinterpret_cast<unsigned*>(d + i) = 0u;
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  for (long long i = lane; i < body / 16; i += lanes)
    d4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = head + body + lane * 4; i < n; i += lanes * 4)
    *reinterpret_cast<unsigned*>(d + i) = 0u;
}

// One warp per row: row r's bytes [0, row_bytes) at src + r * row_stride go
// to the right neighbour's slot p at r * row_bytes.
__global__ void __launch_bounds__(kThreads)
push_kernel(const char* __restrict__ src, long long row_stride, int rows,
            long long row_bytes, char* peer, long long slot_bytes,
            unsigned long long seq, long long timeout_ns, Ctrl* own) {
  __shared__ int ok;
  Ctrl* right = reinterpret_cast<Ctrl*>(peer);
  const int p = (int)(seq & 1);
  if (threadIdx.x == 0)
    ok = seq < 3 || wait_for(&right->consumed, seq - 2, true, timeout_ns);
  __syncthreads();
  if (!ok) {
    if (threadIdx.x == 0) fail(own, kTimeoutSlot, seq);
    return;
  }
  char* dst = peer + kCtrlBytes + p * slot_bytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps)
    copy_bytes<false>(dst + r * row_bytes, src + r * row_stride, row_bytes,
                      lane, 32);
  // The block's stores are ordered before its count by the barrier and one
  // system-scope fence (cumulative), as in a cooperative grid sync, not by
  // a fence in every thread.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (atomicAdd(&own->push_blocks, 1u) == gridDim.x - 1) {
      own->push_blocks = 0;
      __threadfence_system();
      st_release_sys(&right->flag[p], seq);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pull_kernel(Ctrl* own, long long slot_bytes, char* __restrict__ out,
            long long nbytes, unsigned long long seq, int zero,
            long long timeout_ns) {
  __shared__ int ok;
  const int p = (int)(seq & 1);
  if (threadIdx.x == 0) ok = wait_for(&own->flag[p], seq, false, timeout_ns);
  __syncthreads();
  if (!ok) {
    if (threadIdx.x == 0) fail(own, kTimeoutHalo, seq);
    return;
  }
  const char* slot =
      reinterpret_cast<const char*>(own) + kCtrlBytes + p * slot_bytes;
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long lanes = (long long)gridDim.x * kThreads;
  if (zero)
    zero_bytes(out, nbytes, lane, lanes);
  else
    copy_bytes<true>(out, slot, nbytes, lane, lanes);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&own->pull_blocks, 1u) == gridDim.x - 1) {
      own->pull_blocks = 0;
      __threadfence_system();
      st_release_sys(&own->consumed, seq);
    }
  }
}

int block_cap() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 4 * (sms > 0 ? sms : 132);
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int k6_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// One allocation on `device`: the zeroed control block and two slots of
// slot_bytes (a multiple of 256). Writes its base to *base and its IPC
// handle (k6_handle_bytes() bytes) to handle.
int k6_alloc(int device, long long slot_bytes, void** base, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMalloc(base, kCtrlBytes + 2 * slot_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*base, 0, kCtrlBytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *base);
  if (e != cudaSuccess) cudaFree(*base);
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

int k6_free(void* base) { return (int)cudaFree(base); }

// Call `seq`'s push: rows of row_bytes at src + r * row_stride (multiples
// of 4 bytes) into slot seq & 1 of the allocation at `peer`.
int k6_push(const void* src, long long row_stride, int rows,
            long long row_bytes, void* peer, long long slot_bytes,
            unsigned long long seq, long long timeout_ns, void* own,
            void* stream) {
  long long blocks = (rows + kWarps - 1) / kWarps;
  const long long cap = block_cap();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  push_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), row_stride, rows, row_bytes,
      static_cast<char*>(peer), slot_bytes, seq, timeout_ns,
      static_cast<Ctrl*>(own));
  return (int)cudaGetLastError();
}

// Call `seq`'s pull: slot seq & 1 of the own allocation (nbytes, a multiple
// of 4) into out, or zeros into out when `zero` is set.
int k6_pull(void* own, long long slot_bytes, void* out, long long nbytes,
            unsigned long long seq, int zero, long long timeout_ns,
            void* stream) {
  long long blocks = (nbytes / 16 + kThreads - 1) / kThreads;
  const long long cap = block_cap();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  pull_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<Ctrl*>(own), slot_bytes, static_cast<char*>(out), nbytes,
      seq, zero, timeout_ns);
  return (int)cudaGetLastError();
}

// Wait for the stream, then read the own control block's status code and
// the sequence number it names.
int k6_status(void* own, void* stream, int* status,
              unsigned long long* seq) {
  cudaError_t e = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  Ctrl c;
  e = cudaMemcpy(&c, own, sizeof(Ctrl), cudaMemcpyDeviceToHost);
  *status = c.status;
  *seq = c.status_seq;
  return (int)e;
}

}  // extern "C"
