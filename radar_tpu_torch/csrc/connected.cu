// The clusterings' connected labels for NVIDIA Hopper (sm_90a): the
// components of a gated detection list, converged on the card in one
// thread block. Compiled with -fmad=false.
//
// Replaces no TPU kernel. JAX jit-compiles the clusterings and runs their
// fixpoint in lax.while_loop on the device (radar_tpu/cluster/
// connected.py); eager PyTorch ran the same step from the host and read a
// device flag every few steps to stop (cluster/connected.py::
// connected_labels), a wait on the card that kept the frame tail out of a
// CUDA graph. This kernel runs that step to its fixpoint with the stop
// decided in the block (__syncthreads_or), so the tail has no host read.
//
// Function: slots i, j (both valid) are adjacent when |f_k[i] - f_k[j]|
// <= gate_k for every field k, the f32 difference and the f32 gate, as
// cluster/connected.py::gate_adjacency compares on the card; a component's
// label is its smallest valid member index, an invalid slot's is n. These
// labels are the unique fixpoint of the step, so they equal
// connected_labels(gate_adjacency(...)) bit for bit.
//
// The step, as the plain version's: each slot takes the smallest label
// among itself and its neighbours, then the label of that label's slot
// (pointer jumping), from the previous labels (two buffers, one barrier
// each), until no label moves.
//
// What bounds it on this card: one block's issue. The work is n^2 gate
// tests and a few dozen propagation passes over at most n = 512 slots, far
// under a microsecond of the card's bandwidth; one SM does it, the rest of
// the card stays free. What the design does about it: the valid slots are
// packed first (a block-wide prefix count), so the invalid tail of a
// first-K list costs nothing; the gate tests run once, into a bit matrix
// in shared memory (a row's stride odd, so a warp's rows fall in distinct
// banks), and each pass walks only the set bits of a slot's row. The
// matrix bounds n: the wrapper takes n up to 1024 slots (a row of 33
// words, 160 KB of shared memory with three fields), twice the
// configurations' 512-detection cap.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 3;
constexpr int kMaxSmem = 232448 - 2048;   // dynamic, beside the static

static_assert(kWarps == 32, "the compaction scans one count per lane");

struct Gates {
  const float* f[kMaxFields];   // [n] each
  float gate[kMaxFields];
  int nf;
};

// Slots a and b (packed indices) pass every gate.
__device__ __forceinline__ bool adjacent(const float* fs, int n,
                                         const Gates& g, int a, int b) {
  for (int k = 0; k < g.nf; ++k) {
    const float d = fabsf(__fsub_rn(fs[k * n + a], fs[k * n + b]));
    if (!(d <= g.gate[k])) return false;
  }
  return true;
}

// Shared memory: vidx [n] (packed -> slot), the fields [nf][n] packed, the
// labels cur [n] and nxt [n] (packed indices), then the bit matrix [n][wp]
// (bit t of word w of row a: packed slot 32 w + t is a's neighbour).
__global__ void __launch_bounds__(kThreads, 1)
cc_kernel(Gates g, const unsigned char* valid, int n, int wp,
          long long* labels) {
  extern __shared__ int smem[];
  int* vidx = smem;
  float* fs = reinterpret_cast<float*>(smem + n);
  int* cur = smem + n * (1 + g.nf);
  int* nxt = cur + n;
  unsigned* bits = reinterpret_cast<unsigned*>(nxt + n);
  __shared__ int warp_off[kWarps];
  __shared__ int chunk, packed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the valid slots packed in index order; an invalid slot's label is n
  if (tid == 0) packed = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool v = i < n && valid[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int c = warp_off[lane];
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      warp_off[lane] = incl - c;
      if (lane == 31) chunk = incl;
    }
    __syncthreads();
    if (v) {
      const int k = packed + warp_off[warp] +
                    __popc(ballot & ((1u << lane) - 1u));
      vidx[k] = i;
      for (int f = 0; f < g.nf; ++f) fs[f * n + k] = g.f[f][i];
    } else if (i < n) {
      labels[i] = n;
    }
    __syncthreads();
    if (tid == 0) packed += chunk;
  }
  __syncthreads();
  const int m = packed, words = (m + 31) >> 5;

  for (int a = tid; a < m; a += kThreads) cur[a] = a;
  for (int e = tid; e < m * words; e += kThreads) {
    const int a = e / words, w = e - a * words;
    const int j0 = 32 * w, jn = min(32, m - j0);
    unsigned b = 0u;
    for (int t = 0; t < jn; ++t)
      if (adjacent(fs, n, g, a, j0 + t)) b |= 1u << t;
    bits[a * wp + w] = b;
  }
  __syncthreads();

  int moved;
  do {
    // the smallest label among a slot and its neighbours
    for (int a = tid; a < m; a += kThreads) {
      int best = cur[a];
      const unsigned* row = bits + a * wp;
      for (int w = 0; w < words; ++w)
        for (unsigned b = row[w]; b != 0u; b &= b - 1u)
          best = min(best, cur[32 * w + __ffs(b) - 1]);
      nxt[a] = best;
    }
    __syncthreads();
    // pointer jumping: adopt your representative's label
    int any = 0;
    for (int a = tid; a < m; a += kThreads) {
      const int lab = min(nxt[a], nxt[nxt[a]]);
      any |= lab != cur[a];
      cur[a] = lab;
    }
    moved = __syncthreads_or(any);
  } while (moved);

  for (int a = tid; a < m; a += kThreads) labels[vidx[a]] = vidx[cur[a]];
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// f0, f1, f2: the nf gate fields [n] f32 (unused ones may be null), g0..g2
// their gates; valid [n] bool; labels [n] int64 out. One block.
int cc_labels(int n, int nf, const void* f0, const void* f1, const void* f2,
              float g0, float g1, float g2, const void* valid, void* labels,
              void* stream) {
  if (n < 1 || nf < 1 || nf > kMaxFields) return (int)cudaErrorInvalidValue;
  Gates g{};
  const void* f[kMaxFields] = {f0, f1, f2};
  const float gates[kMaxFields] = {g0, g1, g2};
  for (int k = 0; k < nf; ++k) {
    if (f[k] == nullptr) return (int)cudaErrorInvalidValue;
    g.f[k] = static_cast<const float*>(f[k]);
    g.gate[k] = gates[k];
  }
  g.nf = nf;
  const long long words = (n + 31) / 32, wp = words | 1;
  const long long smem = 4LL * n * (3 + nf + wp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(cc_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cc_kernel<<<1, kThreads, (size_t)smem, st>>>(
      g, static_cast<const unsigned char*>(valid), n, (int)wp,
      static_cast<long long*>(labels));
  return (int)cudaGetLastError();
}

}  // extern "C"
