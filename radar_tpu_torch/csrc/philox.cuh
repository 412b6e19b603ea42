// Philox4x32-10 counter-based generator (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11). Same arithmetic as
// radar_tpu_torch/ops/noise_rdm.py::philox4x32_10, so the plain PyTorch
// planes and the kernel's draws are bit-identical.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// 24-bit integer -> U[-a, a): (k + 0.5 - 2^23) * (2a / 2^24). The integer
// and the offset subtraction are exact in f32; the one rounding is the
// product, as in the plain version.
__device__ __forceinline__ float uniform_rail(unsigned w, float scale) {
  const float k24 = __uint2float_rn(w >> 8);
  return __fmul_rn(__fsub_rn(k24, 8388607.5f), scale);
}

// Philox4x32-10 on kLanes counters (n[i], p, b, seg) at once with one key
// schedule: words 0 and 1 of each block into w0, w1 (independent chains side
// by side, so a thread keeps the integer pipes busy). The drawing producers
// of K4 (noise_rdm_sm90.cu) and of the strip GEMM's draw mode
// (band_pc_sm90.cu) key their draws as K1c does.
template <int kLanes>
__device__ __forceinline__ void philox_lanes(const unsigned (&n)[kLanes],
                                             unsigned p, unsigned b, unsigned seg,
                                             uint2 k, unsigned (&w0)[kLanes],
                                             unsigned (&w1)[kLanes]) {
  unsigned c0[kLanes], c1[kLanes], c2[kLanes], c3[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    c0[i] = n[i];
    c1[i] = p;
    c2[i] = b;
    c3[i] = seg;
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const unsigned lo0 = 0xD2511F53u * c0[i];
      const unsigned hi0 = __umulhi(0xD2511F53u, c0[i]);
      const unsigned lo1 = 0xCD9E8D57u * c2[i];
      const unsigned hi1 = __umulhi(0xCD9E8D57u, c2[i]);
      c0[i] = hi1 ^ c1[i] ^ k.x;
      c1[i] = lo1;
      c2[i] = hi0 ^ c3[i] ^ k.y;
      c3[i] = lo0;
    }
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    w0[i] = c0[i];
    w1[i] = c1[i];
  }
}
