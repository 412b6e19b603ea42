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
