// K5: complex AWGN added to a complex64 cube, for NVIDIA Hopper (sm_90a).
// Compiled with -fmad=false.
//
// Replaces the TPU kernel radar_tpu/ops/pallas_noise.py::add_noise_pallas
// (body _awgn_kernel): y = x + n with n complex Gaussian, per-rail standard
// deviation sigma = sqrt(p_noise / 2), by Box-Muller on 24-bit uniforms.
//
// Draws. The TPU kernel seeds the core's hardware generator per block; this
// kernel uses counter-based Philox4x32-10 (philox.cuh), keyed by the frame
// seed's two 32-bit words. The counter of draw pair i (complex samples 2i
// and 2i+1 of the flattened cube) is (lo32(i), hi32(i), 0, kAwgnTag); K1's
// counters carry a segment index 0..2 in that last word, so the two kernels
// never share a stream. One Philox call gives 4 words: (w.x, w.y) make
// sample 2i, (w.z, w.w) sample 2i+1, each as in _awgn_kernel:
//   u1 = (k1 + 0.5) * 2^-24,  theta = (2*pi*2^-24) * k2,  k = w >> 8
//   r = sqrt(-2 * log(u1)) * sigma,  y = x + (r cos theta, r sin theta)
// with accurate logf/sincosf (no fast math) and explicitly rounded
// products and sums, so the plain PyTorch version (ops/awgn.py) sees the
// same uniforms bit for bit and differs only by the ulps of log/sin/cos.
// Neither reproduces the TPU's or JAX's bits: the contract is statistical.
//
// What bounds it on this card: memory. At the reference frame [332, 5819,
// 16] it reads and writes 247 MB each, >= 0.15 ms at 3.35 TB/s, plus
// 15.5 M Philox calls (~150 integer ops each) and 31 M log + sincos; the
// prediction is memory-bound at roughly 0.2 ms.
//
// What the design does about it: one thread per draw pair reads its two
// interleaved complex samples as one 16-byte float4 (the cube is read and
// written once, in place of the TPU's planar re/im planes), and every
// random word is used, so no draw is wasted.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr unsigned kAwgnTag = 0x4157474Eu;   // "AWGN"
constexpr int kThreads = 256;

__device__ __forceinline__ float2 noisy(float2 x, unsigned a, unsigned b,
                                        float sigma, float theta_scale) {
  const float u1 = __fmul_rn(__fadd_rn(__uint2float_rn(a >> 8), 0.5f),
                             5.9604644775390625e-08f);          // 2^-24
  const float theta = __fmul_rn(theta_scale, __uint2float_rn(b >> 8));
  const float r = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), sigma);
  float s, c;
  sincosf(theta, &s, &c);
  return make_float2(__fadd_rn(x.x, __fmul_rn(r, c)),
                     __fadd_rn(x.y, __fmul_rn(r, s)));
}

__global__ void __launch_bounds__(kThreads)
awgn_kernel(const float2* __restrict__ x, float2* __restrict__ y,
            long long n, unsigned k0, unsigned k1, float sigma,
            float theta_scale) {
  const long long pairs = (n + 1) / 2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < pairs; i += stride) {
    const uint4 w = philox4x32_10(
        make_uint4((unsigned)i, (unsigned)(i >> 32), 0u, kAwgnTag),
        make_uint2(k0, k1));
    const long long s = 2 * i;
    if (s + 1 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      const float2 a =
          noisy(make_float2(v.x, v.y), w.x, w.y, sigma, theta_scale);
      const float2 b =
          noisy(make_float2(v.z, v.w), w.z, w.w, sigma, theta_scale);
      reinterpret_cast<float4*>(y)[i] = make_float4(a.x, a.y, b.x, b.y);
    } else {
      y[s] = noisy(x[s], w.x, w.y, sigma, theta_scale);
    }
  }
}

}  // namespace

extern "C" {

const char* radar_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, y: n interleaved complex64 values, 16-byte aligned, not overlapping.
// theta_scale = f32(2*pi*2^-24), passed so it is the plain version's value.
int k5_awgn(const void* x, void* y, long long n, unsigned k0, unsigned k1,
            float sigma, float theta_scale, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long pairs = (n + 1) / 2;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  const long long cap = 32LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  awgn_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, k0, k1,
      sigma, theta_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
