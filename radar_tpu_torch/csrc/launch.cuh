// Host-side launch helpers the sm_90a libraries share (band_pc_sm90.cu,
// noise_rdm_sm90.cu, rdm_sm90.cu, cfar.cu): a kernel's dynamic
// shared-memory attribute set once a device, and the order in which a
// segment table's blocks are numbered.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// The dynamic shared-memory attribute of `kernel` set to `bytes`, once a
// device (`done`: the caller's static flags, one a device).
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

// Segments i of tab (stride `stride`, column `k_col` holding k_pad) in the
// order of their k loops, longest first, so that the blocks with the
// longest loops are numbered, and started, first.
template <int N>
void longest_first(int n_seg, const long long* tab, int stride, int k_col,
                   int (&order)[N]) {
  for (int i = 0; i < N; ++i) order[i] = i;
  for (int i = 0; i < n_seg; ++i)
    for (int j = i + 1; j < n_seg; ++j)
      if (tab[stride * order[j] + k_col] > tab[stride * order[i] + k_col]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
}
