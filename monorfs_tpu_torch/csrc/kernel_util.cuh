// Shared by the launchers of csrc/.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

// Raise a kernel's dynamic shared-memory limit with cudaFuncSetAttribute once
// per device and size, not on every launch: the largest size configured so
// far on a device covers every smaller launch there. done: one counter per
// device, owned by the kernel's translation unit.
constexpr int kMaxDevices = 64;

inline cudaError_t allow_smem(const void* kernel, std::atomic<size_t>* done, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || dev >= kMaxDevices) return err;
  size_t seen = done[dev].load();
  while (seen < smem && !done[dev].compare_exchange_weak(seen, smem)) {
  }
  return cudaSuccess;
}
