// The per-device dynamic shared-memory cap of a kernel, shared by the
// sources of this directory (each includes it; build.py hashes it with them).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory cap to `smem` on the current
// device when a launch needs more than 48 KB and more than that device's
// last raise. The attribute belongs to one device's context, so the raised
// caps are kept per device: caps[cudaGetDevice()].
template <typename K>
int raise_smem_cap(K kernel, size_t smem, size_t (&caps)[kMaxDevices]) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem <= caps[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  caps[dev] = smem;
  return 0;
}

}  // namespace
