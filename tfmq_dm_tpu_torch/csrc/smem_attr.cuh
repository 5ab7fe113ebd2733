// The dynamic shared-memory limit of a kernel (above 48 KB only after
// cudaFuncSetAttribute), raised once per device: the attribute belongs to
// the current device's context, so a second card in the same process
// needs its own call. Each launcher keeps one SmemAttr per kernel.
#pragma once

#include <cuda_runtime.h>

namespace tfmq {

constexpr int MAX_DEVICES = 64;

struct SmemAttr {
  int bytes[MAX_DEVICES] = {};
};

// Raise `kernel`'s limit to `bytes` on the current device, unless an
// earlier call already did; returns a cudaError_t.
template <typename F>
int raise_smem(F* kernel, SmemAttr& attr, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (attr.bytes[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  attr.bytes[dev] = bytes;
  return 0;
}

}  // namespace tfmq
