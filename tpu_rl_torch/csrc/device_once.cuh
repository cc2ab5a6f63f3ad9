// Once-per-device host setup shared by the kernel families (B1/B2, B3).
//
// cudaFuncSetAttribute applies to the current device, so a process that
// launches on more than one device must set a kernel's attributes (its
// dynamic shared memory, its non-portable cluster size) on each of them.
// once_per_device<F>() runs F once on each device it is called on (the
// current one, which the wrappers have checked is the tensors'), under a
// lock, and returns that device's result on every later call.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

template <cudaError_t (*F)()>
cudaError_t once_per_device() {
  constexpr int kMaxDevices = 64;  // devices a process tracks
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  static cudaError_t errs[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    errs[dev] = F();
    done[dev] = true;
  }
  return errs[dev];
}
