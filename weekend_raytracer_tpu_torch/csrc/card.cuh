// The card's SM count, for the probe kernels that size their grid to fill
// the card (access.cu smem_rw_direct, sweep.cu dot_mma): read once per
// device, since a launch at the probes' shapes costs microseconds.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

// *sms = the current device's SMs; returns a cudaError_t.
inline cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace
