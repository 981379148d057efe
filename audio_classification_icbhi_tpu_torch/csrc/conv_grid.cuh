// The grid of a persistent fused conv-block kernel, shared by
// `fused_conv_block1.cu` and `fused_conv_packed.cu`: how many CTAs of the
// kernel fit an SM, and how many SMs the device has.

#pragma once

#include <cuda_runtime.h>

namespace {

// The CTAs of `Kernel` (launched with `threads` threads) an SM at `smem`
// dynamic bytes, and the SMs of `device`: asked of the runtime once per
// kernel, device and size (a launch of a small input costs little more than
// its kernel), the opt-in of the shared memory raised to `smem` on the way.
template <auto Kernel>
cudaError_t grid_limits(int device, int threads, size_t smem, int& per_sm, int& sms) {
  constexpr int kDevices = 64;
  static size_t known_smem[kDevices];
  static int known_per_sm[kDevices], known_sms[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (known_smem[device] != smem) {
    int optin = 0, count = 0, fit = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                             device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, Kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    known_per_sm[device] = fit;
    known_sms[device] = count;
    known_smem[device] = smem;
  }
  per_sm = known_per_sm[device];
  sms = known_sms[device];
  return cudaSuccess;
}

}  // namespace
