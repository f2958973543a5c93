// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masking constant, fp32 element access through 32-bit words, and
// warp reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, as in ops/attention.py
constexpr unsigned FULL = 0xffffffffu;

// A 32-bit word holds one float (the CUDA-core kernels are float-only).
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static uint32_t pack(const float* x) { return __float_as_uint(x[0]); }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Above 48 KB, dynamic shared memory must be opted into, once per device
// and kernel.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, bool* opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace rtt
