// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masking constant, packed-element access for fp32 and bf16, and warp
// reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, as in ops/attention.py
constexpr unsigned FULL = 0xffffffffu;

// A 32-bit word holds 1 float or 2 bf16 (element 2i in the low half).
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static uint32_t pack(const float* x) { return __float_as_uint(x[0]); }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static uint32_t pack(const float* x) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[0], x[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
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
