// Shared helpers of the kernels: element conversions, warp
// reductions and the error codes the C entry points return besides
// cudaError_t values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked scores take a finite large negative value (as the plain
// versions do), so a row whose keys are all masked averages V instead of
// producing NaN.
constexpr float kNegInf = -1073741824.0f;  // -2**30

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// codes for arguments a kernel does not take (cudaError_t values are >= 0)
enum ArgError : int {
  kBadDType = -1,
  kBadHeadDim = -2,
  kBadGroup = -3,
  kBadShape = -4,
  kBadState = -5,
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace repro

// Text of a cudaError_t, for the Python wrapper's error messages.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
