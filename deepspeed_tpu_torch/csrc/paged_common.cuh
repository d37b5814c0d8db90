// Helpers shared by the paged-attention kernels of the PyTorch port.
//
// Page pool layout (deepspeed_tpu_torch/inference/v2/ragged/kv_cache.py):
//   pages[num_pages, page_size, 2*KV, hd]; K heads at [:KV], V heads at [KV:].
// Element types: float32 or bfloat16 (dtype code kF32 / kBF16); scores,
// softmax state and accumulators are float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {

// Masked score value; the same finite "minus infinity" the JAX kernels use,
// so exp(m_prev - m_new) never evaluates (-inf) - (-inf).
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as float4. The pointer must be aligned to four
// elements (16 bytes for float32, 8 for bfloat16); the wrappers check the
// base pointers, and every row offset is a multiple of hd (64 or 128).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace dstorch
