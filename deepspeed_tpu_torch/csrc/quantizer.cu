// Group-wise symmetric int8 quantization for Hopper (sm_90a): quantize,
// dequantize, and the int8/int4 wire's unpack-dequantize.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/quantizer/quantizer.py::_quant8_kernel        (K8a)
//   deepspeed_tpu/ops/quantizer/quantizer.py::_dequant8_kernel      (K8b)
//   deepspeed_tpu/ops/quantizer/quantizer.py::_quant_pack8_kernel   (K9a)
//   deepspeed_tpu/ops/quantizer/quantizer.py::unpack_dequant_wire's
//     kernel                                                        (K10a)
// and computes, element by element, what their plain PyTorch versions in
// deepspeed_tpu_torch/ops/quantizer/quantizer.py compute, so a kernel
// agrees with its plain version (and with the JAX package) bit for bit:
//   K8a, K9a  x flattened into groups of group_size (the tail group
//             zero-padded); per group
//               scale = max|x| * fl(1/127), and 1 where that is 0;
//               q     = clip(rint(x / scale), -127, 127) as int8.
//             K9a writes the same bytes as the int8 wire.
//   K8b       out[i] = q[i] * scale[i / group_size] for the first n values,
//             cast to the output type.
//   K10a      the same after unpacking the wire: int8 is the identity;
//             int4 holds element j < group_size/2 of a group in the low
//             nibble of byte j and element j + group_size/2 in its high
//             nibble, both sign-extended.
// Rounding, as the reference's CPU arithmetic does it:
//   * the scale multiplies by the constant fl(1/127) (XLA folds the
//     reference's division by 127 into it): __fmul_rn, never __fdiv_rn;
//   * x / scale is an IEEE division (__fdiv_rn, never contracted into an
//     FMA) and __float2int_rn rounds half to even; it maps NaN to 0, so a
//     group holding a NaN (scale NaN) or an infinity (scale inf) gets q 0;
//   * the max-abs propagates NaN (fmaxf would drop it);
//   * subnormal inputs and scales are flushed to zero, explicitly (nvcc
//     keeps subnormals without -ftz);
//   * a NaN written as bfloat16 or float16 keeps its sign and becomes the
//     quiet NaN the reference's conversion writes.
//
// Design. Quantize: one warp per group (eight groups a 256-thread block)
// for group_size <= 1024, one block per group above that; the threads of a
// group read it in 16-byte vectors where it is aligned and whole (scalar
// loads otherwise, and for the tail group), reduce the max-abs with warp
// shuffles (and shared memory across the warps of a block), then read the
// group again (an L1/L2 hit) to quantize and store the int8 values. The
// group's loop strides over the grid, so any number of groups takes one
// launch. Dequantize and unpack-dequantize: one streaming pass, four
// output values a thread step, 4-byte wire loads and 8- or 16-byte stores
// where the group size allows, scalar elements otherwise.
//
// Bound on this card: bytes. K8a/K9a read the input once and write one
// byte per value plus 4 bytes per group; K8b/K10a read one byte (int4:
// half a byte) per value plus the scales and write the output type. All
// are far below the flops the card could do per byte.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr float kFltMin = 1.17549435082228750797e-38f;  // FLT_MIN
constexpr float kInv127 = 0x1.020408p-7f;                // fl(1/127)

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kFltMin ? 0.f : v;  // NaN compares false and stays
}

// max that propagates a NaN from either side
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  if (v != v) return __ushort_as_bfloat16(signbit(v) ? 0xFFC0 : 0x7FC0);
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  if (v != v) return __ushort_as_half(signbit(v) ? 0xFE00 : 0x7E00);
  return __float2half_rn(v);
}

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return (int8_t)(q > 127 ? 127 : (q < -127 ? -127 : q));
}

// ------------------------------------------------------------------------
// K8a / K9a
// ------------------------------------------------------------------------
// TPG threads quantize one group: 32 (a warp) or kThreads (the block).
template <typename T, int TPG>
__global__ void __launch_bounds__(kThreads)
quant8_kernel(const T* __restrict__ x, int64_t n, int gs, int64_t groups,
              int8_t* __restrict__ q, float* __restrict__ scales, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int GPB = kThreads / TPG;
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x % TPG;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int64_t g0 = (int64_t)blockIdx.x * GPB; g0 < groups;
       g0 += (int64_t)gridDim.x * GPB) {
    const int64_t g = g0 + threadIdx.x / TPG;
    const bool live = g < groups;  // uniform over the TPG threads
    const int64_t base = g * gs;
    const int cnt = !live ? 0 : (n - base < gs ? (int)(n - base) : gs);
    const bool whole = vec && cnt == gs;
    const T* xg = x + base;

    float amax = 0.f;
    if (whole) {
      for (int j = t * V; j < gs; j += TPG * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xg + j);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k)
          amax = nanmax(amax, fabsf(ftz(to_f32(e[k]))));
      }
    } else {
      for (int j = t; j < cnt; j += TPG)
        amax = nanmax(amax, fabsf(ftz(to_f32(xg[j]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (TPG > 32) {
      if (lane == 0) red[warp] = amax;
      __syncthreads();
      amax = red[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) amax = nanmax(amax, red[w]);
      __syncthreads();  // red is written again by the next group
    }
    float scale = ftz(__fmul_rn(amax, kInv127));
    if (scale == 0.f) scale = 1.f;
    if (!live) continue;

    int8_t* qg = q + base;
    if (whole) {
      for (int j = t * V; j < gs; j += TPG * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xg + j);
        const T* e = reinterpret_cast<const T*>(&raw);
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < V; ++k)
          word[k / 4] |= (uint32_t)(uint8_t)quant(ftz(to_f32(e[k])), scale)
                         << (8 * (k % 4));
        if (V == 8)
          *reinterpret_cast<uint2*>(qg + j) = make_uint2(word[0], word[1]);
        else
          *reinterpret_cast<uint32_t*>(qg + j) = word[0];
      }
    } else {
      for (int j = t; j < gs; j += TPG)
        qg[j] = quant(j < cnt ? ftz(to_f32(xg[j])) : 0.f, scale);
    }
    if (t == 0) scales[g] = scale;
  }
}

template <typename T>
int launch_quant8(const void* x, int64_t n, int gs, int64_t groups, void* q,
                  void* scales, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && gs % V == 0;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (gs <= 1024) {
    const int64_t want = (groups + kThreads / 32 - 1) / (kThreads / 32);
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    quant8_kernel<T, 32><<<blocks, kThreads, 0, stream>>>(xp, n, gs, groups,
                                                          qp, sp, vec);
  } else {
    const int blocks = (int)(groups < kMaxBlocks ? groups : kMaxBlocks);
    quant8_kernel<T, kThreads><<<blocks, kThreads, 0, stream>>>(
        xp, n, gs, groups, qp, sp, vec);
  }
  return (int)cudaGetLastError();
}

int quant8(const void* x, long long n, int gs, long long groups, void* q,
           void* scales, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_quant8<float>(x, n, gs, groups, q, scales, st);
    case kBF16:
      return launch_quant8<__nv_bfloat16>(x, n, gs, groups, q, scales, st);
    case kF16: return launch_quant8<__half>(x, n, gs, groups, q, scales, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------
// K8b / K10a
// ------------------------------------------------------------------------
// Value j of a group from its wire bytes wg (BITS 8: one byte a value;
// BITS 4: half-split nibbles, half = group_size / 2).
template <int BITS>
__device__ __forceinline__ int wire_value(const int8_t* wg, int j, int half) {
  if (BITS == 8) return wg[j];
  return j < half ? (int)(int8_t)(wg[j] << 4) >> 4 : wg[j - half] >> 4;
}

template <int BITS, typename Out>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ w, const float* __restrict__ scales,
               int gs, int64_t n, Out* __restrict__ out, int vec) {
  const int W = BITS == 8 ? gs : gs / 2;
  const int half = gs / 2;
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t c = tid; c < n4; c += stride) {
    // four values of one group (and of one half of it for int4)
    const int64_t i = c * 4;
    const int64_t g = i / gs;
    const int j = (int)(i - g * gs);
    const float scale = ftz(scales[g]);
    const int8_t* wg = w + g * W;
    const int off = BITS == 8 ? j : (j < half ? j : j - half);
    const uint32_t word = *reinterpret_cast<const uint32_t*>(wg + off);
    alignas(16) Out o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int8_t b = (int8_t)(word >> (8 * k));
      const int v = BITS == 8 ? b : (j < half ? (int)(int8_t)(b << 4) >> 4
                                              : b >> 4);
      o[k] = from_f32<Out>(__fmul_rn((float)v, scale));
    }
    if (sizeof(Out) == 4)
      *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<uint4*>(o);
    else
      *reinterpret_cast<uint2*>(out + i) = *reinterpret_cast<uint2*>(o);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const int64_t g = i / gs;
    const int j = (int)(i - g * gs);
    const float v = (float)wire_value<BITS>(w + g * W, j, half);
    out[i] = from_f32<Out>(__fmul_rn(v, ftz(scales[g])));
  }
}

template <int BITS, typename Out>
int launch_dequant(const void* w, const void* scales, int gs, int64_t n,
                   void* out, cudaStream_t stream) {
  // four values of a step share a group (and an int4 half) and a 4-byte
  // aligned wire word when group_size (half) is a multiple of 4
  const int vec = BITS == 8 ? gs % 4 == 0 : gs % 8 == 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1)
                                             : kMaxBlocks);
  dequant_kernel<BITS, Out><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(w), static_cast<const float*>(scales), gs, n,
      static_cast<Out*>(out), vec);
  return (int)cudaGetLastError();
}

template <int BITS>
int dequant(const void* w, const void* scales, int gs, long long n,
            void* out, int dtype, cudaStream_t st) {
  switch (dtype) {
    case kF32: return launch_dequant<BITS, float>(w, scales, gs, n, out, st);
    case kBF16:
      return launch_dequant<BITS, __nv_bfloat16>(w, scales, gs, n, out, st);
    case kF16: return launch_dequant<BITS, __half>(w, scales, gs, n, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dstorch

// x [n] (float32, bfloat16 or float16; flattened) → q int8 [groups, gs],
// scales float32 [groups]; groups = ceil(n / gs). Returns the cudaError_t of
// the launch.
extern "C" int quantize_int8_launch(const void* x, long long n, int gs,
                                    long long groups, void* q, void* scales,
                                    int dtype, void* stream) {
  return dstorch::quant8(x, n, gs, groups, q, scales, dtype, stream);
}

// K9a: the same bytes, as the int8 wire.
extern "C" int quant_pack_wire8_launch(const void* x, long long n, int gs,
                                       long long groups, void* w,
                                       void* scales, int dtype,
                                       void* stream) {
  return dstorch::quant8(x, n, gs, groups, w, scales, dtype, stream);
}

// q int8 [groups, gs], scales float32 [groups] → out [n] (n <= groups * gs)
// in float32, bfloat16 or float16.
extern "C" int dequantize_int8_launch(const void* q, const void* scales,
                                      int gs, long long n, void* out,
                                      int dtype, void* stream) {
  return dstorch::dequant<8>(q, scales, gs, n, out, dtype,
                             static_cast<cudaStream_t>(stream));
}

// wire int8 [groups, bits == 8 ? gs : gs / 2], scales float32 [groups] →
// out [n] (n <= groups * gs).
extern "C" int unpack_dequant_wire_launch(const void* w, const void* scales,
                                          int bits, int gs, long long n,
                                          void* out, int dtype,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) return dstorch::dequant<8>(w, scales, gs, n, out, dtype, st);
  if (bits == 4) return dstorch::dequant<4>(w, scales, gs, n, out, dtype, st);
  return (int)cudaErrorInvalidValue;
}
