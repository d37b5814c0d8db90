// Group-wise symmetric int8/int4 quantization for Hopper (sm_90a):
// quantize, dequantize, the int8/int4 wire's quantize-pack and
// unpack-dequantize, and the dequantize-mean of the quantized
// reduce-scatter.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/quantizer/quantizer.py::_quant8_kernel        (K8a)
//   deepspeed_tpu/ops/quantizer/quantizer.py::_dequant8_kernel      (K8b)
//   deepspeed_tpu/ops/quantizer/quantizer.py::_quant_pack8_kernel   (K9a)
//   deepspeed_tpu/ops/quantizer/quantizer.py::_quant_pack4_kernel   (K9b)
//   deepspeed_tpu/ops/quantizer/quantizer.py::unpack_dequant_wire's
//     kernel                                                        (K10a)
//   deepspeed_tpu/ops/quantizer/quantizer.py::unpack_dequant_mean's
//     kernel                                                        (K10b)
// and, as a variant of K10a, the residual x - unpack_dequant_wire(w, s)
// that LoCo's error feedback takes of what went on the wire (the
// reference's unpack_dequant_wire followed by the subtraction XLA fuses
// into it),
// and computes, element by element, what their plain PyTorch versions in
// deepspeed_tpu_torch/ops/quantizer/quantizer.py compute, so a kernel
// agrees with its plain version (and with the JAX package) bit for bit:
//   K8a, K9a  x flattened into groups of group_size (the tail group
//             zero-padded); per group
//               scale = max|x| * fl(1/127), and 1 where that is 0;
//               q     = clip(rint(x / scale), -127, 127) as int8.
//             K9a writes the same bytes as the int8 wire.
//   K9b       the same with 7 for 127 (scale max|x| * fl(1/7), clip
//             +-7), packed half-split: byte j < group_size/2 of a group
//             holds q[j] in its low nibble and q[j + group_size/2] in
//             its high nibble.
//   K8b       out[i] = q[i] * scale[i / group_size] for the first n values,
//             cast to the output type.
//   K10a      the same after unpacking the wire: int8 is the identity;
//             int4 holds element j < group_size/2 of a group in the low
//             nibble of byte j and element j + group_size/2 in its high
//             nibble, both sign-extended.
//   residual  K10a's unpacked value q and flushed scale s of each element,
//             and x float32 of the wire's groups * group_size values:
//               out = fma(-q, s, x), a subnormal out flushed to the zero
//             of its sign, float32: the reference's
//             x - unpack_dequant_wire(w, s) compiles (XLA on the CPU) to
//             that one rounding and the CPU's flush of its result.
//   K10b      n peers' wires [n, groups, W] and scales [n, groups]:
//               acc = q_0 * s_0; acc = fma(q_r, s_r, acc) for r = 1..n-1;
//               out = acc * fl(1/n)       (or fma(acc, fl(1/n), add[i]))
//             float32 [groups * group_size]. The reference's
//             sum(axis=0) / n compiles (XLA on the CPU) to exactly that:
//             the peers in order, each product fused into its add, and the
//             division turned into a multiply by fl(1/n) (measured against
//             interpret mode at n = 2, 3, 4, 5; bit for bit). With LoCo the
//             reference adds its server residual to the mean, and XLA fuses
//             that add into the multiply: the optional add does the same.
// Rounding, as the reference's CPU arithmetic does it:
//   * the scale multiplies by the constant fl(1/127) or fl(1/7) (XLA folds
//     the reference's division by the constant into it): __fmul_rn, never
//     __fdiv_rn;
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
// launch. K9b packs four bytes a thread step (elements j..j+3 and
// j+half..j+half+3, one 4-byte store) where the group is whole and half a
// multiple of 4. Dequantize, unpack-dequantize and dequantize-mean: one
// streaming pass, four output values a thread step, 4-byte wire loads
// (one per peer for K10b) and 8- or 16-byte stores where the group size
// allows, scalar elements otherwise.
//
// Bound on this card: bytes. K8a/K9a/K9b read the input once and write one
// byte (int4: half a byte) per value plus 4 bytes per group; K8b/K10a read
// one byte (int4: half a byte) per value plus the scales and write the
// output type (the residual also reads x and writes float32); K10b reads
// n peers' wires and scales and writes float32 once. All are far below
// the flops the card could do per byte.
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
constexpr float kInv7 = 0x1.24924ap-3f;                  // fl(1/7)

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kFltMin ? 0.f : v;  // NaN compares false and stays
}

// subnormal → the zero of its sign (the CPU's flush of a result)
__device__ __forceinline__ float ftz_signed(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.f, v) : v;
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

template <int QMAX>
__device__ __forceinline__ int8_t quant(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return (int8_t)(q > QMAX ? QMAX : (q < -QMAX ? -QMAX : q));
}

// Four elements of T from 4 * sizeof(T) aligned bytes.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&f)[4]) {
  if constexpr (sizeof(T) == 4) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = to_f32(e[k]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = to_f32(e[k]);
  }
}

__device__ __forceinline__ uint8_t nibbles(int8_t lo, int8_t hi) {
  return (uint8_t)((lo & 0x0F) | ((hi & 0x0F) << 4));
}

// ------------------------------------------------------------------------
// K8a / K9a / K9b
// ------------------------------------------------------------------------
// TPG threads quantize one group: 32 (a warp) or kThreads (the block).
// BITS 8 writes q [groups, gs]; BITS 4 the half-split wire [groups, gs/2].
template <typename T, int TPG, int BITS>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, int64_t n, int gs, int64_t groups,
             int8_t* __restrict__ q, float* __restrict__ scales, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int QMAX = BITS == 8 ? 127 : 7;
  constexpr float INV = BITS == 8 ? kInv127 : kInv7;
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
    float scale = ftz(__fmul_rn(amax, INV));
    if (scale == 0.f) scale = 1.f;
    if (!live) continue;

    if constexpr (BITS == 4) {
      const int half = gs / 2;
      int8_t* wg = q + g * half;
      if (whole && half % 4 == 0) {
        for (int j = t * 4; j < half; j += TPG * 4) {
          float lo[4], hi[4];
          load4(xg + j, lo);
          load4(xg + j + half, hi);
          uint32_t word = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            word |= (uint32_t)nibbles(quant<QMAX>(ftz(lo[k]), scale),
                                      quant<QMAX>(ftz(hi[k]), scale))
                    << (8 * k);
          *reinterpret_cast<uint32_t*>(wg + j) = word;
        }
      } else {
        for (int j = t; j < half; j += TPG) {
          const float lo = j < cnt ? ftz(to_f32(xg[j])) : 0.f;
          const float hi = j + half < cnt ? ftz(to_f32(xg[j + half])) : 0.f;
          wg[j] = (int8_t)nibbles(quant<QMAX>(lo, scale),
                                  quant<QMAX>(hi, scale));
        }
      }
      if (t == 0) scales[g] = scale;
      continue;
    }

    int8_t* qg = q + base;
    if (whole) {
      for (int j = t * V; j < gs; j += TPG * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xg + j);
        const T* e = reinterpret_cast<const T*>(&raw);
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < V; ++k)
          word[k / 4] |=
              (uint32_t)(uint8_t)quant<QMAX>(ftz(to_f32(e[k])), scale)
              << (8 * (k % 4));
        if (V == 8)
          *reinterpret_cast<uint2*>(qg + j) = make_uint2(word[0], word[1]);
        else
          *reinterpret_cast<uint32_t*>(qg + j) = word[0];
      }
    } else {
      for (int j = t; j < gs; j += TPG)
        qg[j] = quant<QMAX>(j < cnt ? ftz(to_f32(xg[j])) : 0.f, scale);
    }
    if (t == 0) scales[g] = scale;
  }
}

template <typename T, int BITS>
int launch_quant(const void* x, int64_t n, int gs, int64_t groups, void* q,
                 void* scales, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && gs % V == 0;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (gs <= 1024) {
    const int64_t want = (groups + kThreads / 32 - 1) / (kThreads / 32);
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    quant_kernel<T, 32, BITS><<<blocks, kThreads, 0, stream>>>(
        xp, n, gs, groups, qp, sp, vec);
  } else {
    const int blocks = (int)(groups < kMaxBlocks ? groups : kMaxBlocks);
    quant_kernel<T, kThreads, BITS><<<blocks, kThreads, 0, stream>>>(
        xp, n, gs, groups, qp, sp, vec);
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int quant_launch(const void* x, long long n, int gs, long long groups,
                 void* q, void* scales, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BITS == 4 && gs % 2) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_quant<float, BITS>(x, n, gs, groups, q, scales, st);
    case kBF16:
      return launch_quant<__nv_bfloat16, BITS>(x, n, gs, groups, q, scales,
                                               st);
    case kF16:
      return launch_quant<__half, BITS>(x, n, gs, groups, q, scales, st);
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

// RES: out = fma(-q, s, x) (the residual, Out float), else q * s.
template <int BITS, typename Out, bool RES>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ w, const float* __restrict__ scales,
               int gs, int64_t n, const float* __restrict__ x,
               Out* __restrict__ out, int vec) {
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
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (RES) {
      const float4 a = *reinterpret_cast<const float4*>(x + i);
      xv[0] = a.x; xv[1] = a.y; xv[2] = a.z; xv[3] = a.w;
    }
    alignas(16) Out o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int8_t b = (int8_t)(word >> (8 * k));
      const int v = BITS == 8 ? b : (j < half ? (int)(int8_t)(b << 4) >> 4
                                              : b >> 4);
      if constexpr (RES)
        o[k] = ftz_signed(__fmaf_rn(-(float)v, scale, xv[k]));
      else
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
    if constexpr (RES)
      out[i] = ftz_signed(__fmaf_rn(-v, ftz(scales[g]), x[i]));
    else
      out[i] = from_f32<Out>(__fmul_rn(v, ftz(scales[g])));
  }
}

template <int BITS, typename Out, bool RES = false>
int launch_dequant(const void* w, const void* scales, int gs, int64_t n,
                   void* out, cudaStream_t stream, const void* x = nullptr) {
  // four values of a step share a group (and an int4 half) and a 4-byte
  // aligned wire word when group_size (half) is a multiple of 4; the
  // residual reads x in 16-byte vectors where it is so aligned
  const int vec = (BITS == 8 ? gs % 4 == 0 : gs % 8 == 0) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1)
                                             : kMaxBlocks);
  dequant_kernel<BITS, Out, RES><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(w), static_cast<const float*>(scales), gs, n,
      static_cast<const float*>(x), static_cast<Out*>(out), vec);
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

// ------------------------------------------------------------------------
// K10b
// ------------------------------------------------------------------------
template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_mean_kernel(const int8_t* __restrict__ w,
                    const float* __restrict__ scales, int npeers,
                    int64_t groups, int gs, float inv_n,
                    const float* __restrict__ add, float* __restrict__ out,
                    int vec) {
  const int W = BITS == 8 ? gs : gs / 2;
  const int half = gs / 2;
  const int64_t n = groups * gs;
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t peer_w = groups * W;  // wire bytes of one peer
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t c = tid; c < n4; c += stride) {
    const int64_t i = c * 4;
    const int64_t g = i / gs;
    const int j = (int)(i - g * gs);
    const int off = BITS == 8 ? j : (j < half ? j : j - half);
    float acc[4];
    for (int r = 0; r < npeers; ++r) {
      const float s = ftz(scales[r * groups + g]);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          w + r * peer_w + g * W + off);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int8_t b = (int8_t)(word >> (8 * k));
        const float v = (float)(BITS == 8 ? b
                                          : (j < half ? (int)(int8_t)(b << 4) >> 4
                                                      : b >> 4));
        acc[k] = ftz(r == 0 ? __fmul_rn(v, s) : __fmaf_rn(v, s, acc[k]));
      }
    }
    float o[4];
    if (add) {
      const float4 a = *reinterpret_cast<const float4*>(add + i);
      o[0] = __fmaf_rn(acc[0], inv_n, a.x);
      o[1] = __fmaf_rn(acc[1], inv_n, a.y);
      o[2] = __fmaf_rn(acc[2], inv_n, a.z);
      o[3] = __fmaf_rn(acc[3], inv_n, a.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = __fmul_rn(acc[k], inv_n);
    }
    *reinterpret_cast<float4*>(out + i) =
        make_float4(ftz(o[0]), ftz(o[1]), ftz(o[2]), ftz(o[3]));
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const int64_t g = i / gs;
    const int j = (int)(i - g * gs);
    float acc = 0.f;
    for (int r = 0; r < npeers; ++r) {
      const float s = ftz(scales[r * groups + g]);
      const float v = (float)wire_value<BITS>(w + r * peer_w + g * W, j, half);
      acc = ftz(r == 0 ? __fmul_rn(v, s) : __fmaf_rn(v, s, acc));
    }
    out[i] = ftz(add ? __fmaf_rn(acc, inv_n, add[i]) : __fmul_rn(acc, inv_n));
  }
}

template <int BITS>
int dequant_mean(const void* w, const void* scales, int npeers,
                 long long groups, int gs, float inv_n, const void* add,
                 void* out, cudaStream_t stream) {
  // four values of a step share a group (and an int4 half) and a 4-byte
  // aligned wire word when group_size (half) is a multiple of 4
  const int vec = BITS == 8 ? gs % 4 == 0 : gs % 8 == 0;
  const int64_t n = (int64_t)groups * gs;
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1)
                                             : kMaxBlocks);
  dequant_mean_kernel<BITS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(w), static_cast<const float*>(scales), npeers,
      groups, gs, inv_n, static_cast<const float*>(add),
      static_cast<float*>(out), vec);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// x [n] (float32, bfloat16 or float16; flattened) → q int8 [groups, gs],
// scales float32 [groups]; groups = ceil(n / gs). Returns the cudaError_t of
// the launch.
extern "C" int quantize_int8_launch(const void* x, long long n, int gs,
                                    long long groups, void* q, void* scales,
                                    int dtype, void* stream) {
  return dstorch::quant_launch<8>(x, n, gs, groups, q, scales, dtype, stream);
}

// K9a: the same bytes, as the int8 wire.
extern "C" int quant_pack_wire8_launch(const void* x, long long n, int gs,
                                       long long groups, void* w,
                                       void* scales, int dtype,
                                       void* stream) {
  return dstorch::quant_launch<8>(x, n, gs, groups, w, scales, dtype, stream);
}

// K9b: x [n] → the int4 wire [groups, gs / 2] (half-split nibbles),
// scales float32 [groups]; gs even.
extern "C" int quant_pack_wire4_launch(const void* x, long long n, int gs,
                                       long long groups, void* w,
                                       void* scales, int dtype,
                                       void* stream) {
  return dstorch::quant_launch<4>(x, n, gs, groups, w, scales, dtype, stream);
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

// K10a's residual: x float32 [n] and wire int8 [groups, bits == 8 ? gs :
// gs / 2], scales float32 [groups] → out float32 [n], fma(-q, s, x) per
// element (n == groups * gs).
extern "C" int wire_residual_launch(const void* x, const void* w,
                                    const void* scales, int bits, int gs,
                                    long long n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return dstorch::launch_dequant<8, float, true>(w, scales, gs, n, out, st,
                                                   x);
  if (bits == 4)
    return dstorch::launch_dequant<4, float, true>(w, scales, gs, n, out, st,
                                                   x);
  return (int)cudaErrorInvalidValue;
}

// K10b: wire int8 [npeers, groups, bits == 8 ? gs : gs / 2], scales float32
// [npeers, groups] → out float32 [groups * gs], the peers' dequantized
// values summed in peer order (each product fused into its add) and
// multiplied by inv_n = fl(1/npeers); add (float32 [groups * gs], or null)
// is added in the same rounding.
extern "C" int unpack_dequant_mean_launch(const void* w, const void* scales,
                                          int bits, int npeers,
                                          long long groups, int gs,
                                          float inv_n, const void* add,
                                          void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npeers < 1) return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return dstorch::dequant_mean<8>(w, scales, npeers, groups, gs, inv_n, add,
                                    out, st);
  if (bits == 4)
    return dstorch::dequant_mean<4>(w, scales, npeers, groups, gs, inv_n, add,
                                    out, st);
  return (int)cudaErrorInvalidValue;
}
