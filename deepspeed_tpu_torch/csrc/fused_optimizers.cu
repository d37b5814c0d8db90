// Fused optimizer updates for Hopper (sm_90a): Adam/AdamW, LAMB's raw
// update, Lion and Adagrad, each one streaming pass over one parameter
// tensor, updated in place.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/adam/fused_adam.py::_adam_kernel     (K5)
//   deepspeed_tpu/ops/lamb/fused_lamb.py::_lamb_raw_kernel (K13)
//   deepspeed_tpu/ops/adam/fused_adam.py::_lion_kernel     (K14)
//   deepspeed_tpu/ops/adam/fused_adam.py::_adagrad_kernel  (K15)
// and computes, element by element, what their plain PyTorch versions in
// deepspeed_tpu_torch/ops/{adam/fused_adam,lamb/fused_lamb}.py compute:
//   K5   [g += wd*p]  m = b1*m + (1-b1)*g   v = b2*v + ((1-b2)*g)*g
//        u = (m/bc1) / (sqrt(v/bc2) + eps)  [u += wd*p]   p -= lr*u
//   K13  m, v and u as K5 (L2 decay never; decoupled wd when wd != 0);
//        u is written out, p is read only (the trust ratio comes after)
//   K14  u = sign(b1*m + (1-b1)*g) + wd*p   p -= lr*u
//        m = b2*m + (1-b2)*g
//   K15  [g += wd*p]  a += g*g   p -= (lr*g) / (sqrt(a) + eps)
// All arrays are float32 and contiguous. Every product, sum, quotient and
// square root is rounded once, in the plain version's order: the kernels
// use the __f*_rn intrinsics, which nvcc never contracts into an FMA, so
// a kernel agrees with its plain version bit for bit (IEEE division and
// square root are nvcc's defaults without --use_fast_math).
//
// Design. Each element is independent, so a thread takes 16-byte float4
// vectors in a grid-stride loop: one read of p, g and each state array and
// one write of each array it updates, nothing kept between elements. The
// last n % 4 elements are taken by the first threads of block 0 with
// scalar loads (masked, never padded). lr, the bias corrections bc1 = 1 -
// b1^(t) and bc2 = 1 - b2^(t) (computed in float32 by the wrapper, as the
// reference computes them) and the betas come in as float arguments, so a
// schedule never rebuilds anything.
//
// Bound on this card: bytes. K5 moves 28 bytes per parameter (reads p, g,
// m, v; writes p, m, v), K13 28 (reads p, g, m, v; writes u, m, v), K14
// and K15 20 (reads p, g, state; writes p, state), at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }

// jnp.sign / torch.sign: -1, 0 or 1 (NaN stays NaN).
__device__ __forceinline__ float sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

struct AdamArgs {
  float b1, b2, omb1, omb2, eps, wd, lr, bc1, bc2;
  int adam_w_mode;  // 1: decoupled weight decay (AdamW); 0: L2 added to g
};

// One element of K5; p, m, v in place.
__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamArgs& a) {
  if (a.wd != 0.f && !a.adam_w_mode) g = add(g, mul(a.wd, p));
  m = add(mul(a.b1, m), mul(a.omb1, g));
  v = add(mul(a.b2, v), mul(mul(a.omb2, g), g));
  float u = dvd(dvd(m, a.bc1), add(sqr(dvd(v, a.bc2)), a.eps));
  if (a.wd != 0.f && a.adam_w_mode) u = add(u, mul(a.wd, p));
  p = sub(p, mul(a.lr, u));
}

// One element of K13: m, v in place; u out; p is read only.
__device__ __forceinline__ float lamb_one(float p, float g, float& m,
                                          float& v, const AdamArgs& a) {
  m = add(mul(a.b1, m), mul(a.omb1, g));
  v = add(mul(a.b2, v), mul(mul(a.omb2, g), g));
  float u = dvd(dvd(m, a.bc1), add(sqr(dvd(v, a.bc2)), a.eps));
  if (a.wd != 0.f) u = add(u, mul(a.wd, p));
  return u;
}

struct LionArgs {
  float b1, b2, omb1, omb2, wd, lr;
};

__device__ __forceinline__ void lion_one(float& p, float g, float& m,
                                         const LionArgs& a) {
  const float u = add(sign(add(mul(a.b1, m), mul(a.omb1, g))), mul(a.wd, p));
  p = sub(p, mul(a.lr, u));
  m = add(mul(a.b2, m), mul(a.omb2, g));
}

struct AdagradArgs {
  float eps, wd, lr;
};

__device__ __forceinline__ void adagrad_one(float& p, float g, float& acc,
                                            const AdagradArgs& a) {
  if (a.wd != 0.f) g = add(g, mul(a.wd, p));
  acc = add(acc, mul(g, g));
  p = sub(p, dvd(mul(a.lr, g), add(sqr(acc), a.eps)));
}

// The vector loop and the masked scalar tail, shared by the four kernels:
// vec(i) updates float4 vector i, one(i) updates element i.
template <typename Vec, typename One>
__device__ __forceinline__ void stream(int64_t n, Vec vec, One one) {
  const int64_t n4 = n >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    vec(i);
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) one((n4 << 2) + threadIdx.x);
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, int64_t n,
            AdamArgs a) {
  stream(
      n,
      [&](int64_t i) {
        float4 P = reinterpret_cast<float4*>(p)[i];
        const float4 G = reinterpret_cast<const float4*>(g)[i];
        float4 M = reinterpret_cast<float4*>(m)[i];
        float4 V = reinterpret_cast<float4*>(v)[i];
        adam_one(P.x, G.x, M.x, V.x, a);
        adam_one(P.y, G.y, M.y, V.y, a);
        adam_one(P.z, G.z, M.z, V.z, a);
        adam_one(P.w, G.w, M.w, V.w, a);
        reinterpret_cast<float4*>(p)[i] = P;
        reinterpret_cast<float4*>(m)[i] = M;
        reinterpret_cast<float4*>(v)[i] = V;
      },
      [&](int64_t i) { adam_one(p[i], g[i], m[i], v[i], a); });
}

__global__ void __launch_bounds__(kThreads)
lamb_kernel(const float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            float* __restrict__ u, int64_t n, AdamArgs a) {
  stream(
      n,
      [&](int64_t i) {
        const float4 P = reinterpret_cast<const float4*>(p)[i];
        const float4 G = reinterpret_cast<const float4*>(g)[i];
        float4 M = reinterpret_cast<float4*>(m)[i];
        float4 V = reinterpret_cast<float4*>(v)[i];
        float4 U;
        U.x = lamb_one(P.x, G.x, M.x, V.x, a);
        U.y = lamb_one(P.y, G.y, M.y, V.y, a);
        U.z = lamb_one(P.z, G.z, M.z, V.z, a);
        U.w = lamb_one(P.w, G.w, M.w, V.w, a);
        reinterpret_cast<float4*>(m)[i] = M;
        reinterpret_cast<float4*>(v)[i] = V;
        reinterpret_cast<float4*>(u)[i] = U;
      },
      [&](int64_t i) { u[i] = lamb_one(p[i], g[i], m[i], v[i], a); });
}

__global__ void __launch_bounds__(kThreads)
lion_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, int64_t n, LionArgs a) {
  stream(
      n,
      [&](int64_t i) {
        float4 P = reinterpret_cast<float4*>(p)[i];
        const float4 G = reinterpret_cast<const float4*>(g)[i];
        float4 M = reinterpret_cast<float4*>(m)[i];
        lion_one(P.x, G.x, M.x, a);
        lion_one(P.y, G.y, M.y, a);
        lion_one(P.z, G.z, M.z, a);
        lion_one(P.w, G.w, M.w, a);
        reinterpret_cast<float4*>(p)[i] = P;
        reinterpret_cast<float4*>(m)[i] = M;
      },
      [&](int64_t i) { lion_one(p[i], g[i], m[i], a); });
}

__global__ void __launch_bounds__(kThreads)
adagrad_kernel(float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ acc, int64_t n, AdagradArgs a) {
  stream(
      n,
      [&](int64_t i) {
        float4 P = reinterpret_cast<float4*>(p)[i];
        const float4 G = reinterpret_cast<const float4*>(g)[i];
        float4 A = reinterpret_cast<float4*>(acc)[i];
        adagrad_one(P.x, G.x, A.x, a);
        adagrad_one(P.y, G.y, A.y, a);
        adagrad_one(P.z, G.z, A.z, a);
        adagrad_one(P.w, G.w, A.w, a);
        reinterpret_cast<float4*>(p)[i] = P;
        reinterpret_cast<float4*>(acc)[i] = A;
      },
      [&](int64_t i) { adagrad_one(p[i], g[i], acc[i], a); });
}

int blocks_for(int64_t n) {
  const int64_t n4 = n >> 2;
  int64_t b = (n4 + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace
}  // namespace dstorch

using namespace dstorch;

extern "C" int fused_adam_launch(void* p, const void* g, void* m, void* v,
                                 long long n, float b1, float b2, float omb1,
                                 float omb2, float eps, float wd, float lr,
                                 float bc1, float bc2, int adam_w_mode,
                                 void* stream) {
  if (n <= 0) return 0;
  if (!aligned(p) || !aligned(g) || !aligned(m) || !aligned(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const AdamArgs a{b1, b2, omb1, omb2, eps, wd, lr, bc1, bc2, adam_w_mode};
  adam_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_lamb_launch(const void* p, const void* g, void* m,
                                 void* v, void* u, long long n, float b1,
                                 float b2, float omb1, float omb2, float eps,
                                 float wd, float bc1, float bc2,
                                 void* stream) {
  if (n <= 0) return 0;
  if (!aligned(p) || !aligned(g) || !aligned(m) || !aligned(v) || !aligned(u))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const AdamArgs a{b1, b2, omb1, omb2, eps, wd, 0.f, bc1, bc2, 1};
  lamb_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(u),
      n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_lion_launch(void* p, const void* g, void* m, long long n,
                                 float b1, float b2, float omb1, float omb2,
                                 float wd, float lr, void* stream) {
  if (n <= 0) return 0;
  if (!aligned(p) || !aligned(g) || !aligned(m))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const LionArgs a{b1, b2, omb1, omb2, wd, lr};
  lion_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), n, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_adagrad_launch(void* p, const void* g, void* acc,
                                    long long n, float eps, float wd,
                                    float lr, void* stream) {
  if (n <= 0) return 0;
  if (!aligned(p) || !aligned(g) || !aligned(acc))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const AdagradArgs a{eps, wd, lr};
  adagrad_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(acc), n, a);
  return static_cast<int>(cudaGetLastError());
}
