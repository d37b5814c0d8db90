// Fused RMSNorm + matmul for Hopper (sm_90a): y = rms_norm(x, scale) @ w.
//
// Replaces the TPU kernel
//   deepspeed_tpu/kernels/fused_collective_matmul.py::_rmsnorm_matmul_kernel
// (driven by rmsnorm_matmul). It computes the reference composition
// (rmsnorm_matmul_reference, models/transformer.py rms_norm) with the same
// roundings, element by element:
//     r = rsqrt(mean(x^2) + eps)     float32 over the whole row
//     h = ((x * T(r)) rounded to T) * scale, rounded to T
//     y = h @ w                      float32 sums, rounded to T once
// T is the element type of x, scale, w and y (float32 or bfloat16); for
// float32 every rounding is the identity. x [M, D], scale [D], w [D, F],
// y [M, F], all row-major; D and F multiples of 8.
//
// Design. A block of 8 warps owns a 128 x 128 tile of y. It first computes
// the normaliser of each of its 128 rows over the full D (once per row
// tile, not once per k-step), then walks D in steps of 32: the x step is
// normalised and scaled while it is staged into shared memory, so the
// normalised activations never exist in device memory; the w step is
// staged as it is. Each warp accumulates a 64 x 32 sub-tile with the
// tensor cores (mma.sync m16n8k16, bfloat16 in, float32 sums; exact
// float32 FMAs for float32 inputs). The next step's global loads are issued
// into registers before the current step's products. Rows past M and
// columns past F are zero-filled on load and never stored. Blocks are
// ordered in groups of 8 row tiles so that the tiles of x and w in flight
// stay in the 50 MB L2.
//
// Bound on this card: operations, 2*M*D*F flops at 989 TFLOP/s dense
// bfloat16 (the projections of the main path are far above the card's
// ~295 flops per byte). Left on the table: wgmma with TMA-fed multi-stage
// pipelines, ldmatrix fragment loads, a persistent tile scheduler.
#include "tile_mma.cuh"

namespace dstorch {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kGroupM = 8;

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of T as floats.
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ w, T* __restrict__ y, int M,
                      int D, int F, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LDA = kBK + kPad<T>;
  constexpr int LDB = kBN + kPad<T>;
  constexpr int XV = kBM * kBK / VEC / kThreads;   // x vectors per thread
  constexpr int WV = kBK * kBN / VEC / kThreads;   // w vectors per thread
  __shared__ __align__(16) T Hs[kBM * LDA];
  __shared__ __align__(16) T Ws[kBK * LDB];
  __shared__ float rs[kBM];

  // grouped raster: kGroupM row tiles share each column sweep
  const int num_m = (M + kBM - 1) / kBM, num_n = (F + kBN - 1) / kBN;
  const int pid = blockIdx.x;
  const int per_group = kGroupM * num_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int gsize = min(num_m - first_m, kGroupM);
  const int m0 = (first_m + (pid % per_group) % gsize) * kBM;
  const int n0 = ((pid % per_group) / gsize) * kBN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. the row normalisers, one warp per 16 rows, over the whole row
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int r = warp * (kBM / 8) + rr;
    const int row = m0 + r;
    float ss = 0.f;
    if (row < M) {
      const T* xr = x + (size_t)row * D;
      for (int c = lane * VEC; c < D; c += 32 * VEC) {
        float f[VEC];
        unpack16(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) rs[r] = round_to<T>(rsqrtf(ss / (float)D + eps));
  }

  uint4 xreg[XV], wreg[WV];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / VEC), c = (idx % (kBK / VEC)) * VEC;
      const int row = m0 + r, col = k0 + c;
      xreg[i] = (row < M && col < D)
                    ? *reinterpret_cast<const uint4*>(x + (size_t)row * D +
                                                      col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBN / VEC), c = (idx % (kBN / VEC)) * VEC;
      const int krow = k0 + r, col = n0 + c;
      wreg[i] = (krow < D && col < F)
                    ? *reinterpret_cast<const uint4*>(w + (size_t)krow * F +
                                                      col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_shared = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / VEC), c = (idx % (kBK / VEC)) * VEC;
      const int col = k0 + c;
      float xf[VEC], sf[VEC], hf[VEC];
      unpack16(xreg[i], xf);
      unpack16(col < D ? *reinterpret_cast<const uint4*>(scale + col)
                       : make_uint4(0u, 0u, 0u, 0u),
               sf);
      const float rn = rs[r];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        hf[e] = round_to<T>(round_to<T>(xf[e] * rn) * sf[e]);
      }
      *reinterpret_cast<uint4*>(Hs + r * LDA + c) = pack16(hf);
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBN / VEC), c = (idx % (kBN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(Ws + r * LDB + c) = wreg[i];
    }
  };

  // 2. the product, one 64 x 32 sub-tile per warp
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4];
  zero_acc(acc);
  const int nkt = (D + kBK - 1) / kBK;
  load_global(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();          // rs written; the previous step consumed
    store_shared(kt * kBK);
    __syncthreads();
    if (kt + 1 < nkt) load_global((kt + 1) * kBK);
    warp_mma<4, 4, true, false>(acc, Hs + wm * 64 * LDA, LDA, Ws + wn * 32,
                                LDB, kBK);
  }

  // 3. epilogue: round once to T, bounds-checked
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col < F) {
          store_pair(y + (size_t)row * F + col, acc[mt][nt][2 * half],
                     acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* w, void* y,
                   int M, int D, int F, float eps, cudaStream_t stream) {
  const int blocks = ((M + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  rmsnorm_matmul_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(y), M, D, F, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

extern "C" int rmsnorm_matmul_launch(const void* x, const void* scale,
                                     const void* w, void* y, int M, int D,
                                     int F, float eps, int dtype,
                                     void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0) return 0;
  if (D <= 0 || D % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, scale, w, y, M, D, F, eps, st);
  if (dtype == kF32) return launch<float>(x, scale, w, y, M, D, F, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
