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
// y [M, F], all row-major; D and F multiples of 8. h never exists in device
// memory, and scale cannot be folded into w nor r applied after the product:
// the reference rounds after each multiply.
//
// Bound on this card: operations, 2*M*D*F flops at 989 TFLOP/s dense
// bfloat16 (the projections of the main path are far above the card's
// ~295 flops per byte). bfloat16, the training path's type, runs in two
// launches:
//   1. rms_rows_kernel: r[M] in float32 (rounded to bfloat16), one warp a
//      row, reading x once;
//   2. rmsnorm_matmul_wgmma_kernel: one block of 2 consumer warpgroups and
//      a producer warp per 128 x 256 tile of y, blocks ordered in groups of
//      16 row tiles so that the x and w tiles in flight stay in the 50 MB
//      L2. The producer's TMA loads fill a ring of 4 shared-memory stages,
//      each a raw x tile [128 x 64], a w tile [64 x 256] (four 64-column
//      boxes) and the stage's 64 scale values, 128-byte swizzled, with
//      completion counted on an mbarrier; out-of-bounds rows and columns
//      arrive as zeros. Each consumer warpgroup owns 64 rows: per 16-deep
//      k slice it reads its raw x fragment with ldmatrix, multiplies each
//      bfloat16 pair by its rows' r (fixed for the tile, in registers) and
//      by the stage's scale, rounding after each product (mul.rn.bf16x2),
//      and feeds the result to wgmma m64n256k16 as the A operand from
//      registers, w from shared memory (N-major: imm-trans-b). Float32
//      sums in the accumulators, each element's k order fixed (no split-K,
//      no atomics), rounded once to bfloat16 and bounds-checked on store.
// float32 (the card's edge checks) keeps the exact CUDA-core path, wgmma
// having no full-float32 mode: a block of 8 warps owns a 128 x 128 tile,
// computes its rows' normalisers over the full D, then walks D in steps of
// 32, normalising the x step while staging it, with float32 FMAs in the
// accumulator layout of tile_mma.cuh.
#include "hopper_async.cuh"
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

__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// ---- float32: the exact CUDA-core path (launched with T = float) ------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ w, T* __restrict__ y, int M,
                      int D, int F, float d_norm, float eps) {
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
    if (lane == 0) rs[r] = round_to<T>(rsqrtf(ss / d_norm + eps));
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

// ---- bfloat16: row normalisers, then TMA-fed wgmma ---------------------- //
namespace wg {
constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                   // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32; // + the producer warp
constexpr int kGroupM = 16;
constexpr int kABytes = kBM * kBK * 2;          // 16 KB
constexpr int kBBox = 64;                       // w columns a TMA box
constexpr int kBBoxBytes = kBK * kBBox * 2;     // 8 KB
constexpr int kBBytes = kBN / kBBox * kBBoxBytes;
constexpr int kSBytes = kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes + 1024;  // 1024-aligned
constexpr int kTx = kABytes + kBBytes + kSBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kRowsPerBlock = 8;                // rms_rows_kernel, a warp a row
}  // namespace wg

__global__ void __launch_bounds__(wg::kRowsPerBlock * 32)
rms_rows_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ rows,
                int M, int D, float d_norm, float eps) {
  const int row = blockIdx.x * wg::kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float f[8];
    unpack16(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) {
    rows[row] = round_to<__nv_bfloat16>(rsqrtf(ss / d_norm + eps));
  }
}

// a * b per bfloat16 half, each rounded to nearest even (never contracted)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__global__ void __launch_bounds__(wg::kThreads, 1)
rmsnorm_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const __grid_constant__ CUtensorMap tm_s,
                            const float* __restrict__ rows,
                            __nv_bfloat16* __restrict__ y, int M, int D,
                            int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + wg::kStages * wg::kStageBytes);
  uint64_t* empty = full + wg::kStages;

  // grouped raster: kGroupM row tiles share each column sweep
  const int num_m = (M + wg::kBM - 1) / wg::kBM;
  const int num_n = (F + wg::kBN - 1) / wg::kBN;
  const int pid = blockIdx.x;
  const int per_group = wg::kGroupM * num_n;
  const int first_m = (pid / per_group) * wg::kGroupM;
  const int gsize = min(num_m - first_m, wg::kGroupM);
  const int m0 = (first_m + (pid % per_group) % gsize) * wg::kBM;
  const int n0 = ((pid % per_group) / gsize) * wg::kBN;
  const int nk = (D + wg::kBK - 1) / wg::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < wg::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], wg::kConsumers * 4);  // an arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == wg::kConsumers * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % wg::kStages;
        mbar_wait(&empty[st], ((kt / wg::kStages) & 1) ^ 1);
        unsigned char* base = smem + st * wg::kStageBytes;
        const int k0 = kt * wg::kBK;
        mbar_arrive_expect_tx(&full[st], wg::kTx);
        tma_load_2d(base, &tm_x, &full[st], k0, m0);
#pragma unroll
        for (int b = 0; b < wg::kBN / wg::kBBox; ++b)
          tma_load_2d(base + wg::kABytes + b * wg::kBBoxBytes, &tm_w,
                      &full[st], n0 + b * wg::kBBox, k0);
        tma_load_1d(base + wg::kABytes + wg::kBBytes, &tm_s, &full[st], k0);
      }
    }
    return;
  }

  // consumers: warpgroup cg owns rows [64 cg, 64 cg + 64) of the tile
  const int cg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = m0 + cg * 64 + wq * 16 + g, row_hi = row_lo + 8;
  const uint32_t r_lo = pack_bf16(
      __float2bfloat16(row_lo < M ? rows[row_lo] : 0.f),
      __float2bfloat16(row_lo < M ? rows[row_lo] : 0.f));
  const uint32_t r_hi = pack_bf16(
      __float2bfloat16(row_hi < M ? rows[row_hi] : 0.f),
      __float2bfloat16(row_hi < M ? rows[row_hi] : 0.f));
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at the k slice's first 8
  // columns, lanes 16-31 the same rows at its last 8
  const int a_row = cg * 64 + wq * 16 + (lane & 15);
  const int a_half = lane >> 4;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % wg::kStages;
    mbar_wait(&full[st], (kt / wg::kStages) & 1);
    __syncwarp();  // ldmatrix and wgmma need the warp converged
    const unsigned char* base = smem + st * wg::kStageBytes;
    const uint32_t a_base = smem_addr(base) + a_row * 128;
    const uint32_t b_base = smem_addr(base + wg::kABytes);
    const __nv_bfloat16* sc =
        reinterpret_cast<const __nv_bfloat16*>(base + wg::kABytes +
                                               wg::kBBytes);
#pragma unroll
    for (int kk = 0; kk < wg::kBK / 16; ++kk) {
      uint32_t raw[4], a[4];
      const int chunk = 2 * kk + a_half;          // 16-byte chunk of the row
      ldmatrix_x4(raw, a_base + ((chunk ^ (a_row & 7)) << 4));
      const uint32_t s_lo =
          *reinterpret_cast<const uint32_t*>(sc + 16 * kk + 2 * t);
      const uint32_t s_hi =
          *reinterpret_cast<const uint32_t*>(sc + 16 * kk + 8 + 2 * t);
      a[0] = mul_bf16x2(mul_bf16x2(raw[0], r_lo), s_lo);
      a[1] = mul_bf16x2(mul_bf16x2(raw[1], r_hi), s_lo);
      a[2] = mul_bf16x2(mul_bf16x2(raw[2], r_lo), s_hi);
      a[3] = mul_bf16x2(mul_bf16x2(raw[3], r_hi), s_hi);
      wgmma_fence();
      // w: 64-column boxes kBBoxBytes apart (LBO), 8-row k groups 1024
      // bytes apart (SBO); a 16-deep slice starts 16 rows of 128 bytes in
      wgmma_m64n256k16_rs(
          acc, a,
          wgmma_desc_sw128(b_base + kk * 16 * 128, wg::kBBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) wgmma_fence_operand(acc[i]);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: round once to bfloat16, bounds-checked
#pragma unroll
  for (int j = 0; j < wg::kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col < F) {
      if (row_lo < M)
        store_pair(y + (size_t)row_lo * F + col, acc[4 * j], acc[4 * j + 1]);
      if (row_hi < M)
        store_pair(y + (size_t)row_hi * F + col, acc[4 * j + 2],
                   acc[4 * j + 3]);
    }
  }
}

cudaError_t launch_bf16(const void* x, const void* scale, const void* w,
                        void* y, float* rows, int M, int D, int F,
                        float d_norm, float eps, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // encoded every call: the caching allocator reuses addresses
  CUtensorMap tm_x, tm_w, tm_s;
  if (!encode_bf16(enc, &tm_x, x, M, D, wg::kBM, wg::kBK,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(enc, &tm_w, w, D, F, wg::kBK, wg::kBBox,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(enc, &tm_s, scale, 0, D, 1, wg::kBK,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  rms_rows_kernel<<<(M + wg::kRowsPerBlock - 1) / wg::kRowsPerBlock,
                    wg::kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), rows, M, D, d_norm, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rmsnorm_matmul_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks =
      ((M + wg::kBM - 1) / wg::kBM) * ((F + wg::kBN - 1) / wg::kBN);
  rmsnorm_matmul_wgmma_kernel<<<blocks, wg::kThreads, wg::kSmemBytes, stream>>>(
      tm_x, tm_w, tm_s, rows, static_cast<__nv_bfloat16*>(y), M, D, F);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* scale, const void* w,
                       void* y, int M, int D, int F, float d_norm, float eps,
                       cudaStream_t stream) {
  const int blocks = ((M + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  rmsnorm_matmul_kernel<float><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(w), static_cast<float*>(y), M, D, F, d_norm,
      eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// x [M, D], scale [D], w [D, F], y [M, F] (float32 or bfloat16, all one
// type), rows float32 [M] (bfloat16's row normalisers; unused for float32).
// d_norm: the row width the mean of x^2 divides by, D itself or, when the
// caller zero-padded a narrower x, scale and w to D columns (rows), the
// true width (the padded columns add +0 to the sums and the products).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the first cudaError_t (0 on success).
extern "C" int rmsnorm_matmul_launch(const void* x, const void* scale,
                                     const void* w, void* y, void* rows,
                                     int M, int D, int F, int d_norm,
                                     float eps, int dtype, void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0) return 0;
  if (D <= 0 || D % 8 || F % 8 || d_norm <= 0 || d_norm > D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return launch_bf16(x, scale, w, y, static_cast<float*>(rows), M, D, F,
                       (float)d_norm, eps, st);
  if (dtype == kF32)
    return launch_f32(x, scale, w, y, M, D, F, (float)d_norm, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
