// The matmuls of the fused compute + collective edges for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   deepspeed_tpu/kernels/fused_collective_matmul.py::_matmul_kernel
//     (driven by shard_major_matmul)                                 (K11)
//   deepspeed_tpu/kernels/fused_collective_matmul.py::
//     _gathered_dequant_matmul's kernel                               (K12)
// and computes what their plain PyTorch versions in
// deepspeed_tpu_torch/kernels/fused_collective_matmul.py compute:
//   K11  y[M, N] = x[M, K] @ w[K, N], float32 sums, rounded once to the
//        element type T (float32 or bfloat16) of x, w and y. The output
//        tiles are walked shard-major: the linear block index runs over
//        the n_shards row blocks of M / n_shards rows first, so shard s's
//        rows complete before shard s+1's (the reduce-scatter epilogue can
//        take each shard as it completes); a tile never crosses a shard.
//   K12  out[M, N] = sum over shards r of x[:, r*k:(r+1)*k] @ W_r, float32:
//        W_r[kk, c] is element kk*N + c of shard r's padded flat on the
//        wire: group g = e / G, position p = e % G, value q * scale[r, g]
//        with q the byte p (int8) or, for int4, the low nibble of byte p
//        when p < G/2 and the high nibble of byte p - G/2 otherwise, both
//        sign-extended. Each shard's product is summed on its own and then
//        added to the running sum, as the reference adds each shard's dot.
//        Exact float32: the dequantized weight is a float32 product
//        (__fmul_rn) and the sums are FMAs on the CUDA cores, never TF32
//        or bfloat16, as the reference's float32 dot.
//
// Bound on this card: operations. K11 2*M*K*N at 989 TFLOP/s dense
// bfloat16 (67 TFLOP/s float32); K12 2*M*(n*k)*N float32 at 67 TFLOP/s.
//
// K11 in bfloat16, the type of the fused-gemm edges: a TMA + wgmma kernel.
// One block of two consumer warpgroups and a producer warp owns a 128 x 256
// tile of y; the tiles are walked shard-major and, inside each shard, in
// groups of kGroupM row tiles sharing each column sweep (the x and w tiles
// in flight stay in the 50 MB L2). The producer's thread fills a ring of
// kStages shared-memory stages by TMA, each an x tile [128 x 64] and a w
// tile [64 x 256] (four 64-column boxes), 128-byte swizzled, completion
// counted on an mbarrier; columns past K and N arrive as zeros, and w boxes
// wholly past N are not loaded (their columns are never stored). Each
// consumer warpgroup owns 64 rows and issues wgmma m64n256k16 with both
// operands in shared memory (x K-major, w N-major: imm-trans-b) per 16-deep
// k slice; the sums stay float32 in the accumulators, each element's k
// order fixed (no split-K, no atomics), so an element's bits do not depend
// on its tile's position or on n_shards. The epilogue rounds once to
// bfloat16 and stores rows below the shard's end only: rows of the next
// shard that a tile's TMA box reads are computed and dropped.
// float32 (the card's edge checks) keeps the exact CUDA-core path, wgmma
// having no full-float32 mode: a block of 8 warps owns a 128 x 128 tile and
// walks K in steps of 32, staging x and w with 16-byte loads (the next
// step's issued into registers before the current step's products) into
// padded shared memory, each warp accumulating a 64 x 32 sub-tile with
// float32 FMAs in the accumulator layout of tile_mma.cuh. K12 shares that
// design: it dequantizes each weight element while staging it into shared
// memory, so the float32 weight never exists in device memory, and keeps
// two accumulators a thread (the shard's product and the running sum).
// Left on the table: a persistent tile scheduler and an epilogue through
// shared memory (K11); for K12 the dequantize of a weight tile is repeated
// by each row tile of the output.
#include "hopper_async.cuh"
#include "tile_mma.cuh"

namespace dstorch {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kGroupM = 8;

// The (row tile, column tile) of linear tile index t of a tiles_m x
// tiles_n grid, in groups of `group` row tiles sharing each column sweep
// (the tiles of x and w in flight stay in the 50 MB L2).
__device__ __forceinline__ void grouped_tile(int t, int tiles_m, int tiles_n,
                                             int group, int& tm, int& tn) {
  const int per_group = group * tiles_n;
  const int first_m = (t / per_group) * group;
  const int gsize = min(tiles_m - first_m, group);
  tm = first_m + (t % per_group) % gsize;
  tn = (t % per_group) / gsize;
}

// ------------------------------------------------------------------------
// K11, bfloat16: TMA + wgmma
// ------------------------------------------------------------------------
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
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB, 1024-aligned
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads, 1)
shard_major_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_w,
                                __nv_bfloat16* __restrict__ y, int M, int K,
                                int N, int n_shards) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + wg::kStages * wg::kStageBytes);
  uint64_t* empty = full + wg::kStages;

  // shard-major: all tiles of shard s before any of shard s + 1
  const int rows = M / n_shards;
  const int tiles_m = (rows + wg::kBM - 1) / wg::kBM;
  const int tiles_n = (N + wg::kBN - 1) / wg::kBN;
  const int per_shard = tiles_m * tiles_n;
  const int shard = blockIdx.x / per_shard;
  int tm, tn;
  grouped_tile(blockIdx.x % per_shard, tiles_m, tiles_n, wg::kGroupM, tm,
               tn);
  const int m0 = shard * rows + tm * wg::kBM;
  const int m_end = min(shard * rows + rows, m0 + wg::kBM);  // exclusive
  const int n0 = tn * wg::kBN;
  const int nk = (K + wg::kBK - 1) / wg::kBK;
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
    // producer: one thread keeps the ring full; w boxes wholly past N are
    // left out (their accumulator columns are never stored)
    if (lane == 0) {
      const int boxes = min(wg::kBN, N - n0 + wg::kBBox - 1) / wg::kBBox;
      const uint32_t tx = wg::kABytes + boxes * wg::kBBoxBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % wg::kStages;
        mbar_wait(&empty[st], ((kt / wg::kStages) & 1) ^ 1);
        unsigned char* base = smem + st * wg::kStageBytes;
        const int k0 = kt * wg::kBK;
        mbar_arrive_expect_tx(&full[st], tx);
        tma_load_2d(base, &tm_x, &full[st], k0, m0);
        for (int b = 0; b < boxes; ++b)
          tma_load_2d(base + wg::kABytes + b * wg::kBBoxBytes, &tm_w,
                      &full[st], n0 + b * wg::kBBox, k0);
      }
    }
    return;
  }

  // consumers: warpgroup cg owns rows [64 cg, 64 cg + 64) of the tile
  const int cg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = m0 + cg * 64 + wq * 16 + g, row_hi = row_lo + 8;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % wg::kStages;
    mbar_wait(&full[st], (kt / wg::kStages) & 1);
    __syncwarp();  // wgmma needs the warp converged
    const uint32_t a_base =
        smem_addr(smem + st * wg::kStageBytes) + cg * 64 * 128;
    const uint32_t b_base = smem_addr(smem + st * wg::kStageBytes) +
                            wg::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < wg::kBK / 16; ++kk) {
      // x: rows of 128 bytes, a 16-deep slice 32 bytes in; w: 64-column
      // boxes kBBoxBytes apart (LBO), 8-row k groups 1024 bytes apart
      // (SBO), a 16-deep slice 16 rows of 128 bytes in
      wgmma_m64n256k16_ss(
          acc, wgmma_desc_kmajor(a_base + kk * 32),
          wgmma_desc_sw128(b_base + kk * 16 * 128, wg::kBBoxBytes, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: round once to bfloat16; only this shard's rows, columns < N
#pragma unroll
  for (int j = 0; j < wg::kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col < N) {
      if (row_lo < m_end)
        store_pair(y + (size_t)row_lo * N + col, acc[4 * j], acc[4 * j + 1]);
      if (row_hi < m_end)
        store_pair(y + (size_t)row_hi * N + col, acc[4 * j + 2],
                   acc[4 * j + 3]);
    }
  }
}

cudaError_t launch_shard_major_bf16(const void* x, const void* w, void* y,
                                    int M, int K, int N, int n_shards,
                                    cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // encoded every call: the caching allocator reuses addresses
  CUtensorMap tm_x, tm_w;
  if (!encode_bf16(enc, &tm_x, x, M, K, wg::kBM, wg::kBK,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(enc, &tm_w, w, K, N, wg::kBK, wg::kBBox,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      shard_major_matmul_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int rows = M / n_shards;
  const long long blocks = (long long)n_shards *
                           ((rows + wg::kBM - 1) / wg::kBM) *
                           ((N + wg::kBN - 1) / wg::kBN);
  shard_major_matmul_wgmma_kernel<<<(unsigned)blocks, wg::kThreads,
                                    wg::kSmemBytes, stream>>>(
      tm_x, tm_w, static_cast<__nv_bfloat16*>(y), M, K, N, n_shards);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// K11, float32: the exact CUDA-core path
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
shard_major_matmul_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ y,
                          int M, int K, int N, int n_shards) {
  constexpr int VEC = 4;
  constexpr int LDA = kBK + kPad<float>;
  constexpr int LDB = kBN + kPad<float>;
  constexpr int XV = kBM * kBK / VEC / kThreads;   // x vectors per thread
  constexpr int WV = kBK * kBN / VEC / kThreads;   // w vectors per thread
  __shared__ __align__(16) float As[kBM * LDA];
  __shared__ __align__(16) float Bs[kBK * LDB];

  // shard-major: all tiles of shard s before any of shard s + 1
  const int rows = M / n_shards;
  const int tiles_m = (rows + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int per_shard = tiles_m * tiles_n;
  const int shard = blockIdx.x / per_shard;
  int tm, tn;
  grouped_tile(blockIdx.x % per_shard, tiles_m, tiles_n, kGroupM, tm, tn);
  const int m0 = shard * rows + tm * kBM;
  const int m_end = min(shard * rows + rows, m0 + kBM);  // exclusive
  const int n0 = tn * kBN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  uint4 xreg[XV], wreg[WV];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / VEC), c = (idx % (kBK / VEC)) * VEC;
      const int row = m0 + r, col = k0 + c;
      xreg[i] = (row < m_end && col < K)
                    ? *reinterpret_cast<const uint4*>(x + (size_t)row * K +
                                                      col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBN / VEC), c = (idx % (kBN / VEC)) * VEC;
      const int krow = k0 + r, col = n0 + c;
      wreg[i] = (krow < K && col < N)
                    ? *reinterpret_cast<const uint4*>(w + (size_t)krow * N +
                                                      col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_shared = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / VEC), c = (idx % (kBK / VEC)) * VEC;
      *reinterpret_cast<uint4*>(As + r * LDA + c) = xreg[i];
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBN / VEC), c = (idx % (kBN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) = wreg[i];
    }
  };

  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4];
  zero_acc(acc);
  const int nkt = (K + kBK - 1) / kBK;
  load_global(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();          // the previous step's products are done
    store_shared();
    __syncthreads();
    if (kt + 1 < nkt) load_global((kt + 1) * kBK);
    warp_mma<4, 4, true, false>(acc, As + wm * 64 * LDA, LDA, Bs + wn * 32,
                                LDB, kBK);
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
      if (row >= m_end) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col < N) {
          store_pair(y + (size_t)row * N + col, acc[mt][nt][2 * half],
                     acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

cudaError_t launch_shard_major_f32(const void* x, const void* w, void* y,
                                   int M, int K, int N, int n_shards,
                                   cudaStream_t stream) {
  const int rows = M / n_shards;
  const long long blocks = (long long)n_shards * ((rows + kBM - 1) / kBM) *
                           ((N + kBN - 1) / kBN);
  shard_major_matmul_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), M, K, N, n_shards);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// K12
// ------------------------------------------------------------------------
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435082228750797e-38f ? 0.f : v;
}

// Wire value at position p of a group (int8: byte p; int4: half-split).
template <int BITS>
__device__ __forceinline__ int wire_q(const int8_t* wg, int p, int half) {
  if (BITS == 8) return wg[p];
  return p < half ? (int)(int8_t)(wg[p] << 4) >> 4 : wg[p - half] >> 4;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
gathered_dequant_matmul_kernel(const float* __restrict__ x,
                               const int8_t* __restrict__ wire,
                               const float* __restrict__ scales,
                               float* __restrict__ out, int M, int N, int k,
                               int n_shards, int groups, int gs,
                               int gs_shift) {
  constexpr int LDA = kBK + kPad<float>;
  constexpr int LDB = kBN + kPad<float>;
  __shared__ __align__(16) float As[kBM * LDA];
  __shared__ __align__(16) float Bs[kBK * LDB];

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  int tm, tn;
  grouped_tile(blockIdx.x, tiles_m, tiles_n, kGroupM, tm, tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int W = BITS == 8 ? gs : gs / 2;
  const int half = gs / 2;
  const size_t ldx = (size_t)n_shards * k;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;

  float total[4][4][4];
  zero_acc(total);
  for (int r = 0; r < n_shards; ++r) {
    const int8_t* wr = wire + (size_t)r * groups * W;
    const float* sr = scales + (size_t)r * groups;
    float part[4][4][4];
    zero_acc(part);
    for (int k0 = 0; k0 < k; k0 += kBK) {
      __syncthreads();        // the previous step's products are done
      for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
        const int rr = idx / kBK, c = idx % kBK;
        const int row = m0 + rr, kk = k0 + c;
        As[rr * LDA + c] = (row < M && kk < k)
                               ? x[(size_t)row * ldx + (size_t)r * k + kk]
                               : 0.f;
      }
      for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
        const int kr = idx / kBN, c = idx % kBN;
        const int kk = k0 + kr, col = n0 + c;
        float v = 0.f;
        if (kk < k && col < N) {
          // a 64-bit division per element would cost as much as the
          // products: shift when the group size is a power of two
          const long long e = (long long)kk * N + col;
          const long long grp = gs_shift >= 0 ? e >> gs_shift : e / gs;
          const int p = (int)(e - grp * gs);
          const float q = (float)wire_q<BITS>(wr + grp * W, p, half);
          v = __fmul_rn(q, ftz(sr[grp]));
        }
        Bs[kr * LDB + c] = v;
      }
      __syncthreads();
      warp_mma<4, 4, true, false>(part, As + wm * 64 * LDA, LDA,
                                  Bs + wn * 32, LDB, kBK);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          total[mt][nt][e] = __fadd_rn(total[mt][nt][e], part[mt][nt][e]);
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half_ = 0; half_ < 2; ++half_) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * half_;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col < N) out[(size_t)row * N + col] = total[mt][nt][2 * half_];
        if (col + 1 < N)
          out[(size_t)row * N + col + 1] = total[mt][nt][2 * half_ + 1];
      }
    }
  }
}

template <int BITS>
cudaError_t launch_gathered(const void* x, const void* wire,
                            const void* scales, void* out, int M, int N,
                            int k, int n_shards, int groups, int gs,
                            cudaStream_t stream) {
  const long long blocks =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  int gs_shift = -1;
  for (int b = 0; b < 31; ++b)
    if (gs == (1 << b)) gs_shift = b;
  gathered_dequant_matmul_kernel<BITS>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(wire),
          static_cast<const float*>(scales), static_cast<float*>(out), M, N,
          k, n_shards, groups, gs, gs_shift);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// K11: x [M, K], w [K, N], y [M, N], row-major, all float32 or all
// bfloat16 (dtype 0 / 1); K and N multiples of 8; M a multiple of n_shards.
// Returns the cudaError_t of the launch.
extern "C" int shard_major_matmul_launch(const void* x, const void* w,
                                         void* y, int M, int K, int N,
                                         int n_shards, int dtype,
                                         void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || n_shards < 1 || M % n_shards)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return launch_shard_major_bf16(x, w, y, M, K, N, n_shards, st);
  if (dtype == kF32)
    return launch_shard_major_f32(x, w, y, M, K, N, n_shards, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12: x float32 [M, n_shards * k], wire int8 [n_shards, groups,
// bits == 8 ? gs : gs / 2], scales float32 [n_shards, groups] → out float32
// [M, N]; groups * gs >= k * N.
extern "C" int gathered_dequant_matmul_launch(const void* x, const void* wire,
                                              const void* scales, void* out,
                                              int M, int N, int k,
                                              int n_shards, int groups,
                                              int gs, int bits,
                                              void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (k <= 0 || n_shards < 1 || gs < 1 || (long long)groups * gs <
      (long long)k * N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8)
    return launch_gathered<8>(x, wire, scales, out, M, N, k, n_shards, groups,
                              gs, st);
  if (bits == 4 && gs % 2 == 0)
    return launch_gathered<4>(x, wire, scales, out, M, N, k, n_shards, groups,
                              gs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
