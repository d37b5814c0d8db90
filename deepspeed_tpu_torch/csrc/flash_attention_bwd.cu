// Flash attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/transformer/flash_attention.py::_bwd_dq_kernel  (dQ)
//   deepspeed_tpu/ops/transformer/flash_attention.py::_bwd_dkv_kernel (dK, dV)
// driven by _bwd, the backward of _flash_bhsd's custom_vjp. Both recompute
// the probabilities from the forward's row log-sum-exp instead of storing
// them:
//     P  = exp(Q.K^T * scale - lse)        (0 where masked)
//     dS = P * (dO.V^T - delta) * scale    delta = rowsum(dO * O), float32,
//                                          computed outside, as in _bwd
//     dQ = dS.K        dK = dS^T.Q        dV = P^T.dO
// Layouts as the forward: q, k, v, o, dO and the gradients [B, S, H, hd];
// lse and delta [B, H, S] float32. Element type float32 or bfloat16, hd in
// {64, 128, 256}. Two launches, as the reference: dQ, then dK/dV. Neither uses
// atomics and every float32 sum runs in a fixed tile order, so the outputs
// are the same bits from call to call.
//
// Bound on this card: operations; per visible (query, key) pair and head,
// dQ does 6*hd flops (Q.K^T, dO.V^T, dS.K) and dK/dV 8*hd (K.Q^T, V.dO^T,
// P^T.dO, dS^T.Q): 14*hd for the pair against 989 TFLOP/s dense bfloat16
// (one fused pass with dQ summed by atomics would do 10*hd, but not in a
// fixed order).
//
// bfloat16, the training path's type: TMA + wgmma kernels, one template
// for hd 64 and 128 (flash_wgmma.cuh holds what they share with the
// forward). A CTA owns 128 rows of one (batch, head), two
// warpgroups of 64, and walks the other side in tiles of 64 rows through a
// ring of kStages shared-memory stages, all loaded by TMA from the
// [B, S, H*hd] layout as it is (3-D tensor maps, 64-column boxes, 128-byte
// swizzle; rows past S arrive as zeros), completion counted on mbarriers.
// Per walked tile each warpgroup issues its two score products with both
// operands in shared memory (wgmma m64n64k16, K-major), computes P and dS
// in float32 registers, rounds them to bf16 once and feeds them from
// registers as the A operand of its second products (B N-major:
// imm-trans-b). The warpgroups take turns at the tensor cores (named
// barriers), so one computes P and dS while the other's products run;
// each warpgroup's issue and wait sit in one block with no divergent code
// between them, or ptxas serializes the wgmma. P = 2^(s*scale*log2 e -
// lse*log2 e) on the special-function unit (ex2.approx, relative error
// ~2^-22, two instructions a score; expf took ~10 and the scores' loop
// most of the time), and the mask is evaluated only on diagonal and tail
// tiles.
//   * dQ: a CTA owns 128 query rows and walks key tiles up to its diagonal
//     (the reference's _causal_kv_index), heaviest CTAs first within each
//     raster group; S = Q.K^T, dP = dO.V^T, dQ += dS.K. Warp-specialised:
//     a producer warpgroup gives its registers back (setmaxnreg 24) and
//     one of its threads fills the ring; the consumers take 240.
//   * dK/dV: a CTA owns 128 key rows and walks query tiles from the first
//     that sees them (_causal_q_index); it computes the transposed tiles
//     S^T = K.Q^T and dP^T = V.dO^T, so each warpgroup's accumulator rows
//     are its own keys, then dV += P^T.dO and dK += dS^T.Q. Its consumers
//     hold 128 accumulator floats a thread at hd 128 and need more than
//     setmaxnreg's 240 (ptxas spilled them), so it has no producer: 256
//     threads, 255 registers, and warp 0 fills the ring a tile ahead (its
//     lanes copy the tile's lse and delta rows with cp.async, zeros past S).
// Rounding as the earlier kernels and FlashAttention-2: scores, row
// statistics, P, dP and dS in float32; P and dS rounded to bf16 once,
// before the second products (a relative error <= 2^-9 per term); float32
// sums in tile order; each output rounded once. CTAs are rastered in
// groups of kHeadGroup (batch, head) pairs, so the walked tensors of the
// CTAs in flight stay in the 50 MB L2. Left on the table: a producer for
// dK/dV (its refill stalls warpgroup 0), folding delta into the dQ pass,
// score products with an owned operand in registers.
//
// float32 (the card's edge checks) keeps the exact tile kernels, wgmma
// having no full-float32 mode, and so does hd 256 in both types (a [128 x
// 256] owned tile pair and its ring do not fit shared memory): a block of
// TILE / 16 warps owns TILE rows and walks TILE-row tiles it loads itself
// (TILE 64, 32 for float32 at hd 256), in the accumulator layout of
// tile_mma.cuh: float32 FMAs for float32, mma.sync with float32 sums for
// bf16, P and dS staged through shared memory in the input type (so
// rounded to bf16 before the second products, as the wgmma path rounds
// them). At hd 256 dK/dV holds 256 accumulator floats a thread and ptxas
// spills (PERF.md); speed at hd 256 is later work.
#include <type_traits>

#include "flash_wgmma.cuh"

namespace dstorch {

// ---- bfloat16: TMA + wgmma, two warpgroups in turns (flash_wgmma.cuh) ---
namespace wg {
namespace {
constexpr int kWalk = 64;                 // rows of a walked tile
constexpr int kStages = 3;
// dQ: + a producer warpgroup; 168 registers a thread at entry (65536 /
// 384, in steps of 8), the producer gives 144 back, the consumers take 72
constexpr int kThreadsDq = (kGroups + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// dK/dV: its consumers need more than 240 (dK and dV accumulate 128
// floats a thread at hd 128), so no producer: 255 registers a thread,
// and warp 0 fills the ring
constexpr int kThreadsDkv = kGroups * 128;
constexpr int kWalkBox = kWalk * 128;     // bytes of a [64 x 64] box

template <int HD, bool STATS>
struct Layout {
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kOwnBox = kOwn * 128;           // a [128 x 64] box
  static constexpr int kOwnBytes = kBoxes * kOwnBox;   // one owned tensor
  static constexpr int kWalkBytes = kBoxes * kWalkBox; // one walked tensor
  // STATS: the walked rows' lse and delta (dK/dV), after the tiles
  static constexpr int kStats = STATS ? 2 * kWalk * 4 : 0;
  static constexpr int kTx = 2 * kWalkBytes;           // a stage's TMA bytes
  static constexpr int kStageBytes = (kTx + kStats + 1023) / 1024 * 1024;
  static constexpr int kBars = 1 + 2 * kStages;        // owned, full, empty
  static constexpr int kSmem =
      2 * kOwnBytes + kStages * kStageBytes + 8 * kBars + 1024;
};

// `fills` arrivals complete a stage: the filling thread's expect-tx, and
// (dK/dV) one a lane of warp 0 once its cp.async copies of row statistics
// landed
__device__ __forceinline__ void init_bars(uint64_t* bars, int fills) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                          // the owned rows
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bars[1 + i], fills);                // stage i full
      mbar_init(&bars[1 + kStages + i], kGroups * 4);  // i consumed
    }
    mbar_init_fence();
  }
  __syncthreads();
}
}  // namespace
}  // namespace wg

namespace {

// ---- the exact tile kernels: float32, and hd 256 in both types ---------
// A block owns TILE rows (TILE / 16 warps) and walks TILE-row tiles:
// TILE = 64, and 32 for float32 at hd 256 (64 rows take 277 and 294 KB of
// shared memory there).
template <typename T, int HD>
constexpr int kExactTile = sizeof(T) == 4 && HD == 256 ? 32 : 64;

template <typename T, int HD, int TILE>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (4 * TILE * (HD + kPad<T>) + TILE * (TILE + kPad<T>));
}

template <typename T, int HD, int TILE>
constexpr size_t dkv_smem_bytes() {
  return sizeof(T) *
             (4 * TILE * (HD + kPad<T>) + 2 * TILE * (TILE + kPad<T>)) +
         sizeof(float) * 2 * TILE;
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, float scale, int causal) {
  constexpr int kB = TILE;
  constexpr int kThreads = 2 * TILE;
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = kB + kPad<T>;
  constexpr int NT_S = kB / 8;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kB * LD;
  T* Ks = dOs + kB * LD;
  T* Vs = Ks + kB * LD;
  T* dSs = Vs + kB * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * HD;
  const size_t stat = ((size_t)b * H + h) * S;
  const int q0 = iq * kB;

  load_tile<T, kB, HD, kThreads>(Qs, LD, q + base + q0 * row_stride,
                                     row_stride, S - q0);
  load_tile<T, kB, HD, kThreads>(dOs, LD, dout + base + q0 * row_stride,
                                     row_stride, S - q0);
  const int row_lo = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    lse_r[r] = row < S ? lse[stat + row] : 0.f;
    delta_r[r] = row < S ? delta[stat + row] : 0.f;
  }

  float acc[1][NT_O][4];
  zero_acc(acc);
  const int nk = (S + kB - 1) / kB;
  const int n_tiles = causal ? min(nk, iq + 1) : nk;
  T* dSw = dSs + warp * 16 * LDP;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kB;
    __syncthreads();
    load_tile<T, kB, HD, kThreads>(Ks, LD, k + base + j0 * row_stride,
                                       row_stride, S - j0);
    load_tile<T, kB, HD, kThreads>(Vs, LD, v + base + j0 * row_stride,
                                       row_stride, S - j0);
    __syncthreads();

    float s[1][NT_S][4], dp[1][NT_S][4];
    zero_acc(s);
    zero_acc(dp);
    warp_mma<1, NT_S, true, true>(s, Qs + warp * 16 * LD, LD, Ks, LD, HD);
    warp_mma<1, NT_S, true, true>(dp, dOs + warp * 16 * LD, LD, Vs, LD, HD);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int col = j0 + 8 * nt + 2 * t + (e & 1);
        const bool ok = row < S && col < S && (!causal || row >= col);
        const float p = ok ? expf(s[0][nt][e] * scale - lse_r[e >> 1]) : 0.f;
        ds[e] = p * (dp[0][nt][e] - delta_r[e >> 1]) * scale;
      }
      store_pair(dSw + g * LDP + 8 * nt + 2 * t, ds[0], ds[1]);
      store_pair(dSw + (g + 8) * LDP + 8 * nt + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    warp_mma<1, NT_O, true, false>(acc, dSw, LDP, Ks, LD, kB);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    T* out = dq + base + (size_t)row * row_stride;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(out + 8 * nt + 2 * t, acc[0][nt][2 * r],
                 acc[0][nt][2 * r + 1]);
    }
  }
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, float scale,
                     int causal) {
  constexpr int kB = TILE;
  constexpr int kThreads = 2 * TILE;
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = kB + kPad<T>;
  constexpr int NT_S = kB / 8;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kB * LD;
  T* Qs = Vs + kB * LD;
  T* dOs = Qs + kB * LD;
  T* PTs = dOs + kB * LD;
  T* dSTs = PTs + kB * LDP;
  float* lse_s = reinterpret_cast<float*>(dSTs + kB * LDP);
  float* delta_s = lse_s + kB;

  const int jk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * HD;
  const size_t stat = ((size_t)b * H + h) * S;
  const int j0 = jk * kB;

  load_tile<T, kB, HD, kThreads>(Ks, LD, k + base + j0 * row_stride,
                                     row_stride, S - j0);
  load_tile<T, kB, HD, kThreads>(Vs, LD, v + base + j0 * row_stride,
                                     row_stride, S - j0);

  float acc_k[1][NT_O][4], acc_v[1][NT_O][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  const int key_lo = j0 + warp * 16 + g;          // keys key_lo, key_lo + 8
  const int nq = (S + kB - 1) / kB;
  const int first = causal ? jk : 0;              // kB query rows per tile
  T* PTw = PTs + warp * 16 * LDP;
  T* dSTw = dSTs + warp * 16 * LDP;
  for (int it = first; it < nq; ++it) {
    const int q0 = it * kB;
    __syncthreads();
    load_tile<T, kB, HD, kThreads>(Qs, LD, q + base + q0 * row_stride,
                                       row_stride, S - q0);
    load_tile<T, kB, HD, kThreads>(dOs, LD, dout + base + q0 * row_stride,
                                       row_stride, S - q0);
    if (threadIdx.x < kB) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[stat + row] : 0.f;
      delta_s[threadIdx.x] = row < S ? delta[stat + row] : 0.f;
    }
    __syncthreads();

    float st[1][NT_S][4], dpt[1][NT_S][4];
    zero_acc(st);
    zero_acc(dpt);
    // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries
    warp_mma<1, NT_S, true, true>(st, Ks + warp * 16 * LD, LD, Qs, LD, HD);
    warp_mma<1, NT_S, true, true>(dpt, Vs + warp * 16 * LD, LD, dOs, LD, HD);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + 8 * (e >> 1);
        const int ci = 8 * nt + 2 * t + (e & 1);
        const int row = q0 + ci;
        const bool ok = row < S && key < S && (!causal || row >= key);
        p[e] = ok ? expf(st[0][nt][e] * scale - lse_s[ci]) : 0.f;
        ds[e] = p[e] * (dpt[0][nt][e] - delta_s[ci]) * scale;
      }
      store_pair(PTw + g * LDP + 8 * nt + 2 * t, p[0], p[1]);
      store_pair(PTw + (g + 8) * LDP + 8 * nt + 2 * t, p[2], p[3]);
      store_pair(dSTw + g * LDP + 8 * nt + 2 * t, ds[0], ds[1]);
      store_pair(dSTw + (g + 8) * LDP + 8 * nt + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    // dV += P^T.dO, dK += dS^T.Q: B(k = query, n = d) = tile[query][d]
    warp_mma<1, NT_O, true, false>(acc_v, PTw, LDP, dOs, LD, kB);
    warp_mma<1, NT_O, true, false>(acc_k, dSTw, LDP, Qs, LD, kB);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    T* ok_ = dk + base + (size_t)key * row_stride;
    T* ov_ = dv + base + (size_t)key * row_stride;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(ok_ + 8 * nt + 2 * t, acc_k[0][nt][2 * r],
                 acc_k[0][nt][2 * r + 1]);
      store_pair(ov_ + 8 * nt + 2 * t, acc_v[0][nt][2 * r],
                 acc_v[0][nt][2 * r + 1]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq_exact(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int S,
                            int H, float scale, int causal,
                            cudaStream_t stream) {
  constexpr int TILE = kExactTile<T, HD>;
  auto kern = flash_bwd_dq_kernel<T, HD, TILE>;
  const size_t smem = dq_smem_bytes<T, HD, TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kern<<<grid, 2 * TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv_exact(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int S, int H, float scale, int causal,
                             cudaStream_t stream) {
  constexpr int TILE = kExactTile<T, HD>;
  auto kern = flash_bwd_dkv_kernel<T, HD, TILE>;
  const size_t smem = dkv_smem_bytes<T, HD, TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kern<<<grid, 2 * TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale, causal);
  return cudaGetLastError();
}

// dQ: a CTA owns 128 query rows and walks 64-key tiles.
template <int HD>
__global__ void __launch_bounds__(wg::kThreadsDq, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int BH, int S,
                          int H, float scale, int causal) {
  using L = wg::Layout<HD, false>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = wg::align1024(smem_raw);
  unsigned char* dOs = Qs + L::kOwnBytes;
  unsigned char* stages = dOs + L::kOwnBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + wg::kStages * L::kStageBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int ntiles = (S + wg::kOwn - 1) / wg::kOwn;
  int rank, bh;
  wg::raster(BH, ntiles, rank, bh);
  const int b = bh / H, h = bh % H, col = h * HD;
  const int q0 = (ntiles - 1 - rank) * wg::kOwn;  // the last rows walk most
  const int nk = (S + wg::kWalk - 1) / wg::kWalk;
  const int n_tiles = causal ? min(nk, (q0 + wg::kOwn) / wg::kWalk) : nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wg::init_bars(bars, 1);

  // the producer: one thread issues every TMA load, Q and dO once, then K
  // and V tiles into the ring as its stages come free
  auto fill = [&](int jt) {
    const int st = jt % wg::kStages;
    unsigned char* base = stages + st * L::kStageBytes;
    mbar_arrive_expect_tx(&full[st], L::kTx);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_3d(base + c * wg::kWalkBox, &tm_k, &full[st], col + 64 * c,
                  jt * wg::kWalk, b);
      tma_load_3d(base + L::kWalkBytes + c * wg::kWalkBox, &tm_v, &full[st],
                  col + 64 * c, jt * wg::kWalk, b);
    }
  };
  if (warp >= wg::kGroups * 4) {
    setmaxnreg_dec<wg::kProducerRegs>();
    if (warp == wg::kGroups * 4 && lane == 0) {
      mbar_arrive_expect_tx(&bars[0], 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(Qs + c * L::kOwnBox, &tm_q, &bars[0], col + 64 * c, q0,
                    b);
        tma_load_3d(dOs + c * L::kOwnBox, &tm_do, &bars[0], col + 64 * c,
                    q0, b);
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % wg::kStages;
        mbar_wait(&empty[st], ((jt / wg::kStages) & 1) ^ 1);
        fill(jt);
      }
    }
    return;
  }

  // consumers: warpgroup cg owns query rows [rw, rw + 64)
  setmaxnreg_inc<wg::kConsumerRegs>();
  const int cg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const wg::Turns turns{cg};
  const int rw = q0 + 64 * cg;
  const int row_lo = rw + 16 * wq + g;            // rows row_lo, row_lo + 8
  // P = exp(s*scale - lse), taken as 2^(s*scale*log2 e - lse*log2 e)
  const float scale_log2 = scale * wg::kLog2e;
  float lse_log2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    lse_log2[r] = row < S ? lse[(size_t)bh * S + row] * wg::kLog2e : 0.f;
    delta_r[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_own = smem_addr(Qs) + cg * 64 * 128;
  const uint32_t do_own = smem_addr(dOs) + cg * 64 * 128;
  mbar_wait(&bars[0], 0);
  if (cg == 1) turns.pass();

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt % wg::kStages;
    const int j0 = jt * wg::kWalk;
    const bool last_turn = cg == 1 && jt + 1 == n_tiles;
    const uint32_t k_s = smem_addr(stages + st * L::kStageBytes);
    const uint32_t v_s = k_s + L::kWalkBytes;
    mbar_wait(&full[st], (jt / wg::kStages) & 1);
    __syncwarp();  // wgmma needs the warp converged
    if (rw < S && !(causal && j0 > rw)) {
      float s[32], dp[32];
      turns.wait();
      wg::score_products<HD>(s, dp, q_own, do_own, k_s, v_s, L::kOwnBox);
      turns.pass();
      wgmma_wait<0>();
      wgmma_fence_operand(s);
      wgmma_fence_operand(dp);
      // dS = P*(dP - delta)*scale, rounded to bf16 pairs; the mask only on
      // the diagonal and tail tiles (EDGE)
      uint32_t da[4][4];
      auto probs = [&](auto edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float p = wg::exp2_approx(
                fmaf(s[i], scale_log2, -lse_log2[e >> 1]));
            ds[e] = p * (dp[i] - delta_r[e >> 1]) * scale;
            if constexpr (decltype(edge)::value) {
              const int row = row_lo + 8 * (e >> 1);
              const int key = j0 + 8 * j + 2 * t + (e & 1);
              if (key >= S || (causal && row < key)) ds[e] = 0.f;
            }
          }
          da[j / 2][2 * (j % 2)] = wg::pack_rn(ds[0], ds[1]);
          da[j / 2][2 * (j % 2) + 1] = wg::pack_rn(ds[2], ds[3]);
        }
      };
      if ((causal && j0 == rw) || j0 + wg::kWalk > S) {
        probs(std::true_type{});
      } else {
        probs(std::false_type{});
      }
      turns.wait();
      wgmma_fence();
      wg::walk_product<HD, wg::kWalk>(acc, da, k_s);         // dQ += dS.K
      wgmma_commit();
      if (!last_turn) turns.pass();
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
    } else {                                      // nothing visible
      turns.wait();
      turns.pass();
      turns.wait();
      if (!last_turn) turns.pass();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  wg::store_rows<HD>(dq, acc, row_lo, S, H, b, h);
}

// dK, dV: a CTA owns 128 key rows and walks 64-query tiles.
template <int HD>
__global__ void __launch_bounds__(wg::kThreadsDkv, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int BH, int S,
                           int H, float scale, int causal) {
  using L = wg::Layout<HD, true>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = wg::align1024(smem_raw);
  unsigned char* Vs = Ks + L::kOwnBytes;
  unsigned char* stages = Vs + L::kOwnBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + wg::kStages * L::kStageBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int ntiles = (S + wg::kOwn - 1) / wg::kOwn;
  int rank, bh;
  wg::raster(BH, ntiles, rank, bh);
  const int b = bh / H, h = bh % H, col = h * HD;
  const int k0 = rank * wg::kOwn;                 // the first keys walk most
  const int nq = (S + wg::kWalk - 1) / wg::kWalk;
  const int first = causal ? k0 / wg::kWalk : 0;
  const int n_tiles = nq - first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wg::init_bars(bars, 33);

  // warp 0 fills the ring, the first tile now and each next one a tile
  // ahead, into the stage that tile - 2 left: its thread 0 issues the TMA
  // loads (K and V once, Q and dO tiles), each lane copies two of the
  // tile's lse and delta rows (zeros past S) with cp.async
  auto fill = [&](int n) {
    const int st = n % wg::kStages;
    unsigned char* base = stages + st * L::kStageBytes;
    const int q0 = (first + n) * wg::kWalk;
    float* stats = reinterpret_cast<float*>(base + L::kTx);
    for (int r = lane; r < wg::kWalk; r += 32) {
      const bool in = q0 + r < S;
      const size_t at = in ? (size_t)bh * S + q0 + r : 0;
      cp_async4(stats + r, lse + at, in);
      cp_async4(stats + wg::kWalk + r, delta + at, in);
    }
    cp_async_mbar_arrive(&full[st]);
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[st], L::kTx);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(base + c * wg::kWalkBox, &tm_q, &full[st], col + 64 * c,
                    q0, b);
        tma_load_3d(base + L::kWalkBytes + c * wg::kWalkBox, &tm_do,
                    &full[st], col + 64 * c, q0, b);
      }
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&bars[0], 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_3d(Ks + c * L::kOwnBox, &tm_k, &bars[0], col + 64 * c, k0,
                    b);
        tma_load_3d(Vs + c * L::kOwnBox, &tm_v, &bars[0], col + 64 * c, k0,
                    b);
      }
    }
    fill(0);
  }

  // warpgroup cg owns keys [kw, kw + 64)
  const int cg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const wg::Turns turns{cg};
  const int kw = k0 + 64 * cg;
  const int key_lo = kw + 16 * wq + g;            // keys key_lo, key_lo + 8
  const float scale_log2 = scale * wg::kLog2e;    // as in the dQ kernel
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t k_own = smem_addr(Ks) + cg * 64 * 128;
  const uint32_t v_own = smem_addr(Vs) + cg * 64 * 128;
  mbar_wait(&bars[0], 0);
  if (cg == 1) turns.pass();

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % wg::kStages;
    if (warp == 0 && n + 1 < n_tiles) {
      if (n >= 2) mbar_wait(&empty[(n + 1) % wg::kStages],
                            ((n - 2) / wg::kStages) & 1);
      fill(n + 1);
    }
    __syncwarp();
    const int q0 = (first + n) * wg::kWalk;
    const bool last_turn = cg == 1 && n + 1 == n_tiles;
    const unsigned char* base = stages + st * L::kStageBytes;
    const uint32_t q_s = smem_addr(base), do_s = q_s + L::kWalkBytes;
    mbar_wait(&full[st], (n / wg::kStages) & 1);
    __syncwarp();  // wgmma needs the warp converged
    if (kw < S && !(causal && q0 < kw)) {
      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries
      float s[32], dp[32];
      turns.wait();
      wg::score_products<HD>(s, dp, k_own, v_own, q_s, do_s, L::kOwnBox);
      turns.pass();
      const float* lse_s = reinterpret_cast<const float*>(base + L::kTx);
      const float* delta_s = lse_s + wg::kWalk;
      wgmma_wait<0>();
      wgmma_fence_operand(s);
      wgmma_fence_operand(dp);
      // P^T and dS^T rounded to bf16 pairs; the mask only on the diagonal
      // and tail tiles (EDGE)
      uint32_t pa[4][4], da[4][4];
      auto probs = [&](auto edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
          const float l_log2[2] = {l2.x * wg::kLog2e, l2.y * wg::kLog2e};
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float d = (e & 1) ? d2.y : d2.x;
            p[e] = wg::exp2_approx(fmaf(s[i], scale_log2, -l_log2[e & 1]));
            ds[e] = p[e] * (dp[i] - d) * scale;
            if constexpr (decltype(edge)::value) {
              const int key = key_lo + 8 * (e >> 1);
              const int query = q0 + c + (e & 1);
              if (query >= S || (causal && query < key)) p[e] = ds[e] = 0.f;
            }
          }
          pa[j / 2][2 * (j % 2)] = wg::pack_rn(p[0], p[1]);
          pa[j / 2][2 * (j % 2) + 1] = wg::pack_rn(p[2], p[3]);
          da[j / 2][2 * (j % 2)] = wg::pack_rn(ds[0], ds[1]);
          da[j / 2][2 * (j % 2) + 1] = wg::pack_rn(ds[2], ds[3]);
        }
      };
      if ((causal && q0 == kw) || q0 + wg::kWalk > S) {
        probs(std::true_type{});
      } else {
        probs(std::false_type{});
      }
      turns.wait();
      wgmma_fence();
      wg::walk_product<HD, wg::kWalk>(acc_v, pa, do_s);      // dV += P^T.dO
      wg::walk_product<HD, wg::kWalk>(acc_k, da, q_s);       // dK += dS^T.Q
      wgmma_commit();
      if (!last_turn) turns.pass();
      wgmma_wait<0>();
      wgmma_fence_operand(acc_v);
      wgmma_fence_operand(acc_k);
    } else {                                      // nothing visible
      turns.wait();
      turns.pass();
      turns.wait();
      if (!last_turn) turns.pass();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  wg::store_rows<HD>(dk, acc_k, key_lo, S, H, b, h);
  wg::store_rows<HD>(dv, acc_v, key_lo, S, H, b, h);
}

template <int HD>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int S, int H,
                           float scale, int causal, cudaStream_t stream) {
  using L = wg::Layout<HD, false>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // encoded every call: the caching allocator reuses addresses
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_rows(enc, &tm_q, q, B, S, H, HD, wg::kOwn) ||
      !encode_rows(enc, &tm_do, dout, B, S, H, HD, wg::kOwn) ||
      !encode_rows(enc, &tm_k, k, B, S, H, HD, wg::kWalk) ||
      !encode_rows(enc, &tm_v, v, B, S, H, HD, wg::kWalk))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = B * H * ((S + wg::kOwn - 1) / wg::kOwn);
  kern<<<blocks, wg::kThreadsDq, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      B * H, S, H, scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int S, int H, float scale, int causal,
                            cudaStream_t stream) {
  using L = wg::Layout<HD, true>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_rows(enc, &tm_q, q, B, S, H, HD, wg::kWalk) ||
      !encode_rows(enc, &tm_do, dout, B, S, H, HD, wg::kWalk) ||
      !encode_rows(enc, &tm_k, k, B, S, H, HD, wg::kOwn) ||
      !encode_rows(enc, &tm_v, v, B, S, H, HD, wg::kOwn))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = B * H * ((S + wg::kOwn - 1) / wg::kOwn);
  kern<<<blocks, wg::kThreadsDkv, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      B * H, S, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int hd,
    float scale, int causal, int dtype, void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  if (!fits(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_dq_bf16<128>(q, k, v, dout, l, d, dq, B, S, H, scale,
                                 causal, st);
    if (hd == 64)
      return launch_dq_bf16<64>(q, k, v, dout, l, d, dq, B, S, H, scale,
                                causal, st);
    if (hd == 256)
      return launch_dq_exact<__nv_bfloat16, 256>(q, k, v, dout, l, d, dq, B,
                                                 S, H, scale, causal, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_dq_exact<float, 128>(q, k, v, dout, l, d, dq, B, S, H,
                                         scale, causal, st);
    if (hd == 64)
      return launch_dq_exact<float, 64>(q, k, v, dout, l, d, dq, B, S, H,
                                        scale, causal, st);
    if (hd == 256)
      return launch_dq_exact<float, 256>(q, k, v, dout, l, d, dq, B, S, H,
                                         scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int hd, float scale, int causal, int dtype, void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  if (!fits(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_dkv_bf16<128>(q, k, v, dout, l, d, dk, dv, B, S, H,
                                  scale, causal, st);
    if (hd == 64)
      return launch_dkv_bf16<64>(q, k, v, dout, l, d, dk, dv, B, S, H, scale,
                                 causal, st);
    if (hd == 256)
      return launch_dkv_exact<__nv_bfloat16, 256>(q, k, v, dout, l, d, dk, dv,
                                                  B, S, H, scale, causal, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_dkv_exact<float, 128>(q, k, v, dout, l, d, dk, dv, B, S,
                                          H, scale, causal, st);
    if (hd == 64)
      return launch_dkv_exact<float, 64>(q, k, v, dout, l, d, dk, dv, B, S, H,
                                         scale, causal, st);
    if (hd == 256)
      return launch_dkv_exact<float, 256>(q, k, v, dout, l, d, dk, dv, B, S,
                                          H, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
