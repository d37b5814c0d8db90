// Block-sparse attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py::_bs_dq_kernel
//     (dQ, walking the layout)
//   deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py::_bs_dkv_kernel
//     (dK, dV, walking the transposed layout)
// driven by _bs_bwd_rule, the backward of _bs_attn's custom_vjp. Both
// recompute the probabilities from the forward's row log-sum-exp:
//     P  = exp(Q.K^T * scale - lse)      (0 for keys at positions >= S)
//     dS = P * (dO.V^T - delta) * scale  delta = rowsum(dO * O), float32,
//                                        computed outside, as the reference
//     dQ = dS.K        dK = dS^T.Q        dV = P^T.dO
// over the blocks set in the layout only. Query rows at positions >= S
// add nothing (the reference pads them with zero dO, so their dS and P^T.dO
// are 0); here they are masked.
//
// Layouts as the forward (block_sparse_attention_fwd.cu): q, k, v, dO and
// the gradients [B, H, S, hd]; lse and delta [B, H, S] float32; element
// type float32 or bfloat16, hd in {64, 128, 256}, block in {16, 32, 64,
// 128}; the layout as CSR lists of active blocks, row lh*nq + iq of the
// layout for dQ and row lh*nk + jk of the transposed layout for dK/dV.
//
// bfloat16 at blocks 64 and 128 and hd 64 and 128, the training path's
// shapes: TMA + wgmma kernels, after the dense ones of
// flash_attention_bwd.cu, mirror images of each other. A CTA of two
// warpgroups owns 64 rows of one (batch, head) and walks the 64-row tiles
// of the other side that its block's list names (block / 64 tiles an
// entry), loaded by TMA from [B*H, S, hd] tensor maps (a box never crosses
// a head; rows past S arrive as zeros; 128-byte swizzle). The warpgroups
// take the tiles in turn, each through its own ring of two stages that
// its first warp fills a tile ahead (a shared ring stalled one warpgroup
// on the other), and run side by side (taking turns at the tensor cores,
// as the dense kernels do, measured 1-2% slower for dK/dV). Per tile a
// warpgroup issues its two score products (wgmma m64n64k16, both operands
// in shared memory), forms P = 2^(s*scale*log2 e - lse*log2 e) on
// ex2.approx and dS in float32 registers, masks the other side's rows past
// S on the tail tile only, rounds to bf16 once and feeds the result from
// registers as the A operand of its second products. The two warpgroups'
// sums are folded once at the end through shared memory (one float32
// addition), so every float32 sum runs in a fixed order and two calls give
// the same bits. CTAs take their tiles in order, in raster groups of 16
// (batch, head) pairs (heaviest lists first, or groups of 4, 8 or 32,
// measured no faster for dK/dV; reversed order and groups of 4 or 8
// slower for dQ).
//   * dQ (bs_dq_wgmma_kernel): the CTA owns 64 query rows, Q and dO
//     resident and its rows' lse and delta in registers, and walks the key
//     tiles of its q-block's layout row; S = Q.K^T, dP = dO.V^T, dQ +=
//     dS.K (K N-major). Each warpgroup stores half of dQ's columns after
//     the fold. A row with an empty list writes dQ = 0.
//   * dK/dV (bs_dkv_wgmma_kernel): the CTA owns 64 key rows, K and V
//     resident, and walks the query tiles of its k-block's transposed-
//     layout row, with each tile's lse and delta rows copied by cp.async
//     beside it; S^T = K.Q^T and dP^T = V.dO^T, so each warpgroup's
//     accumulator rows are its own keys, then dV += P^T.dO and dK +=
//     dS^T.Q.
//
// Float32, blocks 16 and 32, and hd 256 keep the exact kernels below. As
// in the forward, a CUDA block owns TILE = min(block, 64) rows of one
// (batch, head) (32 for float32 at hd 256, where 64 rows do not fit shared
// memory) and walks its own list, in chunks of TILE, so nothing carries
// across CUDA blocks and no atomics are needed:
//   * dQ: a CUDA block owns TILE query rows of a q-block and walks the
//     k-blocks of its layout row;
//   * dK/dV: a CUDA block owns TILE key rows of a k-block and walks the
//     q-blocks of its transposed-layout row, computing the transposed tiles
//     S^T = K.Q^T and dP^T = V.dO^T directly, so that each warp's
//     accumulator rows are its own key rows.
// Products run on the tensor cores for bfloat16 (float32 sums) and as
// exact float32 FMAs for float32 inputs (tile_mma.cuh). With bfloat16
// inputs P and dS are rounded to bfloat16 for the dQ, dK and dV products
// (relative error <= 2^-9 per term), as the wgmma kernels do. At hd 256 a
// thread holds 128 (dQ) or 256 (dK/dV) accumulator floats and ptxas spills
// (PERF.md); speed there is later work.
//
// Bound on this card: operations; per (query, key) pair of an active block
// and head, dQ does 6*hd flops (Q.K^T, dO.V^T, dS.K) and dK/dV 8*hd (Q.K^T,
// dO.V^T, P^T.dO, dS^T.Q), against 989 TFLOP/s dense bfloat16.
#include <type_traits>

#include "flash_wgmma.cuh"

namespace dstorch {
namespace {

template <typename T, int HD, int TILE>
constexpr size_t bs_dq_smem_bytes() {
  return sizeof(T) * (4 * TILE * (HD + kPad<T>) + TILE * (TILE + kPad<T>));
}

template <typename T, int HD, int TILE>
constexpr size_t bs_dkv_smem_bytes() {
  return sizeof(T) *
             (4 * TILE * (HD + kPad<T>) + 2 * TILE * (TILE + kPad<T>)) +
         sizeof(float) * 2 * TILE;
}

// --------------------------------------------------------------------- //
// dQ (K18)
// --------------------------------------------------------------------- //
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
bs_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, const int* __restrict__ row_ptr,
             const int* __restrict__ cols, int S, int H, int LH, int nq,
             int blk, float scale) {
  constexpr int NTHREADS = 2 * TILE;
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = TILE + kPad<T>;
  constexpr int NT_S = TILE / 8;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE * LD;
  T* Ks = dOs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  T* dSs = Vs + TILE * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const int row = (LH == 1 ? 0 : h) * nq + q0 / blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = ((size_t)b * H + h) * S * HD;
  const size_t stat = ((size_t)b * H + h) * S;

  load_tile<T, TILE, HD, NTHREADS>(Qs, LD, q + base + (size_t)q0 * HD, HD,
                                   S - q0);
  load_tile<T, TILE, HD, NTHREADS>(dOs, LD, dout + base + (size_t)q0 * HD,
                                   HD, S - q0);
  const int row_lo = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row_lo + 8 * r;
    lse_r[r] = qr < S ? lse[stat + qr] : 0.f;
    delta_r[r] = qr < S ? delta[stat + qr] : 0.f;
  }

  float acc[1][NT_O][4];
  zero_acc(acc);
  T* dSw = dSs + warp * 16 * LDP;
  const int begin = row_ptr[row], end = row_ptr[row + 1];
  for (int a = begin; a < end; ++a) {
    const int kb0 = cols[a] * blk;
    for (int j0 = kb0; j0 < kb0 + blk; j0 += TILE) {
      __syncthreads();
      load_tile<T, TILE, HD, NTHREADS>(Ks, LD, k + base + (size_t)j0 * HD, HD,
                                       S - j0);
      load_tile<T, TILE, HD, NTHREADS>(Vs, LD, v + base + (size_t)j0 * HD, HD,
                                       S - j0);
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
          const int qr = row_lo + 8 * (e >> 1);
          const int col = j0 + 8 * nt + 2 * t + (e & 1);
          const bool ok = qr < S && col < S;
          const float p =
              ok ? expf(s[0][nt][e] * scale - lse_r[e >> 1]) : 0.f;
          ds[e] = p * (dp[0][nt][e] - delta_r[e >> 1]) * scale;
        }
        store_pair(dSw + g * LDP + 8 * nt + 2 * t, ds[0], ds[1]);
        store_pair(dSw + (g + 8) * LDP + 8 * nt + 2 * t, ds[2], ds[3]);
      }
      __syncwarp();
      warp_mma<1, NT_O, true, false>(acc, dSw, LDP, Ks, LD, TILE);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row_lo + 8 * r;
    if (qr >= S) continue;
    T* out = dq + base + (size_t)qr * HD;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(out + 8 * nt + 2 * t, acc[0][nt][2 * r],
                 acc[0][nt][2 * r + 1]);
    }
  }
}

// --------------------------------------------------------------------- //
// dK, dV (K19)
// --------------------------------------------------------------------- //
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
bs_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv,
              const int* __restrict__ row_ptr_t,
              const int* __restrict__ cols_t, int S, int H, int LH, int nk,
              int blk, float scale) {
  constexpr int NTHREADS = 2 * TILE;
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = TILE + kPad<T>;
  constexpr int NT_S = TILE / 8;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE * LD;
  T* Qs = Vs + TILE * LD;
  T* dOs = Qs + TILE * LD;
  T* PTs = dOs + TILE * LD;
  T* dSTs = PTs + TILE * LDP;
  float* lse_s = reinterpret_cast<float*>(dSTs + TILE * LDP);
  float* delta_s = lse_s + TILE;

  const int h = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * TILE;
  const int row = (LH == 1 ? 0 : h) * nk + j0 / blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = ((size_t)b * H + h) * S * HD;
  const size_t stat = ((size_t)b * H + h) * S;

  load_tile<T, TILE, HD, NTHREADS>(Ks, LD, k + base + (size_t)j0 * HD, HD,
                                   S - j0);
  load_tile<T, TILE, HD, NTHREADS>(Vs, LD, v + base + (size_t)j0 * HD, HD,
                                   S - j0);

  float acc_k[1][NT_O][4], acc_v[1][NT_O][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  const int key_lo = j0 + warp * 16 + g;          // keys key_lo, key_lo + 8
  T* PTw = PTs + warp * 16 * LDP;
  T* dSTw = dSTs + warp * 16 * LDP;
  const int begin = row_ptr_t[row], end = row_ptr_t[row + 1];
  for (int a = begin; a < end; ++a) {
    const int qb0 = cols_t[a] * blk;
    for (int q0 = qb0; q0 < qb0 + blk; q0 += TILE) {
      __syncthreads();
      load_tile<T, TILE, HD, NTHREADS>(Qs, LD, q + base + (size_t)q0 * HD,
                                       HD, S - q0);
      load_tile<T, TILE, HD, NTHREADS>(dOs, LD,
                                       dout + base + (size_t)q0 * HD, HD,
                                       S - q0);
      if (threadIdx.x < TILE) {
        const int qr = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qr < S ? lse[stat + qr] : 0.f;
        delta_s[threadIdx.x] = qr < S ? delta[stat + qr] : 0.f;
      }
      __syncthreads();

      float st[1][NT_S][4], dpt[1][NT_S][4];
      zero_acc(st);
      zero_acc(dpt);
      // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries
      warp_mma<1, NT_S, true, true>(st, Ks + warp * 16 * LD, LD, Qs, LD, HD);
      warp_mma<1, NT_S, true, true>(dpt, Vs + warp * 16 * LD, LD, dOs, LD,
                                    HD);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e >> 1);
          const int ci = 8 * nt + 2 * t + (e & 1);
          const bool ok = q0 + ci < S && key < S;
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
      warp_mma<1, NT_O, true, false>(acc_v, PTw, LDP, dOs, LD, TILE);
      warp_mma<1, NT_O, true, false>(acc_k, dSTw, LDP, Qs, LD, TILE);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    T* ok_ = dk + base + (size_t)key * HD;
    T* ov_ = dv + base + (size_t)key * HD;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(ok_ + 8 * nt + 2 * t, acc_k[0][nt][2 * r],
                 acc_k[0][nt][2 * r + 1]);
      store_pair(ov_ + 8 * nt + 2 * t, acc_v[0][nt][2 * r],
                 acc_v[0][nt][2 * r + 1]);
    }
  }
}

}  // namespace

// --------------------------------------------------------------------- //
// dK, dV (K19), bfloat16 at blocks 64 and 128: TMA + wgmma
// --------------------------------------------------------------------- //
namespace wg {
namespace {
constexpr int kKeys = 64;                 // keys a CTA owns
constexpr int kWalk = 64;                 // query rows of a walked tile
constexpr int kRing = 2;                  // stages a warpgroup fills ahead
constexpr int kStages = kGroups * kRing;
constexpr int kThreadsDkv = kGroups * 128;

template <int HD>
struct DkvLayout {
  static constexpr int kTile = HD / kBoxCols * kBox64;  // one [64 x HD] tile
  static constexpr int kStats = 2 * kWalk * 4;          // lse and delta rows
  static constexpr int kTx = 2 * kTile;                 // Q and dO by TMA
  static constexpr int kStageBytes = (kTx + kStats + 1023) / 1024 * 1024;
  static constexpr int kFold = 2 * 128 * (HD / 2) * 4;  // a dK and a dV set
  static constexpr int kRingBytes =
      kStages * kStageBytes > kFold ? kStages * kStageBytes : kFold;
  static constexpr int kBars = 1 + 2 * kStages;         // owned, full, empty
  static constexpr int kSmem = 2 * kTile + kRingBytes + 8 * kBars + 1024;
};

// K18: a CTA owns 64 query rows (Q and dO resident); a stage holds a
// walked key tile's K and V
template <int HD>
struct DqLayout {
  static constexpr int kTile = HD / kBoxCols * kBox64;  // one [64 x HD] tile
  static constexpr int kTx = 2 * kTile;                 // K and V by TMA
  static constexpr int kStageBytes = kTx;               // 1024-aligned
  static constexpr int kFold = 2 * 128 * (HD / 4) * 4;  // two halves of dQ
  static constexpr int kRingBytes =
      kStages * kStageBytes > kFold ? kStages * kStageBytes : kFold;
  static constexpr int kBars = 1 + 2 * kStages;         // owned, full, empty
  static constexpr int kSmem = 2 * kTile + kRingBytes + 8 * kBars + 1024;
};

}  // namespace
}  // namespace wg

namespace {

// K18: a CTA owns 64 query rows of one (batch, head), Q and dO resident in
// shared memory and its rows' lse and delta in registers, and walks the
// 64-row key tiles of its q-block's layout list (blk / 64 tiles an
// entry); its two warpgroups take the tiles in turn (warpgroup g the
// tiles n with n % 2 == g), each through its own ring of kRing stages that
// one thread of its first warp fills a tile ahead by TMA (K and V), and
// fold their sums at the end: dQ = dQ_0 + dQ_1, warpgroup 0 storing
// columns [0, HD/2) and warpgroup 1 the rest. CTAs take the query tiles in
// order, in raster groups of kHeadGroup (batch, head) pairs.
template <int HD>
__global__ void __launch_bounds__(wg::kThreadsDkv, 1)
bs_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ cols, int BH, int S, int H,
                   int LH, int nq, int blk, float scale) {
  using L = wg::DqLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = wg::align1024(smem_raw);
  unsigned char* dOs = Qs + L::kTile;
  unsigned char* stages = dOs + L::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + L::kRingBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int per = blk / wg::kWalk;                // tiles a list entry
  int rank, bh;
  wg::raster(BH, nq * per, rank, bh);
  const int lh = LH == 1 ? 0 : bh % H;
  const int q0 = rank * wg::kWalk;
  if (q0 >= S) return;                            // rows past S: no output
  const int row = lh * nq + q0 / blk;
  const int begin = row_ptr[row];
  const int n_tiles = (row_ptr[row + 1] - begin) * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp / 4, wq = warp % 4;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                       // Q and dO
    for (int i = 0; i < wg::kStages; ++i) {
      mbar_init(&full[i], 1);                     // the expect-tx
      mbar_init(&empty[i], 4);                    // the warpgroup's warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warpgroup cg's j-th tile is tile 2 j + cg of the walk, in its stage
  // cg * kRing + j % kRing; one thread of its first warp fills it
  auto stage_of = [&](int j) { return cg * wg::kRing + j % wg::kRing; };
  auto k_row = [&](int n) {
    return cols[begin + n / per] * blk + wg::kWalk * (n % per);
  };
  auto fill = [&](int j) {
    const int st = stage_of(j);
    unsigned char* base = stages + st * L::kStageBytes;
    const int k0 = k_row(2 * j + cg);
    mbar_arrive_expect_tx(&full[st], L::kTx);
    for (int c = 0; c < HD / wg::kBoxCols; ++c) {
      tma_load_3d(base + c * wg::kBox64, &tm_k, &full[st], 64 * c, k0, bh);
      tma_load_3d(base + L::kTile + c * wg::kBox64, &tm_v, &full[st],
                  64 * c, k0, bh);
    }
  };
  const int mine = (n_tiles - cg + 1) / 2;        // tiles of this warpgroup
  const bool filler = wq == 0 && lane == 0;
  if (filler) {
    if (cg == 0) {
      mbar_arrive_expect_tx(&bars[0], 2 * L::kTile);
      for (int c = 0; c < HD / wg::kBoxCols; ++c) {
        tma_load_3d(Qs + c * wg::kBox64, &tm_q, &bars[0], 64 * c, q0, bh);
        tma_load_3d(dOs + c * wg::kBox64, &tm_do, &bars[0], 64 * c, q0, bh);
      }
    }
    if (mine > 0) fill(0);
  }

  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * wq + g;            // rows row_lo, row_lo + 8
  // P = exp(s*scale - lse), taken as 2^(s*scale*log2 e - lse*log2 e); rows
  // past S read Q and dO as zeros and lse and delta as 0, so their dS is 0
  const float scale_log2 = scale * wg::kLog2e;
  float lse_log2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row_lo + 8 * r;
    lse_log2[r] = qr < S ? lse[(size_t)bh * S + qr] * wg::kLog2e : 0.f;
    delta_r[r] = qr < S ? delta[(size_t)bh * S + qr] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_own = smem_addr(Qs), do_own = smem_addr(dOs);
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < mine; ++j) {
    const int st = stage_of(j);
    if (filler && j + 1 < mine) {
      if (j + 1 >= wg::kRing)
        mbar_wait(&empty[stage_of(j + 1)],
                  ((j + 1 - wg::kRing) / wg::kRing) & 1);
      fill(j + 1);
    }
    __syncwarp();
    const int k0 = k_row(2 * j + cg);
    const uint32_t k_s = smem_addr(stages + st * L::kStageBytes);
    const uint32_t v_s = k_s + L::kTile;
    mbar_wait(&full[st], (j / wg::kRing) & 1);
    __syncwarp();  // wgmma needs the warp converged
    // S = Q.K^T and dP = dO.V^T: rows are queries, columns keys
    float s[32], dp[32];
    wg::score_products<HD>(s, dp, q_own, do_own, k_s, v_s, wg::kBox64);
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    wgmma_fence_operand(dp);
    // dS = P*(dP - delta)*scale rounded to bf16 pairs; keys at or past S
    // masked on the tail tile only
    uint32_t da[4][4];
    auto probs = [&](auto edge) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const float p = wg::exp2_approx(
              fmaf(s[i], scale_log2, -lse_log2[e >> 1]));
          ds[e] = p * (dp[i] - delta_r[e >> 1]) * scale;
          if constexpr (decltype(edge)::value) {
            if (k0 + 8 * jj + 2 * t + (e & 1) >= S) ds[e] = 0.f;
          }
        }
        da[jj / 2][2 * (jj % 2)] = wg::pack_rn(ds[0], ds[1]);
        da[jj / 2][2 * (jj % 2) + 1] = wg::pack_rn(ds[2], ds[3]);
      }
    };
    if (k0 + wg::kWalk > S) {
      probs(std::true_type{});
    } else {
      probs(std::false_type{});
    }
    wgmma_fence();
    wg::walk_product<HD, wg::kWalk>(acc, da, k_s);         // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the fold, in shared memory the ring no longer uses: each warpgroup
  // hands over the half of its dQ the other stores and adds the other's
  // half to its own (one float32 addition, dQ_0 + dQ_1)
  constexpr int kHalf = HD / 4;                   // floats of half of dQ
  __syncthreads();
  float* fold = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x % 128;
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) fold[(kHalf + i) * 128 + tid] =
        acc[kHalf + i];
  } else {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) fold[i * 128 + tid] = acc[i];
  }
  __syncthreads();
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      acc[i] = __fadd_rn(acc[i], fold[i * 128 + tid]);
    wg::store_bhsd<HD, 0, HD / 16>(dq, acc, row_lo, S, bh);
  } else {
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      acc[kHalf + i] = __fadd_rn(fold[(kHalf + i) * 128 + tid],
                                 acc[kHalf + i]);
    wg::store_bhsd<HD, HD / 16, HD / 8>(dq, acc, row_lo, S, bh);
  }
}

// A CTA owns 64 key rows of one (batch, head), K and V resident in shared
// memory, and walks the 64-row query tiles of its k-block's transposed-
// layout list (blk / 64 tiles an entry); its two warpgroups take the tiles
// in turn (warpgroup g the tiles n with n % 2 == g), each filling its own
// ring of kRing stages a tile ahead (its first warp: one thread issues the
// TMA loads of Q and dO, the lanes copy the tile's lse and delta rows with
// cp.async), and fold their sums at the end: dK = dK_0 + dK_1, dV = dV_0 +
// dV_1. CTAs take the key tiles in order, in raster groups of
// kHeadGroup (batch, head) pairs.
template <int HD>
__global__ void __launch_bounds__(wg::kThreadsDkv, 1)
bs_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    const int* __restrict__ row_ptr_t,
                    const int* __restrict__ cols_t, int BH, int S, int H,
                    int LH, int nk, int blk, float scale) {
  using L = wg::DkvLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = wg::align1024(smem_raw);
  unsigned char* Vs = Ks + L::kTile;
  unsigned char* stages = Vs + L::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + L::kRingBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int per = blk / wg::kWalk;                // tiles a list entry
  const int key_tiles = nk * per;                 // a layout head's
  int rank, bh;
  wg::raster(BH, key_tiles, rank, bh);
  const int lh = LH == 1 ? 0 : bh % H;
  const int k0 = rank * wg::kKeys;
  if (k0 >= S) return;                            // keys past S: no output
  const int row = lh * nk + k0 / blk;
  const int begin = row_ptr_t[row];
  const int n_tiles = (row_ptr_t[row + 1] - begin) * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp / 4, wq = warp % 4;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                       // K and V
    for (int i = 0; i < wg::kStages; ++i) {
      mbar_init(&full[i], 33);        // the expect-tx and 32 lanes' copies
      mbar_init(&empty[i], 4);        // the filling warpgroup's warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warpgroup cg's j-th tile is tile 2 j + cg of the walk, in its stage
  // cg * kRing + j % kRing
  auto stage_of = [&](int j) { return cg * wg::kRing + j % wg::kRing; };
  auto q_row = [&](int n) {
    return cols_t[begin + n / per] * blk + wg::kWalk * (n % per);
  };
  // the first warp of warpgroup cg fills its j-th tile
  auto fill = [&](int j) {
    const int n = 2 * j + cg;
    const int st = stage_of(j);
    unsigned char* base = stages + st * L::kStageBytes;
    const int q0 = q_row(n);
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
      for (int c = 0; c < HD / wg::kBoxCols; ++c) {
        tma_load_3d(base + c * wg::kBox64, &tm_q, &full[st], 64 * c, q0, bh);
        tma_load_3d(base + L::kTile + c * wg::kBox64, &tm_do, &full[st],
                    64 * c, q0, bh);
      }
    }
  };
  const int mine = (n_tiles - cg + 1) / 2;        // tiles of this warpgroup
  if (wq == 0) {
    if (cg == 0 && lane == 0) {
      mbar_arrive_expect_tx(&bars[0], 2 * L::kTile);
      for (int c = 0; c < HD / wg::kBoxCols; ++c) {
        tma_load_3d(Ks + c * wg::kBox64, &tm_k, &bars[0], 64 * c, k0, bh);
        tma_load_3d(Vs + c * wg::kBox64, &tm_v, &bars[0], 64 * c, k0, bh);
      }
    }
    if (mine > 0) fill(0);
  }

  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + 16 * wq + g;            // keys key_lo, key_lo + 8
  const float scale_log2 = scale * wg::kLog2e;
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t k_own = smem_addr(Ks), v_own = smem_addr(Vs);
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < mine; ++j) {
    const int st = stage_of(j);
    if (wq == 0 && j + 1 < mine) {
      if (j + 1 >= wg::kRing)
        mbar_wait(&empty[stage_of(j + 1)],
                  ((j + 1 - wg::kRing) / wg::kRing) & 1);
      fill(j + 1);
    }
    __syncwarp();
    const int q0 = q_row(2 * j + cg);
    const unsigned char* base = stages + st * L::kStageBytes;
    const uint32_t q_s = smem_addr(base), do_s = q_s + L::kTile;
    mbar_wait(&full[st], (j / wg::kRing) & 1);
    __syncwarp();  // wgmma needs the warp converged
    // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries
    float s[32], dp[32];
    wg::score_products<HD>(s, dp, k_own, v_own, q_s, do_s, wg::kBox64);
    const float* lse_s = reinterpret_cast<const float*>(base + L::kTx);
    const float* delta_s = lse_s + wg::kWalk;
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    wgmma_fence_operand(dp);
    // P^T and dS^T rounded to bf16 pairs; queries at or past S masked on
    // the tail tile only
    uint32_t pa[4][4], da[4][4];
    auto probs = [&](auto edge) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
        const float l_log2[2] = {l2.x * wg::kLog2e, l2.y * wg::kLog2e};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const float d = (e & 1) ? d2.y : d2.x;
          p[e] = wg::exp2_approx(fmaf(s[i], scale_log2, -l_log2[e & 1]));
          ds[e] = p[e] * (dp[i] - d) * scale;
          if constexpr (decltype(edge)::value) {
            if (q0 + c + (e & 1) >= S) p[e] = ds[e] = 0.f;
          }
        }
        pa[jj / 2][2 * (jj % 2)] = wg::pack_rn(p[0], p[1]);
        pa[jj / 2][2 * (jj % 2) + 1] = wg::pack_rn(p[2], p[3]);
        da[jj / 2][2 * (jj % 2)] = wg::pack_rn(ds[0], ds[1]);
        da[jj / 2][2 * (jj % 2) + 1] = wg::pack_rn(ds[2], ds[3]);
      }
    };
    if (q0 + wg::kWalk > S) {
      probs(std::true_type{});
    } else {
      probs(std::false_type{});
    }
    wgmma_fence();
    wg::walk_product<HD, wg::kWalk>(acc_v, pa, do_s);      // dV += P^T.dO
    wg::walk_product<HD, wg::kWalk>(acc_k, da, q_s);       // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(acc_v);
    wgmma_fence_operand(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the fold, in shared memory the ring no longer uses: warpgroup 1 hands
  // over its dK, warpgroup 0 its dV; each adds the other's (one float32
  // addition, the same bits in either order) and stores
  __syncthreads();
  float* fold = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x % 128;
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) fold[(HD / 2 + i) * 128 + tid] = acc_v[i];
  } else {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) fold[i * 128 + tid] = acc_k[i];
  }
  __syncthreads();
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      acc_k[i] = __fadd_rn(acc_k[i], fold[i * 128 + tid]);
    wg::store_bhsd<HD>(dk, acc_k, key_lo, S, bh);
  } else {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      acc_v[i] = __fadd_rn(fold[(HD / 2 + i) * 128 + tid], acc_v[i]);
    wg::store_bhsd<HD>(dv, acc_v, key_lo, S, bh);
  }
}

// One argument list for both kernels: dq_or_dk is dQ (K18) or dK (K19),
// dv is null for K18; the CSR lists are the layout's (K18) or the
// transposed layout's (K19), n_rows its nq or nk.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq_or_dk, *dv;
  const int *row_ptr, *cols;
  int B, S, H, LH, n_rows, blk;
  float scale;
};

template <int HD, bool DKV>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // [B*H, S, HD] maps with boxes of 64 rows: a box never crosses a head,
  // rows past S arrive as zeros; encoded every call (the caching
  // allocator reuses addresses)
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const uint64_t BH = (uint64_t)a.B * a.H;
  if (!encode_bf16_3d(enc, &tm_q, a.q, BH, a.S, HD, wg::kWalk, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16_3d(enc, &tm_do, a.dout, BH, a.S, HD, wg::kWalk,
                      wg::kBoxCols, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16_3d(enc, &tm_k, a.k, BH, a.S, HD, wg::kKeys, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16_3d(enc, &tm_v, a.v, BH, a.S, HD, wg::kKeys, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)BH * a.n_rows * (a.blk / wg::kWalk);
  if constexpr (DKV) {
    using L = wg::DkvLayout<HD>;
    auto kern = bs_dkv_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)blocks, wg::kThreadsDkv, L::kSmem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dq_or_dk),
        static_cast<__nv_bfloat16*>(a.dv), a.row_ptr, a.cols, (int)BH, a.S,
        a.H, a.LH, a.n_rows, a.blk, a.scale);
  } else {
    using L = wg::DqLayout<HD>;
    auto kern = bs_dq_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)blocks, wg::kThreadsDkv, L::kSmem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dq_or_dk), a.row_ptr, a.cols, (int)BH,
        a.S, a.H, a.LH, a.n_rows, a.blk, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int HD, int TILE, bool DKV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  dim3 grid((a.S + TILE - 1) / TILE, a.H, a.B);
  if constexpr (DKV) {
    auto kern = bs_dkv_kernel<T, HD, TILE>;
    const size_t smem = bs_dkv_smem_bytes<T, HD, TILE>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, 2 * TILE, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq_or_dk),
        static_cast<T*>(a.dv), a.row_ptr, a.cols, a.S, a.H, a.LH, a.n_rows,
        a.blk, a.scale);
  } else {
    auto kern = bs_dq_kernel<T, HD, TILE>;
    const size_t smem = bs_dq_smem_bytes<T, HD, TILE>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, 2 * TILE, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq_or_dk),
        a.row_ptr, a.cols, a.S, a.H, a.LH, a.n_rows, a.blk, a.scale);
  }
  return cudaGetLastError();
}

// The exact kernels' widest tile: 64 rows, 32 for float32 at hd 256 (64
// rows take ~277 KB (dQ) and ~294 KB (dK/dV) of shared memory there)
template <typename T, int HD>
constexpr int kMaxTile = sizeof(T) == 4 && HD == 256 ? 32 : 64;

template <typename T, int HD, bool DKV>
cudaError_t launch_tile(const Args& a, cudaStream_t st) {
  switch (a.blk) {
    case 16:
      return launch<T, HD, 16, DKV>(a, st);
    case 32:
      return launch<T, HD, 32, DKV>(a, st);
    case 64:
    case 128:
      return launch<T, HD, kMaxTile<T, HD>, DKV>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <bool DKV>
int dispatch(const Args& a, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.S <= 0 || a.B <= 0 || a.H <= 0) return 0;
  if (dtype == kBF16 && (a.blk == 64 || a.blk == 128) &&
      (hd == 64 || hd == 128)) {
    if (!fits(a.B, a.S, a.H)) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 128) return launch_wgmma<128, DKV>(a, st);
    return launch_wgmma<64, DKV>(a, st);
  }
  if (dtype == kBF16) {
    if (hd == 128) return launch_tile<__nv_bfloat16, 128, DKV>(a, st);
    if (hd == 64) return launch_tile<__nv_bfloat16, 64, DKV>(a, st);
    if (hd == 256) return launch_tile<__nv_bfloat16, 256, DKV>(a, st);
  } else if (dtype == kF32) {
    if (hd == 128) return launch_tile<float, 128, DKV>(a, st);
    if (hd == 64) return launch_tile<float, 64, DKV>(a, st);
    if (hd == 256) return launch_tile<float, 256, DKV>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dstorch

// K18: dQ.
extern "C" int block_sparse_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* row_ptr,
    const void* cols, int B, int S, int H, int hd, int LH, int nq, int blk,
    float scale, int dtype, void* stream) {
  using namespace dstorch;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr,
               static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
               B, S, H, LH, nq, blk, scale};
  return dispatch<false>(a, hd, dtype, stream);
}

// K19: dK, dV from the transposed layout's lists.
extern "C" int block_sparse_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* row_ptr_t, const void* cols_t, int B, int S, int H, int hd,
    int LH, int nk, int blk, float scale, int dtype, void* stream) {
  using namespace dstorch;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv,
               static_cast<const int*>(row_ptr_t),
               static_cast<const int*>(cols_t), B, S, H, LH, nk, blk, scale};
  return dispatch<true>(a, hd, dtype, stream);
}
