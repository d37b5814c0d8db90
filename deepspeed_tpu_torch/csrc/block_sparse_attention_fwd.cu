// Block-sparse attention forward for Hopper (sm_90a): O, with or without
// the row log-sum-exp.
//
// Replaces the TPU kernels
//   deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py::_bs_kernel
//     (O and the float32 LSE: the forward taken under a gradient)
//   deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py::_bs_kernel_nolse
//     (O alone: the inference primal)
// driven by _bs_fwd. Both compute, per (batch, head), softmax attention of
// q over k, v restricted to the blocks set in a [heads, nq, nk] block
// layout: scores scaled by `scale` in float32, keys at positions >= S
// masked with the reference's finite -1e30 (never -inf), the online
// softmax in float32, and LSE = m + log(l) with l = 0 counted as 1, so a
// query row with no active block writes O = 0 and LSE = -1e30. There is
// no token-level causal mask inside a block, as in the reference.
//
// Layouts: q, k, v, o are [B, H, S, hd] (the reference's layout, read as
// is: no padded copy is made); lse is [B, H, S] float32. Element type
// float32 or bfloat16, hd in {64, 128, 256}, block in {16, 32, 64, 128}.
// The block layout arrives as a CSR list of active blocks: row r = lh*nq +
// iq of layout head lh (0 when the heads share one layout, else the head)
// holds the k-blocks cols[row_ptr[r] .. row_ptr[r + 1]).
//
// The TPU walks a dense (B, H, nq, nk) grid and skips the DMA of masked
// steps through a fetch table. Here a CUDA block owns a tile of query rows
// of one (batch, head) and walks only its q-block's list of active blocks,
// so a masked block costs nothing, and nothing carries across CUDA blocks.
//
// bfloat16 at blocks 64 and 128 and hd 64 and 128, the main path's shapes:
// a TMA + wgmma kernel (bs_fwd_wgmma_kernel), after K1's
// (flash_attention_fwd.cu). A CTA of two warpgroups owns 64 query rows
// (not K1's 128: at block 64 two neighbouring q-blocks walk different
// lists), Q resident in shared memory, and walks the 64-key tiles its
// q-block's list names (block / 64 tiles an entry), loaded by TMA from
// [B*H, S, hd] tensor maps (a box never crosses a head; rows past S arrive
// as zeros; 128-byte swizzle). The warpgroups take the tiles in turn
// (warpgroup g the tiles n with n % 2 == g), each through its own ring of
// two stages that one thread of its first warp fills a tile ahead, and
// each keeps its own online-softmax state (m, l, O) in registers, as K1
// does: S = Q.K^T by wgmma m64n64k16 with both operands in shared memory,
// the softmax in base 2 on ex2.approx (s2 = s*scale*log2 e; masked keys
// -1e30*log2 e, so 2^(s2 - m2) is 0 for them once a row has seen a key),
// keys at or past S masked on the tail tile only, P rounded once to bf16
// in registers and fed as the A operand of O += P.V (V N-major). At the
// end the two states are merged once through shared memory in a fixed
// order, m = max(m0, m1), O = (O0*2^(m0-m) + O1*2^(m1-m)) / (l0*2^(m0-m) +
// l1*2^(m1-m)), each warpgroup storing half of O's columns; so two calls
// give the same bits. A row whose list is empty writes O = 0 and LSE =
// -1e30 exactly. CTAs take the q tiles in order, in raster groups of 16
// (batch, head) pairs (reversed order, rings of 3 stages and groups of 4
// or 8 were measured slower; PERF.md). K17 is the same kernel with lse ==
// nullptr, so its O is K16's bit for bit. The walked tiles bound it at
// the main shape: one 32 KB K/V tile for 64 owned rows (PERF.md).
//
// Float32, blocks 16 and 32, and hd 256 keep the exact tile kernel
// (bs_fwd_kernel): a CUDA block owns TILE = min(block, 64) query rows
// (a 128-row block is two CUDA blocks) and walks its list in chunks of
// TILE keys. Each warp owns 16 query rows and a lane 2 of them
// (tile_mma.cuh's accumulator layout); per chunk: stage K and V in shared
// memory, S = Q.K^T on the tensor cores (bfloat16 inputs, float32 sums;
// exact float32 FMAs for float32 inputs), mask and update the online
// softmax in registers, write P to shared memory in the input type, O +=
// P.V. With bfloat16 inputs P is rounded to bfloat16 for P.V (relative
// error <= 2^-9 per term), as the wgmma kernel does; the statistics and
// sums stay float32. At hd 256 a thread holds 128 accumulator floats and
// ptxas spills some (PERF.md); speed there is later work.
//
// Bound on this card: operations, 4*hd flops per (query, key) pair of an
// active block and head, against 989 TFLOP/s dense bfloat16.
#include <type_traits>

#include "flash_wgmma.cuh"

namespace dstorch {
namespace {

template <typename T, int HD, int TILE>
constexpr size_t bs_fwd_smem_bytes() {
  return sizeof(T) * (3 * TILE * (HD + kPad<T>) + TILE * (TILE + kPad<T>));
}

// lse == nullptr: the no-LSE forward (K17); else K16.
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
bs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ row_ptr,
              const int* __restrict__ cols, int S, int H, int LH, int nq,
              int blk, float scale) {
  constexpr int NTHREADS = 2 * TILE;   // TILE / 16 warps
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = TILE + kPad<T>;
  constexpr int NT_S = TILE / 8;
  constexpr int NT_O = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  T* Ps = Vs + TILE * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const int row = (LH == 1 ? 0 : h) * nq + q0 / blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = ((size_t)b * H + h) * S * HD;

  load_tile<T, TILE, HD, NTHREADS>(Qs, LD, q + base + (size_t)q0 * HD, HD,
                                   S - q0);

  float acc[1][NT_O][4];
  zero_acc(acc);
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;          // rows row_lo, row_lo + 8
  T* Pw = Ps + warp * 16 * LDP;
  const int begin = row_ptr[row], end = row_ptr[row + 1];

  for (int a = begin; a < end; ++a) {
    const int kb0 = cols[a] * blk;
    for (int j0 = kb0; j0 < kb0 + blk; j0 += TILE) {
      __syncthreads();                             // previous chunk consumed
      load_tile<T, TILE, HD, NTHREADS>(Ks, LD, k + base + (size_t)j0 * HD, HD,
                                       S - j0);
      load_tile<T, TILE, HD, NTHREADS>(Vs, LD, v + base + (size_t)j0 * HD, HD,
                                       S - j0);
      __syncthreads();

      float s[1][NT_S][4];
      zero_acc(s);
      warp_mma<1, NT_S, true, true>(s, Qs + warp * 16 * LD, LD, Ks, LD, HD);

      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + 8 * nt + 2 * t + (e & 1);
          const float x = col < S ? s[0][nt][e] * scale : kNegInf;
          s[0][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[0][nt][e] - m_i[e >> 1]);
          rsum[e >> 1] += p[e];
        }
        store_pair(Pw + g * LDP + 8 * nt + 2 * t, p[0], p[1]);
        store_pair(Pw + (g + 8) * LDP + 8 * nt + 2 * t, p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
        l_i[r] = alpha[r] * l_i[r] + rsum[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] *= alpha[e >> 1];
      }
      __syncwarp();
      warp_mma<1, NT_O, true, false>(acc, Pw, LDP, Vs, LD, TILE);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row_lo + 8 * r;
    if (qr >= S) continue;
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    const float inv = 1.f / l_safe;
    T* orow = o + base + (size_t)qr * HD;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(orow + 8 * nt + 2 * t, acc[0][nt][2 * r] * inv,
                 acc[0][nt][2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      lse[((size_t)b * H + h) * S + qr] = m_i[r] + logf(l_safe);
    }
  }
}

template <typename T, int HD, int TILE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* row_ptr, const int* cols, int B,
                   int S, int H, int LH, int nq, int blk, float scale,
                   cudaStream_t stream) {
  auto kern = bs_fwd_kernel<T, HD, TILE>;
  const size_t smem = bs_fwd_smem_bytes<T, HD, TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kern<<<grid, 2 * TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, row_ptr, cols, S, H,
      LH, nq, blk, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* row_ptr, const int* cols,
                        int B, int S, int H, int LH, int nq, int blk,
                        float scale, cudaStream_t st) {
  switch (blk) {
    case 16:
      return launch<T, HD, 16>(q, k, v, o, lse, row_ptr, cols, B, S, H, LH,
                               nq, blk, scale, st);
    case 32:
      return launch<T, HD, 32>(q, k, v, o, lse, row_ptr, cols, B, S, H, LH,
                               nq, blk, scale, st);
    case 64:
    case 128:
      return launch<T, HD, 64>(q, k, v, o, lse, row_ptr, cols, B, S, H, LH,
                               nq, blk, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// --------------------------------------------------------------------- //
// bfloat16 at blocks 64 and 128: TMA + wgmma
// --------------------------------------------------------------------- //
namespace wg {
namespace {
constexpr int kRows = 64;                 // query rows a CTA owns
constexpr int kWalk = 64;                 // keys of a walked tile
constexpr int kRing = 2;                  // stages a warpgroup fills ahead
constexpr int kStages = kGroups * kRing;
constexpr int kThreadsFwd = kGroups * 128;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = -1e30f * kLog2e;

template <int HD>
struct FwdLayout {
  static constexpr int kTile = HD / kBoxCols * kBox64;  // one [64 x HD] tile
  static constexpr int kTx = 2 * kTile;                 // K and V by TMA
  static constexpr int kStageBytes = kTx;               // 1024-aligned
  // the merge: each warpgroup hands over its m and l (2 rows each) and
  // the half of O the other stores
  static constexpr int kSet = 4 + HD / 4;               // floats a thread
  static constexpr int kFold = kGroups * kSet * 128 * 4;
  static constexpr int kRingBytes =
      kStages * kStageBytes > kFold ? kStages * kStageBytes : kFold;
  static constexpr int kBars = 1 + 2 * kStages;         // Q, full, empty
  static constexpr int kSmem = kTile + kRingBytes + 8 * kBars + 1024;
};

// Issues S = Q.K^T for one warpgroup, [64 x 64]: Q its CTA's 64 owned
// rows, K a walked tile's 64 rows (boxes kBox64 apart); both K-major.
template <int HD>
__device__ __forceinline__ void score_product(float (&s)[32], uint32_t q,
                                              uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox64 + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, wgmma_desc_kmajor(q + off),
                       wgmma_desc_kmajor(k + off), kk);
  }
}
}  // namespace
}  // namespace wg

namespace {

// lse == nullptr: K17 (O alone); else K16.
template <int HD>
__global__ void __launch_bounds__(wg::kThreadsFwd, 1)
bs_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ cols, int BH, int S, int H,
                    int LH, int nq, int blk, float scale) {
  using L = wg::FwdLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = wg::align1024(smem_raw);
  unsigned char* stages = Qs + L::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + L::kRingBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int per = blk / wg::kWalk;                // tiles a list entry
  int rank, bh;
  wg::raster(BH, nq * (blk / wg::kRows), rank, bh);
  const int lh = LH == 1 ? 0 : bh % H;
  const int q0 = rank * wg::kRows;
  if (q0 >= S) return;                            // rows past S: no output
  const int row = lh * nq + q0 / blk;
  const int begin = row_ptr[row];
  const int n_tiles = (row_ptr[row + 1] - begin) * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp / 4, wq = warp % 4;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                       // Q
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
      mbar_arrive_expect_tx(&bars[0], L::kTile);
      for (int c = 0; c < HD / wg::kBoxCols; ++c)
        tma_load_3d(Qs + c * wg::kBox64, &tm_q, &bars[0], 64 * c, q0, bh);
    }
    if (mine > 0) fill(0);
  }

  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * wq + g;            // rows row_lo, row_lo + 8
  const float scale_log2 = scale * wg::kLog2e;
  float m2[2] = {wg::kMasked2, wg::kMasked2};     // running max, base 2
  float l[2] = {0.f, 0.f};                        // this lane's share of l
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_own = smem_addr(Qs);
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
    float s[32];
    wgmma_fence();
    wg::score_product<HD>(s, q_own, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    // the online softmax of the tile's scores: s[i] holds row row_lo +
    // 8*((i/2)%2), key k0 + 8*(i/4) + 2*t + i%2; keys at or past S masked
    // on the tail tile only (EDGE)
    float alpha[2];
    auto probs = [&](auto edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      if constexpr (decltype(edge)::value) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          s[i] = key >= S ? wg::kMasked2 : s[i];
        }
      }
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = wg::exp2_approx(m2[r] - mx[r]);
        m2[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = wg::exp2_approx(s[i] - m2[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
    };
    if (k0 + wg::kWalk > S) {
      probs(std::true_type{});
    } else {
      probs(std::false_type{});
    }
    // O rescaled; P rounded once to bf16 pairs, the A fragments of O +=
    // P.V (k16 slice jj/2 of the n8 column block jj)
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      pa[jj / 2][2 * (jj % 2)] = wg::pack_rn(s[4 * jj], s[4 * jj + 1]);
      pa[jj / 2][2 * (jj % 2) + 1] =
          wg::pack_rn(s[4 * jj + 2], s[4 * jj + 3]);
    }
    wgmma_fence();
    wg::walk_product<HD, wg::kWalk>(acc, pa, v_s);          // O += P.V
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the merge, in shared memory the ring no longer uses: each warpgroup
  // hands over its m and l and the half of O the other stores (warpgroup 0
  // stores columns [0, HD/2), warpgroup 1 the rest), then both merge the
  // two states in the same fixed order (state 0 first) for their half
  constexpr int kHalf = HD / 4;                   // floats of half of O
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();
  float* fold = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x % 128;
  float* out_set = fold + cg * L::kSet * 128;
  const float* in_set = fold + (1 - cg) * L::kSet * 128;
  out_set[0 * 128 + tid] = m2[0];
  out_set[1 * 128 + tid] = m2[1];
  out_set[2 * 128 + tid] = l[0];
  out_set[3 * 128 + tid] = l[1];
  auto hand = [&](auto off) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      out_set[(4 + i) * 128 + tid] = acc[decltype(off)::value + i];
  };
  if (cg == 0) {
    hand(std::integral_constant<int, kHalf>{});
  } else {
    hand(std::integral_constant<int, 0>{});
  }
  __syncthreads();
  float a0[2], a1[2], inv[2], m[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = in_set[r * 128 + tid], lo = in_set[(2 + r) * 128 + tid];
    const float m0 = cg == 0 ? m2[r] : mo, m1 = cg == 0 ? mo : m2[r];
    const float l0 = cg == 0 ? l[r] : lo, l1 = cg == 0 ? lo : l[r];
    m[r] = fmaxf(m0, m1);
    a0[r] = wg::exp2_approx(m0 - m[r]);
    a1[r] = wg::exp2_approx(m1 - m[r]);
    lsum[r] = __fmaf_rn(l0, a0[r], __fmul_rn(l1, a1[r]));
    inv[r] = 1.f / (lsum[r] == 0.f ? 1.f : lsum[r]);
  }
  auto merge = [&](auto off) {
    constexpr int o0 = decltype(off)::value;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int r = (i >> 1) & 1;
      const float mine_o = acc[o0 + i];
      const float other = in_set[(4 + i) * 128 + tid];
      const float x0 = cg == 0 ? mine_o : other;
      const float x1 = cg == 0 ? other : mine_o;
      acc[o0 + i] = __fmul_rn(__fmaf_rn(x0, a0[r], __fmul_rn(x1, a1[r])),
                              inv[r]);
    }
  };
  if (cg == 0) {
    merge(std::integral_constant<int, 0>{});
    wg::store_bhsd<HD, 0, HD / 16>(o, acc, row_lo, S, bh);
    if (lse != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = row_lo + 8 * r;
        if (qr < S)
          lse[(size_t)bh * S + qr] =
              lsum[r] == 0.f ? kNegInf : (m[r] + log2f(lsum[r])) * wg::kLn2;
      }
    }
  } else {
    merge(std::integral_constant<int, kHalf>{});
    wg::store_bhsd<HD, HD / 16, HD / 8>(o, acc, row_lo, S, bh);
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* row_ptr,
                         const int* cols, int B, int S, int H, int LH,
                         int nq, int blk, float scale, cudaStream_t stream) {
  using L = wg::FwdLayout<HD>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // [B*H, S, HD] maps with boxes of 64 rows: a box never crosses a head,
  // rows past S arrive as zeros; encoded every call (the caching
  // allocator reuses addresses)
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t BH = (uint64_t)B * H;
  if (!encode_bf16_3d(enc, &tm_q, q, BH, S, HD, wg::kRows, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16_3d(enc, &tm_k, k, BH, S, HD, wg::kWalk, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16_3d(enc, &tm_v, v, BH, S, HD, wg::kWalk, wg::kBoxCols,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = bs_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)BH * nq * (blk / wg::kRows);
  kern<<<(unsigned)blocks, wg::kThreadsFwd, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, row_ptr, cols,
      (int)BH, S, H, LH, nq, blk, scale);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const void* row_ptr, const void* cols, int B, int S,
             int H, int hd, int LH, int nq, int blk, float scale, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cl = static_cast<const int*>(cols);
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  if (dtype == kBF16 && (blk == 64 || blk == 128) && (hd == 64 || hd == 128)) {
    if (!fits(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 128)
      return launch_wgmma<128>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq, blk,
                               scale, st);
    return launch_wgmma<64>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq, blk,
                            scale, st);
  }
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_tile<__nv_bfloat16, 128>(q, k, v, o, lse, rp, cl, B, S, H,
                                             LH, nq, blk, scale, st);
    if (hd == 64)
      return launch_tile<__nv_bfloat16, 64>(q, k, v, o, lse, rp, cl, B, S, H,
                                            LH, nq, blk, scale, st);
    if (hd == 256)
      return launch_tile<__nv_bfloat16, 256>(q, k, v, o, lse, rp, cl, B, S, H,
                                             LH, nq, blk, scale, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_tile<float, 128>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq,
                                     blk, scale, st);
    if (hd == 64)
      return launch_tile<float, 64>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq,
                                    blk, scale, st);
    if (hd == 256)
      return launch_tile<float, 256>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq,
                                     blk, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dstorch

// K16: O and the LSE.
extern "C" int block_sparse_fwd_launch(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const void* row_ptr, const void* cols,
                                       int B, int S, int H, int hd, int LH,
                                       int nq, int blk, float scale,
                                       int dtype, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dstorch::dispatch(q, k, v, o, static_cast<float*>(lse), row_ptr,
                           cols, B, S, H, hd, LH, nq, blk, scale, dtype,
                           stream);
}

// K17: O alone.
extern "C" int block_sparse_fwd_nolse_launch(const void* q, const void* k,
                                             const void* v, void* o,
                                             const void* row_ptr,
                                             const void* cols, int B, int S,
                                             int H, int hd, int LH, int nq,
                                             int blk, float scale, int dtype,
                                             void* stream) {
  return dstorch::dispatch(q, k, v, o, nullptr, row_ptr, cols, B, S, H, hd,
                           LH, nq, blk, scale, dtype, stream);
}
