// Flash attention forward for Hopper (sm_90a): O and the row log-sum-exp.
//
// Replaces the TPU kernel
//   deepspeed_tpu/ops/transformer/flash_attention.py::_fwd_kernel
// (driven by _fwd and the public flash_attention). It computes the same
// function: per (batch, head), causal or full softmax attention of q over
// k, v with the scores scaled by `scale`, the online softmax in float32,
// masked scores set to the reference's finite -1e30 (never -inf), and the
// row log-sum-exp m + log(l) (l = 0 counts as 1) written beside O.
//
// Layouts: q, k, v, o are [B, S, H, hd] (the model's layout; GQA heads are
// repeated before the call, as the reference does); lse is [B, H, S]
// float32. Element type float32 or bfloat16, hd in {64, 128, 256}.
//
// Bound on this card: operations, 4*hd flops per visible (query, key) pair
// and head, against 989 TFLOP/s dense bfloat16.
//
// bfloat16, the training path's type: a TMA + wgmma kernel, one template
// for hd 64 and 128 (flash_wgmma.cuh holds what it shares with the
// backward). The TPU grid walks kv blocks in order for each query block and
// carries the softmax state in VMEM; here a CTA owns 128 query rows of one
// (batch, head), two consumer warpgroups of 64, and walks key tiles of
// kWalk = 128 itself, so the state lives in registers. A producer
// warpgroup gives its registers back (setmaxnreg 24) and one of its threads
// loads Q once and fills a ring of kStages = 3 key/value stages by TMA from
// the [B, S, H*hd] layout as it is (3-D tensor maps, 64-column boxes,
// 128-byte swizzle; rows past S arrive as zeros), completion counted on
// mbarriers; the consumers take 240 registers. Per walked tile each
// warpgroup issues S = Q.K^T with both operands in shared memory (wgmma
// m64n128k16, K-major), updates the online softmax in float32 registers,
// rounds P to bf16 once in registers and issues O += P.V with P as the
// register A operand and V N-major (imm-trans-b). The two products take
// separate turns at the tensor cores, the warpgroups alternating (named
// barriers), so one computes its softmax while the other's products run;
// each issue and its wait sit in one block with no branch between them, or
// ptxas serializes the wgmma. (Measured on the H100 against this: a 64-key
// walk and FlashAttention-3's order, a warpgroup issuing the next tile's S
// with the last tile's P.V, were slower, two stages no faster; PERF.md.) The
// softmax runs in base 2 on the special-function unit: s2 = s*scale*log2 e,
// the running max m2 and sum l kept in base 2, P = 2^(s2 - m2) and the
// rescale 2^(m2,old - m2,new) by ex2.approx (relative error ~2^-22; expf
// took ~10 instructions a score), and LSE = (m2 + log2 l)*ln 2 at the end.
// Masked scores are -1e30*log2 e, the reference's -1e30 in base 2, so
// 2^(s2 - m2) is exactly 0 for them once a row has seen a key; the only
// tile of a warpgroup's walk that needs the mask (its diagonal or the tail)
// is its last, and only that one evaluates it. Each lane keeps its share of
// a row's sum and the 4 lanes of a row add theirs once, at the end. Causal
// CTAs stop at their diagonal tile (the reference's _causal_kv_index skip)
// and run heaviest first within each raster group of (batch, head) pairs,
// so the long rows do not form the tail. No atomics and a fixed tile order:
// two calls give the same bits.
//
// Numerics against the reference (float32 throughout): P is rounded to
// bfloat16 for the P.V product (as FlashAttention-2 does), a relative error
// <= 2^-9 per term; the softmax statistics, the sums and the LSE stay
// float32; O is rounded once.
//
// float32 (the card's edge checks) keeps the exact tile kernel, wgmma
// having no full-float32 mode, and so does hd 256 in both types (a [128 x
// 256] owned tile and a ring of 128-key stages do not fit shared memory):
// a block of 4 warps owns 64 query rows and walks 64-key tiles it loads
// itself, each warp 16 rows and a lane 2 of them in the accumulator layout
// of tile_mma.cuh, with float32 FMAs for float32 and mma.sync for bf16
// (float32 sums), P staged through shared memory in the input type (so
// rounded to bf16 for P.V, as the wgmma path does) and expf. At hd 256 a
// thread holds 128 accumulator floats and ptxas spills some of them
// (PERF.md); speed at hd 256 is later work.
#include <type_traits>

#include "flash_wgmma.cuh"

namespace dstorch {

// ---- bfloat16: TMA + wgmma, two warpgroups in turns ---------------------
namespace wg {
namespace {
constexpr int kWalk = 128;                // keys of a walked tile
constexpr int kStages = 3;
// + a producer warpgroup; 168 registers a thread at entry (65536 / 384, in
// steps of 8), the producer gives 144 back, the consumers take 72
constexpr int kThreads = (kGroups + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kWalkBox = kWalk * 128;     // bytes of a [kWalk x 64] box
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = -1e30f * kLog2e;

template <int HD>
struct Layout {
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kOwnBox = kOwn * 128;           // a [128 x 64] box
  static constexpr int kOwnBytes = kBoxes * kOwnBox;   // Q
  static constexpr int kWalkBytes = kBoxes * kWalkBox; // K or V of a tile
  static constexpr int kStageBytes = 2 * kWalkBytes;   // a stage's TMA bytes
  static constexpr int kBars = 1 + 2 * kStages;        // Q, full, empty
  static constexpr int kSmem =
      kOwnBytes + kStages * kStageBytes + 8 * kBars + 1024;
};

// Issues S = Q.K^T for one warpgroup, [64 x W]: q its 64 owned rows
// (boxes kOwnBox apart), k the walked tile's W rows (boxes W * 128 bytes
// apart); both K-major over hd.
template <int HD, int W>
__device__ __forceinline__ void score_product(float (&s)[W / 2], uint32_t q,
                                              uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t a = wgmma_desc_kmajor(q + (kk / 4) * Layout<HD>::kOwnBox +
                                         (kk % 4) * 32);
    const uint64_t b = wgmma_desc_kmajor(k + (kk / 4) * W * 128 + (kk % 4) * 32);
    if constexpr (W == 64) {
      wgmma_m64n64k16_ss(s, a, b, kk);
    } else {
      wgmma_m64n128k16_ss(s, a, b, kk);
    }
  }
}
}  // namespace
}  // namespace wg

namespace {

// A CTA owns 128 query rows and walks kWalk-key tiles.
template <int HD>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int BH, int S, int H,
                       float scale, int causal) {
  using L = wg::Layout<HD>;
  constexpr int W = wg::kWalk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = wg::align1024(smem_raw);
  unsigned char* stages = Qs + L::kOwnBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + wg::kStages * L::kStageBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + wg::kStages;

  const int ntiles = (S + wg::kOwn - 1) / wg::kOwn;
  int rank, bh;
  wg::raster(BH, ntiles, rank, bh);
  const int b = bh / H, h = bh % H, col = h * HD;
  const int q0 = (ntiles - 1 - rank) * wg::kOwn;  // the last rows walk most
  const int nk = (S + W - 1) / W;
  const int n_tiles = causal ? min(nk, (q0 + wg::kOwn + W - 1) / W) : nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                            // Q
    for (int i = 0; i < wg::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], wg::kGroups * 4);           // a consumer warp each
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the producer: one thread issues every TMA load, Q once, then K and V
  // tiles into the ring as its stages come free
  if (warp >= wg::kGroups * 4) {
    setmaxnreg_dec<wg::kProducerRegs>();
    if (warp == wg::kGroups * 4 && lane == 0) {
      mbar_arrive_expect_tx(&bars[0], L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_3d(Qs + c * L::kOwnBox, &tm_q, &bars[0], col + 64 * c, q0,
                    b);
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % wg::kStages;
        unsigned char* base = stages + st * L::kStageBytes;
        mbar_wait(&empty[st], ((jt / wg::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kStageBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_3d(base + c * wg::kWalkBox, &tm_k, &full[st], col + 64 * c,
                      jt * W, b);
          tma_load_3d(base + L::kWalkBytes + c * wg::kWalkBox, &tm_v,
                      &full[st], col + 64 * c, jt * W, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cg owns query rows [rw, rw + 64); the tiles it
  // sees are a prefix [0, nv) of the walk
  setmaxnreg_inc<wg::kConsumerRegs>();
  const int cg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const wg::Turns turns{cg};
  const int rw = q0 + 64 * cg;
  const int row_lo = rw + 16 * wq + g;            // rows row_lo, row_lo + 8
  const int nv = rw >= S   ? 0
                 : causal ? min(n_tiles, (rw + 63) / W + 1)
                          : n_tiles;
  const float scale_log2 = scale * wg::kLog2e;
  float m2[2] = {wg::kMasked2, wg::kMasked2};     // running max, base 2
  float l[2] = {0.f, 0.f};                        // this lane's share of l
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  uint32_t pa[W / 16][4];                         // P of the last tile, bf16
  const uint32_t q_own = smem_addr(Qs) + cg * 64 * 128;
  auto k_tile = [&](int jt) {
    return smem_addr(stages + (jt % wg::kStages) * L::kStageBytes);
  };
  auto release = [&](int jt) {                    // tile jt's stage is free
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[jt % wg::kStages]);
  };
  // The online softmax of tile jt's scores, in float32 registers: s[i]
  // holds row row_lo + 8*((i/2)%2), key jt*W + 8*(i/4) + 2*t + i%2. probs
  // turns s into P = 2^(s*scale*log2 e - m2) with the running max m2 and
  // this lane's share of l updated, alpha the rescale of O; the mask (EDGE)
  // is applied only to the last tile a warpgroup sees, the one diagonal or
  // tail tile of its walk. finish rescales O and rounds P once to bf16
  // pairs, the A fragments of O += P.V (k16 slice j/2 of the n8 column
  // block j).
  auto probs = [&](float (&s)[W / 2], int jt, float (&alpha)[2], auto edge) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) s[i] *= scale_log2;
    if constexpr (decltype(edge)::value) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const int row = row_lo + 8 * ((i >> 1) & 1);
        const int key = jt * W + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = key >= S || (causal && key > row) ? wg::kMasked2 : s[i];
      }
    }
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
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
    for (int i = 0; i < W / 2; ++i) {
      s[i] = wg::exp2_approx(s[i] - m2[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
  };
  auto finish = [&](const float (&s)[W / 2], const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      pa[j / 2][2 * (j % 2)] = wg::pack_rn(s[4 * j], s[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = wg::pack_rn(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  mbar_wait(&bars[0], 0);
  if (cg == 1) turns.pass();

  // The walk: per tile a warpgroup takes two turns at the tensor cores,
  // S = Q.K^T, then (after its softmax) O += P.V; each issue and its wait
  // sit in one block with no branch between them (ptxas serializes the
  // wgmma otherwise). A tile it does not see (past S, past the causal
  // diagonal) takes its two turns empty.
  for (int jt = 0; jt < n_tiles; ++jt) {
    const bool last_turn = cg == 1 && jt + 1 == n_tiles;
    mbar_wait(&full[jt % wg::kStages], (jt / wg::kStages) & 1);
    __syncwarp();  // wgmma needs the warp converged
    if (jt < nv) {
      float s[W / 2], alpha[2];
      turns.wait();
      wgmma_fence();
      wg::score_product<HD, W>(s, q_own, k_tile(jt));
      wgmma_commit();
      turns.pass();
      wgmma_wait<0>();
      wgmma_fence_operand(s);
      if (jt == nv - 1) {
        probs(s, jt, alpha, std::true_type{});
      } else {
        probs(s, jt, alpha, std::false_type{});
      }
      finish(s, alpha);
      turns.wait();
      wgmma_fence();
      wg::walk_product<HD, W>(acc, pa, k_tile(jt) + L::kWalkBytes);
      wgmma_commit();
      if (!last_turn) turns.pass();
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
    } else {
      turns.wait();
      turns.pass();
      turns.wait();
      if (!last_turn) turns.pass();
    }
    release(jt);
  }

  // epilogue: the 4 lanes of a row add their shares of l; O/l rounded once
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    inv[r] = 1.f / l[r];
    const int row = row_lo + 8 * r;
    if (t == 0 && row < S) {
      lse[(size_t)bh * S + row] = (m2[r] + log2f(l[r])) * wg::kLn2;
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
  wg::store_rows<HD>(o, acc, row_lo, S, H, b, h);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int H, float scale,
                        int causal, cudaStream_t stream) {
  using L = wg::Layout<HD>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // encoded every call: the caching allocator reuses addresses
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_rows(enc, &tm_q, q, B, S, H, HD, wg::kOwn) ||
      !encode_rows(enc, &tm_k, k, B, S, H, HD, wg::kWalk) ||
      !encode_rows(enc, &tm_v, v, B, S, H, HD, wg::kWalk))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = B * H * ((S + wg::kOwn - 1) / wg::kOwn);
  kern<<<blocks, wg::kThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, B * H, S, H,
      scale, causal);
  return cudaGetLastError();
}

// ---- the exact tile kernel: float32, and hd 256 in both types ----------
// TILE query rows a block (TILE / 16 warps), TILE-key tiles; TILE = 64
// everywhere (float32 at hd 256 takes 212 KB of shared memory)
template <typename T, int HD, int TILE>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * (3 * TILE * (HD + kPad<T>) + TILE * (TILE + kPad<T>));
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(2 * TILE)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, float scale,
                 int causal) {
  constexpr int NTHREADS = 2 * TILE;
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = TILE + kPad<T>;
  constexpr int NT_S = TILE / 8;  // n-tiles of a score tile
  constexpr int NT_O = HD / 8;    // n-tiles of an output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  T* Ps = Vs + TILE * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * HD;
  const int q0 = iq * TILE;

  load_tile<T, TILE, HD, NTHREADS>(Qs, LD, q + base + q0 * row_stride,
                                   row_stride, S - q0);

  float acc[1][NT_O][4];
  zero_acc(acc);
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;          // rows row_lo, row_lo + 8

  const int nk = (S + TILE - 1) / TILE;
  const int n_tiles = causal ? min(nk, iq + 1) : nk;   // square tiles
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();                               // previous tile consumed
    load_tile<T, TILE, HD, NTHREADS>(Ks, LD, k + base + j0 * row_stride,
                                     row_stride, S - j0);
    load_tile<T, TILE, HD, NTHREADS>(Vs, LD, v + base + j0 * row_stride,
                                     row_stride, S - j0);
    __syncthreads();

    float s[1][NT_S][4];
    zero_acc(s);
    warp_mma<1, NT_S, true, true>(s, Qs + warp * 16 * LD, LD, Ks, LD, HD);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int col = j0 + 8 * nt + 2 * t + (e & 1);
        const bool ok = col < S && (!causal || row >= col);
        const float x = ok ? s[0][nt][e] * scale : kNegInf;
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
    // P in the input type: rounded to bfloat16 for P.V with bf16 inputs
    T* Pw = Ps + warp * 16 * LDP;
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    const float inv = 1.f / l_safe;
    T* orow = o + base + (size_t)row * row_stride;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      store_pair(orow + 8 * nt + 2 * t, acc[0][nt][2 * r] * inv,
                 acc[0][nt][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((size_t)b * H + h) * S + row] = m_i[r] + logf(l_safe);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_exact(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int H,
                         float scale, int causal, cudaStream_t stream) {
  constexpr int TILE = 64;
  auto kern = flash_fwd_kernel<T, HD, TILE>;
  const size_t smem = fwd_smem_bytes<T, HD, TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kern<<<grid, 2 * TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int S, int H, int hd,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  using namespace dstorch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  if (!fits(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_bf16<128>(q, k, v, o, l, B, S, H, scale, causal, st);
    if (hd == 64)
      return launch_bf16<64>(q, k, v, o, l, B, S, H, scale, causal, st);
    if (hd == 256)
      return launch_exact<__nv_bfloat16, 256>(q, k, v, o, l, B, S, H, scale,
                                              causal, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_exact<float, 128>(q, k, v, o, l, B, S, H, scale, causal,
                                      st);
    if (hd == 64)
      return launch_exact<float, 64>(q, k, v, o, l, B, S, H, scale, causal,
                                     st);
    if (hd == 256)
      return launch_exact<float, 256>(q, k, v, o, l, B, S, H, scale, causal,
                                      st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
