// Ragged paged attention over the flat-token layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   deepspeed_tpu/inference/v2/kernels/ragged_ops.py::_ragged_paged_kernel
// (driven by ragged_paged_attention). It computes the same function:
// flat-token causal attention where sequence s's query tokens sit at
// [cu_q_lens[s], cu_q_lens[s+1]) and attend to their own context, read
// page by page from the shared pool through page_table[s]. Query row t of
// sequence s sits at absolute position q_pos = kvl - q_len + (t - q0) and
// sees keys k_pos <= q_pos, k_pos < kvl. GQA: the G = H / KV query heads of
// a KV head share each K/V fetch. With ALiBi, query head hq's score gets
// slope[hq] * k_pos after the scale (Bloom), or bf16(slope[hq]) *
// bf16(k_pos) * scale (Falcon), before the mask, as the reference adds it.
//
// Tiles. A CTA owns one tile of one sequence and one KV head: up to 64 rows,
// tokens x a slice of the query group. A group wider than 64 (MQA: Falcon-7B
// has 71 query heads on one KV head) is cut into n_gs = ceil(G / 64) slices
// of GS = ceil(G / n_gs) heads, and a tile holds BQ = 64 / GS tokens of
// one slice. The tile list is never materialised: warp 0 finds tile i with
// a warp-wide prefix sum over the sequences' tile counts (32 sequences a
// step), so interior sequences with no query tokens are skipped and nothing
// is read on the host. The grid's tile dimension is an upper bound
// ((ceil(T / BQ) + S) * n_gs); CTAs past the real tiles exit at once.
//
// bf16 path, ragged_paged_mma_kernel. What bounds the work on this card is
// the tensor cores for long prompts (4 * H * hd flops a visible pair, at
// ~2 flops a byte of context per query row of a tile) and latency for the
// short decode rows a SplitFuse batch mixes in; a serving batch gives only
// about one CTA an SM (the main path's: 144 tiles x heads), so the design
// puts its parallelism inside the CTA:
//   * tensor cores: S = Q.K^T and O += P.V with mma.sync.m16n8k16 (bf16 in,
//     float32 sums), a warp owning 16 of the tile's rows. mma.sync rather
//     than wgmma because a tile is ragged (a decode row fills G of its 64
//     rows; a warp whose rows are all padding still runs, but nothing
//     waits on a 64-row warpgroup product) and because K/V arrive by
//     page-table gathers, not as a TMA box: ldmatrix feeds the fragments
//     from padded shared-memory rows (16 bytes of padding a row keeps the
//     eight rows of an 8x8 matrix on distinct banks). P is rounded to bf16
//     once, as the A operand of the second product; the softmax's sums stay
//     float32;
//   * two groups of four warps walk alternate chunks of the context, each
//     with its own ring and softmax state (named barriers keep them apart),
//     and group 1's state is merged into group 0's at the end, in group
//     order: eight warps an SM hide each other's latencies, and a long
//     tile's chain of chunks is halved;
//   * staging: K and V of 64 context positions a chunk (32 at a padded head
//     width of 256) come through the page table with cp.async, 16 bytes a
//     copy (8, 4 or 2 where hd * 2 bytes or a base pointer is not a
//     multiple of 16), into each group's ring of kStages stages: chunk i +
//     kStages - 1's copies are issued before chunk i is computed. A thread
//     a position reads its page id one iteration before that chunk's row
//     offsets are written, so no page-table load waits at a barrier.
//     Positions past the walk are zero-filled (cp.async's src-size 0), so V
//     there is 0 before it meets a weight (select before multiply) and a NaN
//     in a page this tile must not read cannot reach it. 153 KB of shared
//     memory at hd 128 (165 KB at 256);
//   * head dims: the kernel is built for padded widths 64, 128 and 256 and
//     takes the true hd at run time. Columns hd .. padded width of Q, K and V
//     are zero in shared memory (written once, never copied over), so they
//     add +0 to every product: the result is exact, the k-loops stop at the
//     16-column step that covers hd, and only columns below hd are written;
//   * softmax: base 2 on the special-function unit (ex2.approx), the scale
//     and log2 e folded into one multiply of the raw score (the running max
//     is taken over the scaled scores, so this holds for any sign of the
//     scale); with ALiBi the float32 bias is added to s * scale first (one
//     fused multiply-add, as XLA contracts the reference's). The causal mask
//     is applied only on chunks that reach past the tile's first row's
//     position (the diagonal and the tail), as selects;
//   * no context split across CTAs: splitting a tile's walk over CTAs with
//     a merge pass was 1.1-4.2x slower at every SplitFuse shape measured,
//     launches too small to fill the card included (PERF.md section 6);
//   * determinism: no atomics; every sum runs in an order fixed by context
//     positions and the chunks' assignment to groups, so two calls give the
//     same bits.
//
// float32 path, ragged_paged_kernel: the exact CUDA-core kernel (float32
// staging and FMAs, expf), with the same tiles, head dims and ALiBi, one CTA
// a tile and no split; it serves the float32 checks.
//
// A row whose softmax mass is 0 (no visible key) writes 0; padding rows no
// tile covers keep the zeros the wrapper hands in.
#include "hopper_async.cuh"
#include "paged_common.cuh"
#include "tile_mma.cuh"

namespace dstorch {
namespace {

constexpr int kRows = 64;      // rows a tile: tokens x a group slice
// bf16: kGroups groups of four warps (16 rows each) walk alternate chunks
constexpr int kGroups = 2;
constexpr int kGroupThreads = 128;
constexpr int kMmaThreads = kGroups * kGroupThreads;
constexpr int kStages = 2;     // a group's ring of chunks
constexpr float kLog2e = 1.4426950408889634f;

enum AlibiMode : int { kNoAlibi = 0, kBloom = 1, kFalcon = 2 };

// Tile geometry of a group of G query heads: n_gs slices of GS heads, BQ
// tokens a tile. The wrapper computes the same numbers.
__host__ __device__ inline void tile_geometry(int G, int& n_gs, int& GS,
                                              int& BQ) {
  n_gs = (G + kRows - 1) / kRows;
  GS = (G + n_gs - 1) / n_gs;
  BQ = kRows / GS;
}

struct Tile {
  int s, seq_q0, q_len, t0, t1, g0, g1, kvl, q_pos0, eff_kvl;
};

// Warp-wide: tile `tile` of the flat list (sequences in order; within a
// sequence token blocks in order, each cut into its n_gs group slices), or
// false past the last tile. Every lane of the calling warp must call it.
__device__ bool find_tile(const int* __restrict__ cu,
                          const int* __restrict__ kv_lens, int S, int G,
                          int n_gs, int GS, int BQ, int tile, Tile& out) {
  const int lane = threadIdx.x & 31;
  int before = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    int a = 0, b = 0;
    if (s < S) {
      a = cu[s];
      b = cu[s + 1];
    }
    const int n = b > a ? (b - a + BQ - 1) / BQ * n_gs : 0;
    int inc = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    const int total = __shfl_sync(0xffffffffu, inc, 31);
    if (tile < before + total) {
      const unsigned hit = __ballot_sync(0xffffffffu, before + inc > tile);
      const int L = __ffs(hit) - 1;
      const int excl = __shfl_sync(0xffffffffu, inc - n, L);
      const int sa = __shfl_sync(0xffffffffu, a, L);
      const int sb = __shfl_sync(0xffffffffu, b, L);
      const int j = tile - before - excl;
      out.s = s0 + L;
      out.seq_q0 = sa;
      out.q_len = sb - sa;
      out.t0 = sa + (j / n_gs) * BQ;
      out.t1 = min(out.t0 + BQ, sb);
      out.g0 = (j % n_gs) * GS;
      out.g1 = min(out.g0 + GS, G);
      out.kvl = kv_lens[out.s];
      out.q_pos0 = out.kvl - out.q_len + (out.t0 - sa);
      // causal bound of the tile's last row: its position + 1
      out.eff_kvl = max(0, min(out.kvl, out.kvl - out.q_len + (out.t1 - sa)));
      return true;
    }
    before += total;
  }
  return false;
}

// The ALiBi bias of one score (Bloom: slope * k_pos in float32; Falcon:
// bf16(slope) * bf16(k_pos) * scale: k_pos above 256 rounds in bf16, and
// the product of the two bf16 values is exact in float32 and is not
// rounded to bf16 again, as XLA computes the reference's
// (slope.astype(bf16) * k_pos.astype(bf16)).astype(f32) under jit, where
// its simplifier drops the bf16 round trip of the product).
__device__ __forceinline__ float alibi_bias(int mode, float slope, int k_pos,
                                            float scale) {
  if (mode == kBloom) return __fmul_rn(slope, (float)k_pos);
  const float a = __bfloat162float(__float2bfloat16_rn(slope));
  const float b = __bfloat162float(__float2bfloat16_rn((float)k_pos));
  return __fmul_rn(__fmul_rn(a, b), scale);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HDP>
struct MmaCfg {
  static constexpr int kChunk = HDP == 256 ? 32 : 64;  // positions a chunk
  static constexpr int kLd = HDP + 8;                  // padded bf16 row
  static constexpr size_t kQBytes = (size_t)kRows * kLd * 2;
  static constexpr size_t kKVBytes = (size_t)kChunk * kLd * 2;
  static constexpr size_t kRingBytes = kGroups * 2 * kStages * kKVBytes;
  // a later group's softmax state, fragment by fragment, for the merge
  static constexpr size_t kStateBytes =
      (size_t)(kGroups - 1) * kGroupThreads * (HDP / 2 + 4) * 4;
  static constexpr size_t kBytes =
      kQBytes + (kRingBytes > kStateBytes ? kRingBytes : kStateBytes);
};

struct RaggedArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pages;
  const int* kv_lens;
  const int* page_table;
  const int* cu_q_lens;
  const float* slopes;  // [H] float32, or null
  __nv_bfloat16* out;
  int H, KV, G, n_gs, GS, BQ, hd, ps, S, NB, vb, alibi;
  float scale;
};

template <int HDP>
__global__ void __launch_bounds__(kMmaThreads, 1)
ragged_paged_mma_kernel(const RaggedArgs a) {
  using C = MmaCfg<HDP>;
  constexpr int KC = C::kChunk, LD = C::kLd;
  constexpr int NT = KC / 8;     // score n-tiles a warp
  constexpr int ND = HDP / 8;    // output d-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // [group][stage][K | V][KC][LD]
  __nv_bfloat16* KVs = Qs + kRows * LD;
  __shared__ long long off[kGroups][kStages][KC];  // row offsets, -1: none
  __shared__ Tile tile_s;
  __shared__ int found_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, gw = warp % 4, gtid = tid % kGroupThreads;
  const int h = blockIdx.y;
  if (warp == 0) {
    Tile t;
    const bool f = find_tile(a.cu_q_lens, a.kv_lens, a.S, a.G, a.n_gs, a.GS,
                             a.BQ, blockIdx.x, t);
    if (lane == 0) {
      found_s = f;
      if (f) tile_s = t;
    }
  }
  __syncthreads();
  if (!found_s) return;
  const Tile tl = tile_s;
  const int hi = tl.eff_kvl;                          // the walk's end
  if (hi <= 0) return;                // no visible key: the rows stay 0
  const int n_chunks = (hi + KC - 1) / KC;
  // group grp walks chunks grp, grp + kGroups, ...: n_mine of them
  const int n_mine = n_chunks > grp ? (n_chunks - grp + kGroups - 1) / kGroups
                                    : 0;
  const int hd = a.hd, two_kv = 2 * a.KV;
  const int ve = a.vb / 2;                            // elements a copy
  const int units = hd / ve;                          // copies a row

  // columns hd .. HDP of Q and of every K/V stage are zero for good
  {
    const int padc = HDP - hd;
    if (padc > 0) {
      const int rows = kRows + kGroups * 2 * kStages * KC;
      for (int i = tid; i < rows * padc; i += kMmaThreads) {
        const int r = i / padc, c = hd + i % padc;
        Qs[r * LD + c] = __float2bfloat16_rn(0.f);  // Qs, then the rings
      }
    }
  }
  // this group's thread gtid < KC owns position c * KC + gtid of its
  // chunks c: its page id is read one iteration before that chunk's row
  // offset is written, so the page-table load is in flight across a whole
  // chunk's compute
  auto page_id = [&](int c) {
    const int pos = c * KC + gtid;
    return pos < hi ? a.page_table[(size_t)tl.s * a.NB + pos / a.ps] : -1;
  };
  auto set_offset = [&](int c, int buf, int pid) {
    const int pos = c * KC + gtid;
    off[grp][buf][gtid] = pid < 0 ? -1
        : (((long long)pid * a.ps + pos % a.ps) * two_kv + h) * hd;
  };
  // a thread's copies: when its group's threads tile a row's copies
  // evenly, each thread keeps one column and steps over rows
  const bool even = kGroupThreads % units == 0;
  const int j0 = even ? gtid / units : 0;
  const int jstep = even ? kGroupThreads / units : 0;
  const int e0 = even ? (gtid % units) * ve : 0;
  auto issue_chunk = [&](int buf) {
    __nv_bfloat16* Ks = KVs + ((size_t)grp * kStages + buf) * 2 * KC * LD;
    __nv_bfloat16* Vs = Ks + KC * LD;
    auto copy_row = [&](int j, int e) {
      const long long o = off[grp][buf][j];
      const bool ok = o >= 0;
      const __nv_bfloat16* src = ok ? a.pages + o + e : a.pages;
      copy_vb(Ks + j * LD + e, src, a.vb, ok);
      copy_vb(Vs + j * LD + e, ok ? src + (size_t)a.KV * hd : a.pages, a.vb,
              ok);
    };
    if (even) {
      for (int j = j0; j < KC; j += jstep) copy_row(j, e0);
    } else {
      for (int i = gtid; i < KC * units; i += kGroupThreads)
        copy_row(i / units, (i % units) * ve);
    }
  };

  // Q rows: row r = token r / GS, head g0 + r % GS of the slice
  for (int i = tid; i < kRows * units; i += kMmaThreads) {
    const int r = i / units, e = (i % units) * ve;
    const int t = tl.t0 + r / a.GS, g = tl.g0 + r % a.GS;
    const bool ok = r < a.BQ * a.GS && t < tl.t1 && g < tl.g1;
    const __nv_bfloat16* src =
        ok ? a.q + ((size_t)t * a.H + (size_t)h * a.G + g) * hd + e : a.q;
    copy_vb(Qs + r * LD + e, src, a.vb, ok);
  }
  // each group's first kStages - 1 chunks in flight (Q rides with them)
  int pid_next = -1;
  if (gtid < KC) {
    for (int i = 0; i < kStages - 1; ++i)
      set_offset(grp + i * kGroups, i, page_id(grp + i * kGroups));
    pid_next = page_id(grp + (kStages - 1) * kGroups);
  }
  __syncthreads();
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) issue_chunk(i);
    cp_async_commit();
  }

  // this thread's rows: r_lo = 16 gw + lane / 4 and r_lo + 8
  const int g4 = lane >> 2, t4 = lane & 3;
  int q_pos[2];
  float slope[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * gw + g4 + 8 * hh;
    q_pos[hh] = tl.q_pos0 + r / a.GS;
    const int g = min(tl.g0 + r % a.GS, a.G - 1);
    slope[hh] = a.alibi ? a.slopes[h * a.G + g] : 0.f;
  }
  const float c2 = a.scale * kLog2e;
  const int nk16 = (hd + 15) / 16;  // 16-column steps that cover hd

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const uint32_t q_base = smem_addr(
      Qs + (16 * gw + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
      8 * (lane / 16));
  for (int i = 0; i < n_mine; ++i) {
    const int ahead = i + kStages - 1;  // the chunk whose copies start now
    if (gtid < KC) {
      if (ahead < n_mine)
        set_offset(grp + ahead * kGroups, ahead % kStages, pid_next);
      pid_next = page_id(grp + (ahead + 1) * kGroups);
    }
    named_bar_sync(1 + grp, kGroupThreads);  // offsets visible; stage free
    if (ahead < n_mine) issue_chunk(ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    named_bar_sync(1 + grp, kGroupThreads);  // chunk i landed
    const int c = grp + i * kGroups;

    const __nv_bfloat16* Ks =
        KVs + ((size_t)grp * kStages + i % kStages) * 2 * KC * LD;
    const __nv_bfloat16* Vs = Ks + KC * LD;
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    // S = Q.K^T: B fragments of two n-tiles per ldmatrix.x4 (keys
    // 16 np + lane % 8 (+ 8 for lanes 16-31), columns kk, kk + 8)
    const uint32_t k_base = smem_addr(
        Ks + ((lane % 8) + 8 * (lane / 16)) * LD + 8 * ((lane / 8) % 2));
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (kk < nk16) {
        uint32_t qa[4];
        ldmatrix_x4(qa, q_base + kk * 32);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_base + (np * 16 * LD + kk * 16) * 2);
          mma_bf16_16816(sc[2 * np], qa[0], qa[1], qa[2], qa[3], kb[0],
                         kb[1]);
          mma_bf16_16816(sc[2 * np + 1], qa[0], qa[1], qa[2], qa[3], kb[2],
                         kb[3]);
        }
      }
    }
    // scores in base 2 (the ALiBi bias added first; the branch is the
    // same for the whole launch), the mask on the diagonal and tail chunks
    const int base = c * KC;
    if (a.alibi) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = base + 8 * nt + 2 * t4 + (e & 1);
          sc[nt][e] = __fmul_rn(
              __fmaf_rn(sc[nt][e], a.scale,
                        alibi_bias(a.alibi, slope[e >> 1], k_pos, a.scale)),
              kLog2e);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] *= c2;
    }
    if (base + KC - 1 > tl.q_pos0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = base + 8 * nt + 2 * t4 + (e & 1);
          if (k_pos > q_pos[e >> 1]) sc[nt][e] = kNegInf;
        }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * hh], sc[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[nt][2 * hh + e];
          // a masked entry weighs exactly 0 whatever m is; a NaN score (a
          // poisoned page of this sequence) stays NaN, as in the reference
          const float p = x == kNegInf ? 0.f : ex2(x - m_new);
          sc[nt][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    // O += P.V: P rounded to bf16 as the A operand; V's B fragments by
    // ldmatrix.trans (keys 16 kk + lane % 8 (+ 8 for lanes 8-15, 24-31),
    // columns 16 ndp (+ 8 for lanes 16-31))
    const uint32_t v_base = smem_addr(
        Vs + ((lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16));
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint32_t pa0 = pack_bf16(__float2bfloat16_rn(sc[2 * kk][0]),
                                     __float2bfloat16_rn(sc[2 * kk][1]));
      const uint32_t pa1 = pack_bf16(__float2bfloat16_rn(sc[2 * kk][2]),
                                     __float2bfloat16_rn(sc[2 * kk][3]));
      const uint32_t pa2 = pack_bf16(__float2bfloat16_rn(sc[2 * kk + 1][0]),
                                     __float2bfloat16_rn(sc[2 * kk + 1][1]));
      const uint32_t pa3 = pack_bf16(__float2bfloat16_rn(sc[2 * kk + 1][2]),
                                     __float2bfloat16_rn(sc[2 * kk + 1][3]));
#pragma unroll
      for (int ndp = 0; ndp < ND / 2; ++ndp) {
        if (ndp < nk16) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, v_base + (kk * 16 * LD + ndp * 16) * 2);
          mma_bf16_16816(o[2 * ndp], pa0, pa1, pa2, pa3, vb[0], vb[1]);
          mma_bf16_16816(o[2 * ndp + 1], pa0, pa1, pa2, pa3, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the groups' states merged in group order into group 0's registers:
  // m* = max, each side weighed by 2^(m - m*); fragment by fragment, so
  // the rows of a thread of group g sit in the same registers as group 0's
  if constexpr (kGroups > 1) {
    float* st = reinterpret_cast<float*>(KVs);   // the rings, now free
    constexpr int W = HDP / 2 + 4;               // floats a thread's state
    __syncthreads();
    if (grp > 0) {
      float* mine = st + ((size_t)(grp - 1) * kGroupThreads + gtid) * W;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[4 * nd + e] = o[nd][e];
      mine[HDP / 2] = m[0];
      mine[HDP / 2 + 1] = m[1];
      mine[HDP / 2 + 2] = l[0];
      mine[HDP / 2 + 3] = l[1];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g = 1; g < kGroups; ++g) {
      const float* th = st + ((size_t)(g - 1) * kGroupThreads + gtid) * W;
      float f0[2], f1[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mo = th[HDP / 2 + hh];
        const float m_new = fmaxf(m[hh], mo);
        f0[hh] = ex2(m[hh] - m_new);
        f1[hh] = ex2(mo - m_new);
        m[hh] = m_new;
        l[hh] = l[hh] * f0[hh] + th[HDP / 2 + 2 + hh] * f1[hh];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nd][e] = o[nd][e] * f0[e >> 1] + th[4 * nd + e] * f1[e >> 1];
    }
  }

  // the four lanes of a row hold partial sums of l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * gw + g4 + 8 * hh;
    const int t = tl.t0 + r / a.GS, g = tl.g0 + r % a.GS;
    if (r >= a.BQ * a.GS || t >= tl.t1 || g >= tl.g1) continue;
    const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
    __nv_bfloat16* orow =
        a.out + ((size_t)t * a.H + (size_t)h * a.G + g) * hd;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = 8 * nd + 2 * t4;
      const float x = o[nd][2 * hh] * inv, y = o[nd][2 * hh + 1] * inv;
      if ((hd & 1) == 0 && d + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(x, y);
      } else {
        if (d < hd) orow[d] = __float2bfloat16_rn(x);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// float32: the exact CUDA-core kernel
// ---------------------------------------------------------------------- //
constexpr int kF32Threads = 256;
constexpr int kF32Chunk = 64;

template <int HDP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kRows * (HDP + 1)          // Qs
                          + kF32Chunk * (HDP + 1)    // Ks
                          + kF32Chunk * HDP          // Vs
                          + kRows * (kF32Chunk + 1)  // Ss
                          + 3 * kRows);              // m, l, alpha
}

template <int HDP>
__global__ void __launch_bounds__(kF32Threads)
ragged_paged_kernel(const float* __restrict__ q,
                    const float* __restrict__ pages,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_table,
                    const int* __restrict__ cu_q_lens,
                    const float* __restrict__ slopes, float* __restrict__ out,
                    int H, int KV, int G, int n_gs, int GS, int BQ, int hd,
                    int ps, int S, int NB, int alibi, float scale) {
  constexpr int QS = HDP + 1;           // padded row stride of Qs / Ks
  constexpr int SS = kF32Chunk + 1;     // padded row stride of Ss
  constexpr int DPT = HDP / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * QS;
  float* Vs = Ks + kF32Chunk * QS;
  float* Ss = Vs + kF32Chunk * HDP;
  float* m_s = Ss + kRows * SS;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  __shared__ Tile tile_s;
  __shared__ int found_s;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  if (tid < 32) {
    Tile t;
    const bool f = find_tile(cu_q_lens, kv_lens, S, G, n_gs, GS, BQ,
                             blockIdx.x, t);
    if (tid == 0) {
      found_s = f;
      if (f) tile_s = t;
    }
  }
  __syncthreads();
  if (!found_s) return;
  const Tile tl = tile_s;
  const int two_kv = 2 * KV;
  const int rows = BQ * GS;

  for (int idx = tid; idx < kRows * HDP; idx += kF32Threads) {
    const int r = idx / HDP, d = idx % HDP;
    const int t = tl.t0 + r / GS, g = tl.g0 + r % GS;
    float v = 0.f;
    if (r < rows && t < tl.t1 && g < tl.g1 && d < hd)
      v = q[((size_t)t * H + (size_t)h * G + g) * hd + d];
    Qs[r * QS + d] = v;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // thread (ty, tx) owns rows ty + 16 i and score columns tx + 16 j,
  // output columns tx + 16 c
  const int ty = tid / 16, tx = tid % 16;
  int q_pos[4];
  float slope[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    q_pos[i] = tl.q_pos0 + r / GS;
    const int g = min(tl.g0 + r % GS, G - 1);
    slope[i] = alibi ? slopes[h * G + g] : 0.f;
  }
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  const int n_chunks = (tl.eff_kvl + kF32Chunk - 1) / kF32Chunk;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int base = ck * kF32Chunk;
    __syncthreads();  // the previous chunk is done with Ks, Vs and Ss
    for (int idx = tid; idx < kF32Chunk * HDP; idx += kF32Threads) {
      const int j = idx / HDP, d = idx % HDP;
      const int pos = base + j;
      float kf = 0.f, vf = 0.f;
      if (pos < tl.eff_kvl && d < hd) {
        const int pid = page_table[(size_t)tl.s * NB + pos / ps];
        const float* row = pages + ((size_t)pid * ps + pos % ps) * two_kv * hd;
        kf = row[h * hd + d];
        vf = row[(KV + h) * hd + d];
      }
      Ks[j * QS + d] = kf;
      Vs[j * HDP + d] = vf;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, k_pos = base + col;
        const bool ok = k_pos <= q_pos[i] && k_pos < tl.kvl;
        const float x =
            alibi ? __fmaf_rn(sc[i][j], scale,
                              alibi_bias(alibi, slope[i], k_pos, scale))
                  : sc[i][j] * scale;
        Ss[(ty + 16 * i) * SS + col] = ok ? x : kNegInf;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * SS + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // masked entries weigh exactly 0, whatever m_new is; a NaN score
        // (a poisoned page of this sequence) stays NaN, as in the reference
        const float p = srow[j] != kNegInf ? expf(srow[j] - m_new) : 0.f;
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kF32Chunk; ++j) {
      float p[4], v[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) v[c] = Vs[j * HDP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
    }
  }
  __syncthreads();  // l_s final (also when the walk was empty)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = tl.t0 + r / GS, g = tl.g0 + r % GS;
    if (r >= rows || t >= tl.t1 || g >= tl.g1) continue;
    const float l = l_s[r];
    const float denom = l == 0.f ? 1.f : l;
    float* o = out + ((size_t)t * H + (size_t)h * G + g) * hd;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = acc[i][c] / denom;
    }
  }
}

// Dynamic shared memory above 48 KB, allowed once per kernel (one card a
// process).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <int HDP>
cudaError_t launch_bf16(RaggedArgs a, int slots, cudaStream_t stream) {
  constexpr size_t smem = MmaCfg<HDP>::kBytes;
  static bool allowed = false;
  cudaError_t err = allow_smem(ragged_paged_mma_kernel<HDP>, smem, allowed);
  if (err != cudaSuccess) return err;
  ragged_paged_mma_kernel<HDP><<<dim3(slots, a.KV), kMmaThreads, smem,
                                 stream>>>(a);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_f32(const RaggedArgs& a, const void* q, const void* pages,
                       void* out, int slots, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HDP>();
  static bool allowed = false;
  const cudaError_t err = allow_smem(ragged_paged_kernel<HDP>, smem, allowed);
  if (err != cudaSuccess) return err;
  ragged_paged_kernel<HDP><<<dim3(slots, a.KV), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pages),
      a.kv_lens, a.page_table, a.cu_q_lens, a.slopes,
      static_cast<float*>(out), a.H, a.KV, a.G, a.n_gs, a.GS, a.BQ, a.hd,
      a.ps, a.S, a.NB, a.alibi, a.scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// q [T, H, hd], pages [NP, ps, 2KV, hd], kv_lens [S], page_table [S, NB],
// cu_q_lens [S+1] (int32), out [T, H, hd] zeroed by the caller; hd <= 256,
// any G = H / KV. slopes: float32 [H] ALiBi slopes, or null with alibi 0
// (1: Bloom, 2: Falcon). vb: bytes a copy (16, 8, 4 or 2), dividing hd * 2
// and both base pointers (bf16). Launches on `stream`, allocates nothing,
// does not synchronise; returns the launch's cudaError_t (0 on success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* pages, const void* kv_lens,
    const void* page_table, const void* cu_q_lens, const void* slopes,
    void* out, int T_tokens, int H, int KV, int hd, int ps, int S, int NB,
    float scale, int alibi, int vb, int dtype, void* stream) {
  using namespace dstorch;
  if (T_tokens == 0 || S == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 || ps <= 0 || NB <= 0 ||
      (alibi != kNoAlibi && slopes == nullptr))
    return cudaErrorInvalidValue;
  RaggedArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pages = static_cast<const __nv_bfloat16*>(pages);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.page_table = static_cast<const int*>(page_table);
  a.cu_q_lens = static_cast<const int*>(cu_q_lens);
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  tile_geometry(a.G, a.n_gs, a.GS, a.BQ);
  a.hd = hd;
  a.ps = ps;
  a.S = S;
  a.NB = NB;
  a.alibi = alibi;
  a.scale = scale;
  a.vb = vb;
  // tile slots: an upper bound on the tiles, (ceil(T / BQ) + S) * n_gs
  const int slots = ((T_tokens + a.BQ - 1) / a.BQ + S) * a.n_gs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hdp = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  if (dtype == kF32) {
    if (hdp == 64) return launch_f32<64>(a, q, pages, out, slots, st);
    if (hdp == 128) return launch_f32<128>(a, q, pages, out, slots, st);
    return launch_f32<256>(a, q, pages, out, slots, st);
  }
  if (dtype != kBF16 || (vb != 16 && vb != 8 && vb != 4 && vb != 2) ||
      (hd * 2) % vb)
    return cudaErrorInvalidValue;
  if (hdp == 64) return launch_bf16<64>(a, slots, st);
  if (hdp == 128) return launch_bf16<128>(a, slots, st);
  return launch_bf16<256>(a, slots, st);
}
