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
// a KV head share each K/V fetch.
//
// Design. The TPU grid walks flat-token blocks in order and searches the
// sequences inside the kernel. Here blocks run in parallel, so each CUDA
// block owns one (query tile, KV head): a tile is up to BQ consecutive
// query tokens of ONE sequence, BQ = 64 / G, so a block holds R = BQ*G <= 64
// query rows. The tile list is not materialised: block i scans cu_q_lens
// (O(S) integer work in one thread) for the sequence whose tiles cover i,
// so interior sequences with zero query tokens are skipped and there is no
// host sync. The grid is an upper bound, ceil(T / BQ) + S tiles; blocks past
// the real tile count exit at once. Rows no tile covers are padding: the
// wrapper hands in a zeroed output.
//
// Per chunk of 64 context positions the block stages that head's K and V
// rows in shared memory (float32), computes the [R, 64] scores on CUDA
// cores, updates the online softmax in float32 and accumulates P.V in
// registers. The walk stops at the tile's causal bound eff_kvl (the bound
// of its last row); positions at or past it are never loaded, and their K
// and V rows are zero in shared memory (select before multiply), so a NaN
// in a page nobody should read cannot reach the sum. A row whose softmax
// mass l is 0 writes 0.
//
// NaN isolation holds by construction: a block reads only its own
// sequence's pages, so a poisoned sequence cannot touch another's rows.
//
// Bound on this card: for long prompts, operations,
// 4 * H * hd * (sum over sequences of causal query-key pairs) flops;
// for short ones, the bytes of q, out and each sequence's K/V context.
// What the simple design leaves on the table: CUDA-core FMAs instead of
// wgmma/mma.sync (the tensor cores are ~15x faster in bf16); no TMA or
// cp.async double buffering, so each chunk's loads are exposed; K/V are
// re-read once per query tile of a sequence (L2 absorbs most of it); and
// 116 KB of shared memory at hd=128 allows one block per SM.
#include "paged_common.cuh"

namespace dstorch {
namespace {

constexpr int kRows = 64;     // query rows per block (BQ * G <= 64)
constexpr int kChunk = 64;    // context positions per chunk
constexpr int kThreads = 256;

template <int HD>
constexpr size_t ragged_smem_bytes() {
  return sizeof(float) * (kRows * (HD + 1)        // Qs
                          + kChunk * (HD + 1)     // Ks
                          + kChunk * HD           // Vs
                          + kRows * (kChunk + 1)  // Ss
                          + 3 * kRows);           // m, l, alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const T* __restrict__ q, const T* __restrict__ pages,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_table,
                    const int* __restrict__ cu_q_lens, T* __restrict__ out,
                    int H, int KV, int G, int BQ, int ps, int S, int NB,
                    float scale) {
  constexpr int QS = HD + 1;           // padded row stride of Qs / Ks
  constexpr int SS = kChunk + 1;       // padded row stride of Ss
  constexpr int DPT = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * QS;
  float* Vs = Ks + kChunk * QS;
  float* Ss = Vs + kChunk * HD;
  float* m_s = Ss + kRows * SS;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  __shared__ int tile_info[4];         // seq, first token, end token, found

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  if (tid == 0) {
    const int tile = blockIdx.x;
    int before = 0;
    tile_info[3] = 0;
    for (int s = 0; s < S; ++s) {
      const int a = cu_q_lens[s], b = cu_q_lens[s + 1];
      const int n = b > a ? (b - a + BQ - 1) / BQ : 0;
      if (tile < before + n) {
        const int t0 = a + (tile - before) * BQ;
        tile_info[0] = s;
        tile_info[1] = t0;
        tile_info[2] = min(t0 + BQ, b);
        tile_info[3] = 1;
        break;
      }
      before += n;
    }
  }
  __syncthreads();
  if (!tile_info[3]) return;
  const int s = tile_info[0], t0 = tile_info[1], t1 = tile_info[2];
  const int kvl = kv_lens[s];
  const int seq_q0 = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - seq_q0;
  const int rows = (t1 - t0) * G;
  // causal bound of the tile's last row
  const int eff_kvl = max(0, min(kvl, kvl - q_len + (t1 - 1 - seq_q0) + 1));
  const int two_kv = 2 * KV;

  for (int idx = tid; idx < kRows * (HD / 4); idx += kThreads) {
    const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int t = t0 + r / G, hq = h * G + r % G;
      v = load4(q + ((size_t)t * H + hq) * HD + d);
    }
    float* dst = Qs + r * QS + d;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // thread (ty, tx) owns rows ty + 16 i and score columns tx + 16 j,
  // output columns tx + 16 c
  const int ty = tid / 16, tx = tid % 16;
  int q_pos[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    row_ok[i] = r < rows;
    q_pos[i] = kvl - q_len + (t0 + r / G - seq_q0);
  }
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  const int n_chunks = (eff_kvl + kChunk - 1) / kChunk;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int base = ck * kChunk;
    __syncthreads();  // the previous chunk is done with Ks, Vs and Ss
    for (int idx = tid; idx < kChunk * (HD / 4); idx += kThreads) {
      const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      const int pos = base + j;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (pos < eff_kvl) {
        const int pid = page_table[(size_t)s * NB + pos / ps];
        const T* row = pages + ((size_t)pid * ps + pos % ps) * two_kv * HD;
        kf = load4(row + h * HD + d);
        vf = load4(row + (KV + h) * HD + d);
      }
      float* kd = Ks + j * QS + d;
      kd[0] = kf.x; kd[1] = kf.y; kd[2] = kf.z; kd[3] = kf.w;
      float* vd = Vs + j * HD + d;
      vd[0] = vf.x; vd[1] = vf.y; vd[2] = vf.z; vd[3] = vf.w;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
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
        const bool ok = row_ok[i] && k_pos <= q_pos[i] && k_pos < kvl;
        Ss[(ty + 16 * i) * SS + col] = ok ? sc[i][j] * scale : kNegInf;
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
    for (int j = 0; j < kChunk; ++j) {
      float p[4], v[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) v[c] = Vs[j * HD + tx + 16 * c];
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
    if (r >= rows) continue;
    const float l = l_s[r];
    const float denom = l == 0.f ? 1.f : l;
    const int t = t0 + r / G, hq = h * G + r % G;
    T* o = out + ((size_t)t * H + hq) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pages, const int* kv_lens,
                   const int* page_table, const int* cu_q_lens, void* out,
                   int T_tokens, int H, int KV, int ps, int S, int NB,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = ragged_smem_bytes<HD>();
  static bool configured = false;  // one card per process in this slice
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int G = H / KV;
  const int BQ = kRows / G;
  const int tiles = (T_tokens + BQ - 1) / BQ + S;
  dim3 grid(tiles, KV);
  ragged_paged_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), kv_lens,
      page_table, cu_q_lens, static_cast<T*>(out), H, KV, G, BQ, ps, S, NB,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// q [T, H, hd], pages [NP, ps, 2KV, hd], kv_lens [S], page_table [S, NB],
// cu_q_lens [S+1] (int32), out [T, H, hd] zeroed by the caller. Launches on
// `stream`, allocates nothing, does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* pages, const void* kv_lens,
    const void* page_table, const void* cu_q_lens, void* out, int T_tokens,
    int H, int KV, int hd, int ps, int S, int NB, float scale, int dtype,
    void* stream) {
  using namespace dstorch;
  if (T_tokens == 0 || S == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || H / KV > 8) return cudaErrorInvalidValue;
  const int* kvl = static_cast<const int*>(kv_lens);
  const int* pt = static_cast<const int*>(page_table);
  const int* cu = static_cast<const int*>(cu_q_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && hd == 64)
    return launch<float, 64>(q, pages, kvl, pt, cu, out, T_tokens, H, KV, ps,
                             S, NB, scale, st);
  if (dtype == kF32 && hd == 128)
    return launch<float, 128>(q, pages, kvl, pt, cu, out, T_tokens, H, KV, ps,
                              S, NB, scale, st);
  if (dtype == kBF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, pages, kvl, pt, cu, out, T_tokens, H,
                                     KV, ps, S, NB, scale, st);
  if (dtype == kBF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, pages, kvl, pt, cu, out, T_tokens, H,
                                      KV, ps, S, NB, scale, st);
  return cudaErrorInvalidValue;
}
