// Decode paged attention (one query token per sequence), for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   deepspeed_tpu/inference/v2/kernels/ragged_ops.py::_decode_paged_kernel
// (driven by decode_paged_attention). Sequence s's single query token sits
// at row s of q and attends to every cached position k_pos < kv_lens[s],
// read page by page through page_table[s]. Rows with kv_lens == 0 are
// padding and write 0.
//
// Design. One CUDA block per (sequence, KV head), so the grid is S x KV, and
// the block holds the G <= 8 query rows of that head group in registers
// (each lane keeps hd/32 elements of every row). The block walks the
// context in chunks of 64 positions:
//   1. scores: the 4 warps split the chunk's positions; a warp reads one K
//      row (coalesced, hd elements across its 32 lanes) and reduces the G
//      dot products with shuffles;
//   2. online softmax in float32 (warp 0, one row at a time);
//   3. P.V: each thread owns one output column d (two threads per column at
//      hd = 64, summed at the end) and accumulates the G rows in float32.
// Positions at or past kv_lens are never read, so V there never meets a
// weight (select before multiply), and a block reads only its own
// sequence's pages: a NaN-poisoned sequence cannot reach another's rows.
//
// Bound on this card: bytes. A decode step must read each sequence's
// context once, sum_s kv_lens[s] * 2 * KV * hd * sizeof(elem), against
// 4 * H * hd * sum_s kv_lens[s] flops, i.e. ~2 flops per byte in bf16 at
// G = 4, far below the ~295 the tensor cores need to be the limit.
// What the simple design leaves on the table: S x KV blocks under-fill the
// 132 SMs at small batch (16 x 8 = 128 blocks of 4 warps each is ~1 block
// per SM), and each block walks its whole context serially with exposed
// load latency. Splitting the context across blocks (flash-decoding, with
// a second pass to merge the partial softmax states) and cp.async/TMA
// prefetch of the next chunk are later work.
#include "paged_common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kMaxG = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ pages,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_table, T* __restrict__ out,
                    int H, int KV, int G, int ps, int NB, float scale) {
  constexpr int EPL = HD / 32;           // elements of a row per lane
  constexpr int NPART = kThreads / HD;   // threads per output column
  __shared__ float Ss[kMaxG][kChunk];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];
  __shared__ float part_acc[NPART > 1 ? NPART : 1][kMaxG][HD];

  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvl = kv_lens[s];
  const int two_kv = 2 * KV;

  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < G ? to_f(q[((size_t)s * H + h * G + g) * HD +
                                lane * EPL + e])
                       : 0.f;
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int d = tid % HD, part = tid / HD;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int base = 0; base < kvl; base += kChunk) {
    const int n = min(kChunk, kvl - base);
    __syncthreads();  // init visible; the previous chunk is done with Ss
    for (int j = warp; j < n; j += kWarps) {
      const int pos = base + j;
      const int pid = page_table[(size_t)s * NB + pos / ps];
      const T* krow = pages + (((size_t)pid * ps + pos % ps) * two_kv + h) * HD
                      + lane * EPL;
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = to_f(krow[e]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          dot = warp_sum(dot);
          if (lane == 0) Ss[g][j] = dot * scale;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int g = 0; g < G; ++g) {
        const float s0 = lane < n ? Ss[g][lane] : kNegInf;
        const float s1 = lane + 32 < n ? Ss[g][lane + 32] : kNegInf;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
        const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
        Ss[g][lane] = p0;
        Ss[g][lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= a_s[g];
    for (int j = part; j < n; j += NPART) {
      const int pos = base + j;
      const int pid = page_table[(size_t)s * NB + pos / ps];
      const float v = to_f(
          pages[(((size_t)pid * ps + pos % ps) * two_kv + KV + h) * HD + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(Ss[g][j], v, acc[g]);
    }
  }
  if (NPART > 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part_acc[part][g][d] = acc[g];
  }
  __syncthreads();  // l_s final (also when kvl == 0), partial sums visible
  if (part != 0) return;
  if (NPART > 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      float total = 0.f;
#pragma unroll
      for (int p = 0; p < NPART; ++p) total += part_acc[p][g][d];
      acc[g] = total;
    }
  }
  for (int g = 0; g < G; ++g) {
    const float l = l_s[g];
    out[((size_t)s * H + h * G + g) * HD + d] =
        from_f<T>(acc[g] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pages, const int* kv_lens,
                   const int* page_table, void* out, int S, int H, int KV,
                   int ps, int NB, float scale, cudaStream_t stream) {
  dim3 grid(S, KV);
  decode_paged_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), kv_lens,
      page_table, static_cast<T*>(out), H, KV, H / KV, ps, NB, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// q [S, H, hd], pages [NP, ps, 2KV, hd], kv_lens [S], page_table [S, NB]
// (int32), out [S, H, hd]. Launches on `stream`, allocates nothing, does not
// synchronise; returns the launch's cudaError_t (0 on success).
extern "C" int decode_paged_attention_launch(
    const void* q, const void* pages, const void* kv_lens,
    const void* page_table, void* out, int S, int H, int KV, int hd, int ps,
    int NB, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (S == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG) return cudaErrorInvalidValue;
  const int* kvl = static_cast<const int*>(kv_lens);
  const int* pt = static_cast<const int*>(page_table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && hd == 64)
    return launch<float, 64>(q, pages, kvl, pt, out, S, H, KV, ps, NB, scale,
                             st);
  if (dtype == kF32 && hd == 128)
    return launch<float, 128>(q, pages, kvl, pt, out, S, H, KV, ps, NB, scale,
                              st);
  if (dtype == kBF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, pages, kvl, pt, out, S, H, KV, ps, NB,
                                     scale, st);
  if (dtype == kBF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, pages, kvl, pt, out, S, H, KV, ps,
                                      NB, scale, st);
  return cudaErrorInvalidValue;
}
