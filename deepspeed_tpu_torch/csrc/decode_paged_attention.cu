// Decode paged attention (one query token per sequence), for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   deepspeed_tpu/inference/v2/kernels/ragged_ops.py::_decode_paged_kernel
// (driven by decode_paged_attention). Sequence s's single query token sits
// at row s of q and attends to every cached position k_pos < kv_lens[s],
// read page by page through page_table[s]. Rows with kv_lens == 0 are
// padding and write 0.
//
// Bound on this card: bytes. A decode step must read each sequence's
// context once, sum_s kv_lens[s] * 2 * KV * hd * sizeof(elem), against
// 4 * H * hd * sum_s kv_lens[s] flops, i.e. ~2 flops per byte in bf16 at
// G = 4, far below the ~295 the tensor cores need to be the limit. What
// reaches that bound is many bytes in flight at once, so the design splits
// the context (flash-decoding) and never waits on a load it could have
// issued earlier:
//
//   Pass 1, decode_split_kernel: one block of 4 warps per (sequence, KV
//   head, split of kSplit = 64 context positions), NSPLIT = ceil(NB * ps /
//   kSplit) splits from the page table's width (a host-side shape: the
//   wrapper never reads kv_lens). A block whose split starts at or past
//   kv_lens[s] exits at once. A live block looks its positions' page ids up
//   once, issues every 16-byte cp.async of its K rows and then its V rows
//   for its KV head into shared memory before it uses any, and meanwhile
//   reads its G <= 8 query rows. Then, in float32: the G x 64 scores (one
//   thread a position, each dot product in order over hd), the split's max
//   and sum (one warp a query row, a fixed butterfly over the positions),
//   and the unnormalised P.V (one thread a column, positions in order).
//   It writes (acc[hd], m, l) per query head to a float32 workspace
//   [S, H, NSPLIT, hd + 2].
//   Pass 2, decode_merge_kernel: one warp per (sequence, query head) merges
//   the ceil(kv_lens[s] / kSplit) live splits in split order,
//   m* = max m_i, l* = sum exp(m_i - m*) l_i, out = sum exp(m_i - m*)
//   acc_i / l*, rounded once to the output type; kv_lens == 0 rows write 0.
//
// Every sum runs in an order fixed by context positions alone: the split
// boundaries are multiples of kSplit and a page only decides where a row is
// read from, so the output is bit-identical at every page size and from
// run to run (no atomics). Positions at or past kv_lens are never read, so
// V there never meets a weight, a split holds at least one position (its m
// is a real score, and exp never sees -inf - -inf), and a block reads only
// its own sequence's pages: a NaN-poisoned sequence cannot reach another's
// rows.
#include "hopper_async.cuh"
#include "paged_common.cuh"

namespace dstorch {
namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 64;           // context positions a split (fixed)
constexpr int kMaxG = 8;
constexpr int kMergeWarps = 4;

// First-pass splits for a page table NB pages wide of ps-row pages.
inline int split_count(int NB, int ps) {
  return (int)(((long long)NB * ps + kSplit - 1) / kSplit);
}

template <typename T, int HD>
struct SplitSmem {
  static constexpr int kLd = HD + 16 / (int)sizeof(T);  // padded row
  static constexpr int kCpr = HD * (int)sizeof(T) / 16;  // 16-byte chunks
  static constexpr size_t kBytes =
      2 * (size_t)kSplit * kLd * sizeof(T) + (size_t)kMaxG * HD * 4 +
      (size_t)kMaxG * kSplit * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ pages,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ page_table,
                    float* __restrict__ ws, int H, int KV, int G, int ps,
                    int NB, int nsplit, float scale) {
  using L = SplitSmem<T, HD>;
  constexpr int LD = L::kLd, CPR = L::kCpr, VEC = 16 / (int)sizeof(T);
  constexpr int NPART = kThreads / HD;  // threads a P.V column (1 or 2)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kSplit * LD;
  float* Qs = reinterpret_cast<float*>(Vs + kSplit * LD);  // [kMaxG][HD]
  float* Ps = Qs + kMaxG * HD;                              // [kMaxG][kSplit]
  __shared__ size_t row_off[kSplit];
  __shared__ float m_s[kMaxG], l_s[kMaxG];

  const int s = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int kvl = min(kv_lens[s], NB * ps);
  const int base = split * kSplit;
  if (base >= kvl) return;
  const int n = min(kSplit, kvl - base);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the split's page ids, once
  if (tid < n) {
    const int pos = base + tid;
    const int pid = page_table[(size_t)s * NB + pos / ps];
    row_off[tid] = (((size_t)pid * ps + pos % ps) * (2 * KV) + h) * HD;
  }
  __syncthreads();
  // every K row, then every V row, in flight before the first use
  for (int c = tid; c < n * CPR; c += kThreads) {
    const int j = c / CPR, e = (c % CPR) * VEC;
    cp_async16(Ks + j * LD + e, pages + row_off[j] + e);
  }
  cp_async_commit();
  for (int c = tid; c < n * CPR; c += kThreads) {
    const int j = c / CPR, e = (c % CPR) * VEC;
    cp_async16(Vs + j * LD + e, pages + row_off[j] + (size_t)KV * HD + e);
  }
  cp_async_commit();
  const T* qh = q + ((size_t)s * H + (size_t)h * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) Qs[i] = to_f(qh[i]);
  cp_async_wait<1>();
  __syncthreads();

  // scores: thread (j, g0) owns position j and query rows g0, g0 + 2, ...;
  // 16-byte reads of the padded K row are free of bank conflicts
  {
    const int j = tid % kSplit, g0 = tid / kSplit;
    float dot[kMaxG / 2];
#pragma unroll
    for (int i = 0; i < kMaxG / 2; ++i) dot[i] = 0.f;
    if (j < n) {
      const T* kr = Ks + j * LD;
#pragma unroll 2
      for (int d = 0; d < HD; d += VEC) {
        float kf[VEC];
        unpack16(*reinterpret_cast<const uint4*>(kr + d), kf);
#pragma unroll
        for (int i = 0; i < kMaxG / 2; ++i) {
          const int g = g0 + 2 * i;
          if (g < G) {
            const float* qg = Qs + g * HD + d;
            float acc = dot[i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc = fmaf(qg[e], kf[e], acc);
            dot[i] = acc;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxG / 2; ++i) {
      const int g = g0 + 2 * i;
      if (g < G) Ps[g * kSplit + j] = j < n ? dot[i] * scale : kNegInf;
    }
  }
  __syncthreads();

  // the split's softmax state: warp w owns query rows w and w + 4
  for (int g = warp; g < G; g += kThreads / 32) {
    const float s0 = Ps[g * kSplit + lane];
    const float s1 = Ps[g * kSplit + lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = lane < n ? expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < n ? expf(s1 - m) : 0.f;
    Ps[g * kSplit + lane] = p0;
    Ps[g * kSplit + lane + 32] = p1;
    const float l = warp_sum(p0 + p1);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // unnormalised P.V: thread (d, part) owns column d of rows part, part+2..
  const int d = tid % HD, part = tid / HD;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float v = to_f(Vs[j * LD + d]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G && g % NPART == part) acc[g] = fmaf(Ps[g * kSplit + j], v,
                                                    acc[g]);
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G && g % NPART == part) {
      float* w = ws + (((size_t)s * H + (size_t)h * G + g) * nsplit + split) *
                          (HD + 2);
      w[d] = acc[g];
      if (d == 0) {
        w[HD] = m_s[g];
        w[HD + 1] = l_s[g];
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
decode_merge_kernel(const float* __restrict__ ws,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int S, int H, int nsplit) {
  constexpr int EPL = HD / 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;  // s*H + hq
  const int lane = threadIdx.x % 32;
  if (row >= S * H) return;
  const int kvl = kv_lens[row / H];
  const int live = min((kvl + kSplit - 1) / kSplit, nsplit);
  T* o = out + (size_t)row * HD;
  if (live <= 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[lane + 32 * e] = from_f<T>(0.f);
    return;
  }
  const float* w = ws + (size_t)row * nsplit * (HD + 2);
  float m = w[HD];
  for (int i = 1; i < live; ++i) m = fmaxf(m, w[(size_t)i * (HD + 2) + HD]);
  float l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int i = 0; i < live; ++i) {
    const float* wi = w + (size_t)i * (HD + 2);
    const float a = expf(wi[HD] - m);
    l = fmaf(a, wi[HD + 1], l);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = fmaf(a, wi[lane + 32 * e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[lane + 32 * e] = from_f<T>(acc[e] / l);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pages, const int* kv_lens,
                   const int* page_table, void* out, float* ws, int S, int H,
                   int KV, int ps, int NB, int nsplit, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = SplitSmem<T, HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_split_kernel<T, HD><<<dim3(S, KV, nsplit), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages), kv_lens,
      page_table, ws, H, KV, H / KV, ps, NB, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = S * H;
  decode_merge_kernel<T, HD><<<(rows + kMergeWarps - 1) / kMergeWarps,
                               kMergeWarps * 32, 0, stream>>>(
      ws, kv_lens, static_cast<T*>(out), S, H, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// The workspace's split count for a page table NB pages wide of ps-row
// pages: ceil(NB * ps / kSplit). The one definition of the split, which the
// caller reads to allocate the workspace.
extern "C" int decode_paged_attention_nsplit(int NB, int ps) {
  return dstorch::split_count(NB, ps);
}

// q [S, H, hd], pages [NP, ps, 2KV, hd], kv_lens [S], page_table [S, NB]
// (int32), out [S, H, hd], workspace float32 [S, H, nsplit, hd + 2] with
// nsplit = decode_paged_attention_nsplit(NB, ps). Launches both passes on
// `stream`, allocates nothing, does not synchronise; returns the first
// cudaError_t (0 on success).
extern "C" int decode_paged_attention_launch(
    const void* q, const void* pages, const void* kv_lens,
    const void* page_table, void* out, void* workspace, int S, int H, int KV,
    int hd, int ps, int NB, float scale, int dtype, void* stream) {
  using namespace dstorch;
  if (S == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || ps <= 0 || NB <= 0)
    return cudaErrorInvalidValue;
  const int nsplit = split_count(NB, ps);
  const int* kvl = static_cast<const int*>(kv_lens);
  const int* pt = static_cast<const int*>(page_table);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && hd == 64)
    return launch<float, 64>(q, pages, kvl, pt, out, ws, S, H, KV, ps, NB,
                             nsplit, scale, st);
  if (dtype == kF32 && hd == 128)
    return launch<float, 128>(q, pages, kvl, pt, out, ws, S, H, KV, ps, NB,
                              nsplit, scale, st);
  if (dtype == kBF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, pages, kvl, pt, out, ws, S, H, KV,
                                     ps, NB, nsplit, scale, st);
  if (dtype == kBF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, pages, kvl, pt, out, ws, S, H, KV,
                                      ps, NB, nsplit, scale, st);
  return cudaErrorInvalidValue;
}
