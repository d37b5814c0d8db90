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
//   once, issues every cp.async of its K rows and then its V rows for its
//   KV head into shared memory before it uses any (16 bytes a copy; 8, 4 or
//   2 where hd * elem or a base pointer is not a multiple of 16), and
//   meanwhile reads its first query rows. Then, for each slice of at most 8
//   of its G query heads in turn (any G, up to MQA), in float32: the
//   scores (one thread a position, each dot product in order over hd; with
//   ALiBi, slope[hq] * k_pos (Bloom) or bf16(slope[hq]) * bf16(k_pos) *
//   scale (Falcon) added to score * scale in one fused multiply-add, as
//   XLA contracts the reference's), the split's max and sum (one
//   warp a query row, a fixed butterfly over the positions), and the
//   unnormalised P.V (one thread a column, positions in order). It writes
//   (acc[hd], m, l) per query head to a float32 workspace [S, H, NSPLIT,
//   hdp + 2], hdp the padded head width.
//   Pass 2, decode_merge_kernel: one warp per (sequence, query head) merges
//   the ceil(kv_lens[s] / kSplit) live splits in split order,
//   m* = max m_i, l* = sum exp(m_i - m*) l_i, out = sum exp(m_i - m*)
//   acc_i / l*, rounded once to the output type; kv_lens == 0 rows write 0.
//
// Head dims: the kernels are built for padded widths 64, 128 and 256 and
// take the true hd (<= 256) at run time; columns hd .. padded width of the
// K/V rows and of the query rows are zero in shared memory, so they add +0
// to every dot product, and only columns below hd are written.
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
constexpr int kMaxG = 8;             // query heads a slice of the group
constexpr int kMergeWarps = 4;

enum AlibiMode : int { kNoAlibi = 0, kBloom = 1, kFalcon = 2 };

// First-pass splits for a page table NB pages wide of ps-row pages.
inline int split_count(int NB, int ps) {
  return (int)(((long long)NB * ps + kSplit - 1) / kSplit);
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

template <typename T, int HDP>
struct SplitSmem {
  static constexpr int kLd = HDP + 16 / (int)sizeof(T);  // padded row
  static constexpr size_t kBytes =
      2 * (size_t)kSplit * kLd * sizeof(T) + (size_t)kMaxG * HDP * 4 +
      (size_t)kMaxG * kSplit * 4;
};

struct DecodeArgs {
  const void* q;
  const void* pages;
  const int* kv_lens;
  const int* page_table;
  const float* slopes;  // [H] float32, or null
  float* ws;
  void* out;
  int H, KV, G, hd, ps, NB, nsplit, vb, alibi;
  float scale;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const DecodeArgs a) {
  using L = SplitSmem<T, HDP>;
  constexpr int LD = L::kLd, VEC = 16 / (int)sizeof(T);
  // P.V: NPART threads share a column's query rows (HDP 64), or a thread
  // owns CPT columns (HDP 256)
  constexpr int NPART = HDP >= kThreads ? 1 : kThreads / HDP;
  constexpr int CPT = HDP >= kThreads ? HDP / kThreads : 1;
  constexpr int COLS = kThreads / NPART;  // columns a pass of the threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kSplit * LD;
  float* Qs = reinterpret_cast<float*>(Vs + kSplit * LD);  // [kMaxG][HDP]
  float* Ps = Qs + kMaxG * HDP;                             // [kMaxG][kSplit]
  __shared__ size_t row_off[kSplit];
  __shared__ float m_s[kMaxG], l_s[kMaxG];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ pages = static_cast<const T*>(a.pages);
  const int s = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int H = a.H, KV = a.KV, G = a.G, hd = a.hd, ps = a.ps, NB = a.NB;
  const int kvl = min(a.kv_lens[s], NB * ps);
  const int base = split * kSplit;
  if (base >= kvl) return;
  const int n = min(kSplit, kvl - base);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ve = a.vb / (int)sizeof(T), units = hd / ve;

  // the split's page ids, once
  if (tid < n) {
    const int pos = base + tid;
    const int pid = a.page_table[(size_t)s * NB + pos / ps];
    row_off[tid] = (((size_t)pid * ps + pos % ps) * (2 * KV) + h) * hd;
  }
  // columns hd .. HDP of the K/V rows are zero
  if (hd < HDP) {
    const int padc = HDP - hd;
    for (int i = tid; i < n * padc; i += kThreads) {
      const int j = i / padc, c = hd + i % padc;
      Ks[j * LD + c] = from_f<T>(0.f);
      Vs[j * LD + c] = from_f<T>(0.f);
    }
  }
  __syncthreads();
  // every K row, then every V row, in flight before the first use
  for (int c = tid; c < n * units; c += kThreads) {
    const int j = c / units, e = (c % units) * ve;
    copy_vb(Ks + j * LD + e, pages + row_off[j] + e, a.vb, true);
  }
  cp_async_commit();
  for (int c = tid; c < n * units; c += kThreads) {
    const int j = c / units, e = (c % units) * ve;
    copy_vb(Vs + j * LD + e, pages + row_off[j] + (size_t)KV * hd + e, a.vb,
            true);
  }
  cp_async_commit();

  const float c_scale = a.scale;
  for (int gb = 0; gb < G; gb += kMaxG) {
    const int GC = min(kMaxG, G - gb);
    if (gb > 0) __syncthreads();  // the last slice is done with Qs and Ps
    const T* qh = q + ((size_t)s * H + (size_t)h * G + gb) * hd;
    for (int i = tid; i < kMaxG * HDP; i += kThreads) {
      const int g = i / HDP, d = i % HDP;
      Qs[i] = g < GC && d < hd ? to_f(qh[(size_t)g * hd + d]) : 0.f;
    }
    if (gb == 0) cp_async_wait<1>();
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
        for (int d = 0; d < hd; d += VEC) {
          float kf[VEC];
          unpack16(*reinterpret_cast<const uint4*>(kr + d), kf);
#pragma unroll
          for (int i = 0; i < kMaxG / 2; ++i) {
            const int g = g0 + 2 * i;
            if (g < GC) {
              const float* qg = Qs + g * HDP + d;
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
        if (g < GC) {
          float x = kNegInf;
          if (j < n) {
            if (a.alibi) {
              x = __fmaf_rn(dot[i], c_scale,
                            alibi_bias(a.alibi, a.slopes[h * G + gb + g],
                                       base + j, c_scale));
            } else {
              x = dot[i] * c_scale;
            }
          }
          Ps[g * kSplit + j] = x;
        }
      }
    }
    __syncthreads();

    // the split's softmax state: warp w owns query rows w and w + 4
    for (int g = warp; g < GC; g += kThreads / 32) {
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
    if (gb == 0) cp_async_wait<0>();
    __syncthreads();

    // unnormalised P.V: thread (d, part) owns columns d (+ COLS) of rows
    // part, part + NPART, ...
    const int d0 = tid % COLS, part = tid / COLS;
    float acc[kMaxG][CPT];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v = to_f(Vs[j * LD + d0 + c * COLS]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < GC && g % NPART == part)
            acc[g][c] = fmaf(Ps[g * kSplit + j], v, acc[g][c]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < GC && g % NPART == part) {
        float* w = a.ws + (((size_t)s * H + (size_t)h * G + gb + g) *
                               a.nsplit + split) * (HDP + 2);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int d = d0 + c * COLS;
          if (d < hd) w[d] = acc[g][c];
        }
        if (d0 == 0) {
          w[HDP] = m_s[g];
          w[HDP + 1] = l_s[g];
        }
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kMergeWarps * 32)
decode_merge_kernel(const DecodeArgs a, int S) {
  constexpr int EPL = HDP / 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;  // s*H + hq
  const int lane = threadIdx.x % 32;
  const int H = a.H, hd = a.hd, nsplit = a.nsplit;
  if (row >= S * H) return;
  const int kvl = a.kv_lens[row / H];
  const int live = min((kvl + kSplit - 1) / kSplit, nsplit);
  T* o = static_cast<T*>(a.out) + (size_t)row * hd;
  if (live <= 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane + 32 * e < hd) o[lane + 32 * e] = from_f<T>(0.f);
    return;
  }
  const float* w = a.ws + (size_t)row * nsplit * (HDP + 2);
  float m = w[HDP];
  for (int i = 1; i < live; ++i) m = fmaxf(m, w[(size_t)i * (HDP + 2) + HDP]);
  float l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int i = 0; i < live; ++i) {
    const float* wi = w + (size_t)i * (HDP + 2);
    const float f = expf(wi[HDP] - m);
    l = fmaf(f, wi[HDP + 1], l);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane + 32 * e < hd) acc[e] = fmaf(f, wi[lane + 32 * e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    if (lane + 32 * e < hd) o[lane + 32 * e] = from_f<T>(acc[e] / l);
}

template <typename T, int HDP>
cudaError_t launch(const DecodeArgs& a, int S, cudaStream_t stream) {
  constexpr size_t smem = SplitSmem<T, HDP>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_split_kernel<T, HDP><<<dim3(S, a.KV, a.nsplit), kThreads, smem,
                                stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = S * a.H;
  decode_merge_kernel<T, HDP><<<(rows + kMergeWarps - 1) / kMergeWarps,
                                kMergeWarps * 32, 0, stream>>>(a, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const DecodeArgs& a, int S, cudaStream_t stream) {
  if (a.hd <= 64) return launch<T, 64>(a, S, stream);
  if (a.hd <= 128) return launch<T, 128>(a, S, stream);
  return launch<T, 256>(a, S, stream);
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
// (int32), out [S, H, hd], workspace float32 [S, H, nsplit, hdp + 2] with
// nsplit = decode_paged_attention_nsplit(NB, ps) and hdp the padded head
// width (64, 128 or 256 for hd <= 256); any G = H / KV. slopes: float32 [H]
// ALiBi slopes, or null with alibi 0 (1: Bloom, 2: Falcon). vb: bytes a
// copy (16, 8, 4; 2 for bf16), dividing hd * elem and both base pointers.
// Launches both passes on `stream`, allocates nothing, does not
// synchronise; returns the first cudaError_t (0 on success).
extern "C" int decode_paged_attention_launch(
    const void* q, const void* pages, const void* kv_lens,
    const void* page_table, const void* slopes, void* out, void* workspace,
    int S, int H, int KV, int hd, int ps, int NB, float scale, int alibi,
    int vb, int dtype, void* stream) {
  using namespace dstorch;
  if (S == 0) return cudaSuccess;
  const int elem = dtype == kF32 ? 4 : 2;
  if (KV <= 0 || H % KV != 0 || ps <= 0 || NB <= 0 || hd <= 0 || hd > 256 ||
      (alibi != kNoAlibi && slopes == nullptr) || vb < elem ||
      (vb != 16 && vb != 8 && vb != 4 && vb != 2) || (hd * elem) % vb)
    return cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.pages = pages;
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.page_table = static_cast<const int*>(page_table);
  a.slopes = static_cast<const float*>(slopes);
  a.ws = static_cast<float*>(workspace);
  a.out = out;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.hd = hd;
  a.ps = ps;
  a.NB = NB;
  a.nsplit = split_count(NB, ps);
  a.vb = vb;
  a.alibi = alibi;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_hd<float>(a, S, st);
  if (dtype == kBF16) return launch_hd<__nv_bfloat16>(a, S, st);
  return cudaErrorInvalidValue;
}
