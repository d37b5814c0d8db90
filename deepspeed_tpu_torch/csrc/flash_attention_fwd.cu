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
// float32. Element type float32 or bfloat16, hd in {64, 128}.
//
// Design. The TPU grid walks kv blocks in order for each query block and
// carries the softmax state in VMEM. Here one CUDA block of 4 warps owns 64
// query rows of one (batch, head) and walks the kv tiles of 64 positions
// itself, so the state lives in registers: each warp owns 16 query rows,
// and a lane owns 2 of them (mma accumulator layout, tile_mma.cuh). Per kv
// tile: stage K and V in shared memory, S = Q.K^T on the tensor cores
// (bfloat16 inputs, float32 sums; exact float32 FMAs for float32 inputs),
// mask and update the online softmax in registers, write P to shared memory
// in the input type, and O += P.V. Causal blocks stop at the diagonal tile
// (the reference's _causal_kv_index skip). Rows and keys past S are zero in
// shared memory and masked, so no padded copy of the inputs is made.
//
// Numerics against the reference (float32 throughout): with bfloat16 inputs
// P is rounded to bfloat16 for the P.V product (as FlashAttention-2 does),
// a relative error <= 2^-9 per term; the softmax statistics, the sums and
// the LSE stay float32. float32 inputs use float32 everywhere.
//
// Bound on this card: operations, 4*hd flops per visible (query, key) pair
// and head, against 989 TFLOP/s dense bfloat16. What the simple design
// leaves on the table: mma.sync instead of wgmma, no TMA or cp.async
// pipelining of the next tile, 32-bit fragment loads instead of ldmatrix.
#include "tile_mma.cuh"

namespace dstorch {
namespace {

constexpr int kBQ = 64;      // query rows per block (4 warps x 16)
constexpr int kBK = 64;      // keys per tile
constexpr int kThreads = 128;

template <typename T, int HD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * (3 * kBQ * (HD + kPad<T>) + kBQ * (kBK + kPad<T>));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, float scale,
                 int causal) {
  constexpr int LD = HD + kPad<T>;
  constexpr int LDP = kBK + kPad<T>;
  constexpr int NT_S = kBK / 8;   // n-tiles of a score tile
  constexpr int NT_O = HD / 8;    // n-tiles of an output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  T* Ps = Vs + kBK * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * HD;
  const int q0 = iq * kBQ;

  load_tile<T, kBQ, HD, kThreads>(Qs, LD, q + base + q0 * row_stride,
                                  row_stride, S - q0);

  float acc[1][NT_O][4];
  zero_acc(acc);
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;          // rows row_lo, row_lo + 8

  const int nk = (S + kBK - 1) / kBK;
  const int n_tiles = causal ? min(nk, iq + 1) : nk;   // kBQ == kBK
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kBK;
    __syncthreads();                               // previous tile consumed
    load_tile<T, kBK, HD, kThreads>(Ks, LD, k + base + j0 * row_stride,
                                    row_stride, S - j0);
    load_tile<T, kBK, HD, kThreads>(Vs, LD, v + base + j0 * row_stride,
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
    warp_mma<1, NT_O, true, false>(acc, Pw, LDP, Vs, LD, kBK);
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, scale, causal);
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
  if (dtype == kBF16) {
    if (hd == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, l, B, S, H, scale, causal,
                                        st);
    if (hd == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, l, B, S, H, scale, causal,
                                       st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch<float, 128>(q, k, v, o, l, B, S, H, scale, causal, st);
    if (hd == 64)
      return launch<float, 64>(q, k, v, o, l, B, S, H, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
