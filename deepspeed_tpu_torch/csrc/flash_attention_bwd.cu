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
// {64, 128}.
//
// Design. As in the forward, a CUDA block of 4 warps owns 64 rows of one
// (batch, head) and walks the other side's tiles of 64 itself, so nothing
// carries across blocks and no atomics are needed:
//   * dQ: a block owns 64 query rows and walks the kv tiles up to the
//     diagonal (the reference's dq grid with its causal kv skip);
//   * dK/dV: a block owns 64 key rows and walks the query tiles from the
//     first one that sees them (the reference's _causal_q_index), computing
//     the transposed tiles S^T = K.Q^T and dP^T = V.dO^T directly so that
//     each warp's accumulator rows are its own key rows.
// Products run on the tensor cores for bfloat16 (float32 sums) and as exact
// float32 FMAs for float32 inputs (tile_mma.cuh). With bfloat16 inputs, P
// and dS are rounded to bfloat16 for the dQ, dK and dV products (as
// FlashAttention-2 does): a relative error <= 2^-9 per term. P, dS and the
// row statistics are float32 until then.
//
// Bound on this card: operations; per visible (query, key) pair and head,
// dQ does 6*hd flops (three products, the recomputed scores included:
// Q.K^T, dO.V^T, dS.K) and dK/dV 8*hd (Q.K^T, dO.V^T, P^T.dO, dS^T.Q),
// against 989 TFLOP/s dense bfloat16. Left on the table: wgmma, TMA and
// pipelined tile loads, one fused dQ+dK/dV pass with atomics for dQ.
#include "tile_mma.cuh"

namespace dstorch {
namespace {

constexpr int kB = 64;       // rows per block and per walked tile
constexpr int kThreads = 128;

template <typename T, int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (4 * kB * (HD + kPad<T>) + kB * (kB + kPad<T>));
}

template <typename T, int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(T) * (4 * kB * (HD + kPad<T>) + 2 * kB * (kB + kPad<T>)) +
         sizeof(float) * 2 * kB;
}

// --------------------------------------------------------------------- //
// dQ
// --------------------------------------------------------------------- //
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, float scale, int causal) {
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

// --------------------------------------------------------------------- //
// dK, dV
// --------------------------------------------------------------------- //
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, float scale,
                     int causal) {
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
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, float scale, int causal,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, HD>;
  const size_t smem = dq_smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kB - 1) / kB, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int H, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  const size_t smem = dkv_smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kB - 1) / kB, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale, causal);
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
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, d, dq, B, S, H,
                                           scale, causal, st);
    if (hd == 64)
      return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, d, dq, B, S, H,
                                          scale, causal, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_dq<float, 128>(q, k, v, dout, l, d, dq, B, S, H, scale,
                                   causal, st);
    if (hd == 64)
      return launch_dq<float, 64>(q, k, v, dout, l, d, dq, B, S, H, scale,
                                  causal, st);
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
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, d, dk, dv, B, S,
                                            H, scale, causal, st);
    if (hd == 64)
      return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, d, dk, dv, B, S,
                                           H, scale, causal, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_dkv<float, 128>(q, k, v, dout, l, d, dk, dv, B, S, H,
                                    scale, causal, st);
    if (hd == 64)
      return launch_dkv<float, 64>(q, k, v, dout, l, d, dk, dv, B, S, H,
                                   scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
