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
// type float32 or bfloat16, hd in {64, 128}, block in {16, 32, 64, 128};
// the layout as CSR lists of active blocks, row lh*nq + iq of the layout
// for dQ and row lh*nk + jk of the transposed layout for dK/dV.
//
// Design. As in the forward, a CUDA block owns TILE = min(block, 64) rows
// of one (batch, head) and walks its own list, in chunks of TILE, so
// nothing carries across CUDA blocks and no atomics are needed:
//   * dQ: a CUDA block owns TILE query rows of a q-block and walks the
//     k-blocks of its layout row;
//   * dK/dV: a CUDA block owns TILE key rows of a k-block and walks the
//     q-blocks of its transposed-layout row, computing the transposed tiles
//     S^T = K.Q^T and dP^T = V.dO^T directly, so that each warp's
//     accumulator rows are its own key rows.
// Products run on the tensor cores for bfloat16 (float32 sums) and as
// exact float32 FMAs for float32 inputs (tile_mma.cuh). With bfloat16
// inputs P and dS are rounded to bfloat16 for the dQ, dK and dV products
// (relative error <= 2^-9 per term), as flash_attention_bwd.cu does.
//
// Bound on this card: operations; per (query, key) pair of an active block
// and head, dQ does 6*hd flops (Q.K^T, dO.V^T, dS.K) and dK/dV 8*hd (Q.K^T,
// dO.V^T, P^T.dO, dS^T.Q), against 989 TFLOP/s dense bfloat16.
#include "tile_mma.cuh"

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

template <typename T, int HD, bool DKV>
cudaError_t launch_tile(const Args& a, cudaStream_t st) {
  switch (a.blk) {
    case 16:
      return launch<T, HD, 16, DKV>(a, st);
    case 32:
      return launch<T, HD, 32, DKV>(a, st);
    case 64:
    case 128:
      return launch<T, HD, 64, DKV>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <bool DKV>
int dispatch(const Args& a, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.S <= 0 || a.B <= 0 || a.H <= 0) return 0;
  if (dtype == kBF16) {
    if (hd == 128) return launch_tile<__nv_bfloat16, 128, DKV>(a, st);
    if (hd == 64) return launch_tile<__nv_bfloat16, 64, DKV>(a, st);
  } else if (dtype == kF32) {
    if (hd == 128) return launch_tile<float, 128, DKV>(a, st);
    if (hd == 64) return launch_tile<float, 64, DKV>(a, st);
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
