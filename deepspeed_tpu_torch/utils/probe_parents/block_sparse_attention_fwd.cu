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
// float32 or bfloat16, hd in {64, 128}, block in {16, 32, 64, 128}. The
// block layout arrives as a CSR list of active blocks: row r = lh*nq + iq
// of layout head lh (0 when the heads share one layout, else the head)
// holds the k-blocks cols[row_ptr[r] .. row_ptr[r + 1]).
//
// Design. The TPU walks a dense (B, H, nq, nk) grid and skips the DMA of
// masked steps through a fetch table. Here one CUDA block owns TILE query
// rows of one (batch, head) and q-block (TILE = min(block, 64): a 128-row
// block is two CUDA blocks) and walks only its row's list of active
// blocks, each in chunks of TILE keys, so a masked block costs nothing.
// Each warp owns 16 query rows and a lane 2 of them (tile_mma.cuh's
// accumulator layout); per chunk: stage K and V in shared memory, S =
// Q.K^T on the tensor cores (bfloat16 inputs, float32 sums; exact float32
// FMAs for float32 inputs), mask and update the online softmax in
// registers, write P to shared memory in the input type, O += P.V. With
// bfloat16 inputs P is rounded to bfloat16 for P.V (relative error <=
// 2^-9 per term), as flash_attention_fwd.cu does; the statistics and sums
// stay float32.
//
// Bound on this card: operations, 4*hd flops per (query, key) pair of an
// active block and head, against 989 TFLOP/s dense bfloat16. Left on the
// table, as in flash_attention_fwd.cu: wgmma, TMA or cp.async pipelining
// of the next chunk, ldmatrix fragment loads.
#include "tile_mma.cuh"

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

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const void* row_ptr, const void* cols, int B, int S,
             int H, int hd, int LH, int nq, int blk, float scale, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cl = static_cast<const int*>(cols);
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  if (dtype == kBF16) {
    if (hd == 128)
      return launch_tile<__nv_bfloat16, 128>(q, k, v, o, lse, rp, cl, B, S, H,
                                             LH, nq, blk, scale, st);
    if (hd == 64)
      return launch_tile<__nv_bfloat16, 64>(q, k, v, o, lse, rp, cl, B, S, H,
                                            LH, nq, blk, scale, st);
  } else if (dtype == kF32) {
    if (hd == 128)
      return launch_tile<float, 128>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq,
                                     blk, scale, st);
    if (hd == 64)
      return launch_tile<float, 64>(q, k, v, o, lse, rp, cl, B, S, H, LH, nq,
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
