// Warp-level tile products shared by the training kernels of the PyTorch
// port (flash attention forward/backward, fused RMSNorm+matmul).
//
// One product shape everywhere: a warp accumulates
//     C[16*MT x 8*NT] += A[16*MT x K] * B[K x 8*NT]
// with both operands in shared memory and C in registers, in the layout of
// the tensor cores' mma.sync.m16n8k16 accumulator. Lane l = 4*g + t holds,
// for m-tile mt and n-tile nt,
//     c[mt][nt][e] = C[16*mt + g + 8*(e >> 1)][8*nt + 2*t + (e & 1)].
// Kernels read rows and columns of their results from that formula, so the
// same kernel body runs on both element types:
//   * bfloat16: mma.sync.m16n8k16 with float32 accumulation;
//   * float32:  the same lane layout computed with FMAs on the CUDA cores
//               (exact float32 products, for the float32 checks).
//
// Operand layouts are flags, so a kernel never stages a transposed copy:
//   AKC: A(r, k) = A[r*lda + k]   (else A[k*lda + r])
//   BKC: B(k, n) = B[n*ldb + k]   (else B[k*ldb + n])
// With the flag set a bfloat16 fragment register is one 32-bit load of two
// neighbouring k; without it, two 16-bit loads packed together. Row strides
// must be even (32-bit alignment of the pairs).
#pragma once

#include "paged_common.cuh"

namespace dstorch {

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Elements (k, k+1) of row r (A) or column r (B) as one bf16x2 register.
template <bool KC>
__device__ __forceinline__ uint32_t frag_pair(const __nv_bfloat16* base,
                                              int ld, int r, int k) {
  if constexpr (KC) {
    return *reinterpret_cast<const uint32_t*>(base + r * ld + k);
  } else {
    return pack_bf16(base[k * ld + r], base[(k + 1) * ld + r]);
  }
}

template <bool KC>
__device__ __forceinline__ float frag_elem(const float* base, int ld, int r,
                                           int k) {
  if constexpr (KC) {
    return base[r * ld + k];
  } else {
    return base[k * ld + r];
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bfloat16 operands: K a multiple of 16.
template <int MT, int NT, bool AKC, bool BKC>
__device__ __forceinline__ void warp_mma(float (&c)[MT][NT][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb,
                                         int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = frag_pair<AKC>(A, lda, 16 * mt + g, kk + 2 * t);
      a[mt][1] = frag_pair<AKC>(A, lda, 16 * mt + g + 8, kk + 2 * t);
      a[mt][2] = frag_pair<AKC>(A, lda, 16 * mt + g, kk + 8 + 2 * t);
      a[mt][3] = frag_pair<AKC>(A, lda, 16 * mt + g + 8, kk + 8 + 2 * t);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t b0 = frag_pair<BKC>(B, ldb, 8 * nt + g, kk + 2 * t);
      const uint32_t b1 = frag_pair<BKC>(B, ldb, 8 * nt + g, kk + 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(c[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0,
                       b1);
      }
    }
  }
}

// float32 operands: the same accumulator layout on the CUDA cores.
template <int MT, int NT, bool AKC, bool BKC>
__device__ __forceinline__ void warp_mma(float (&c)[MT][NT][4],
                                         const float* A, int lda,
                                         const float* B, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a_lo[MT], a_hi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a_lo[mt] = frag_elem<AKC>(A, lda, 16 * mt + g, k);
      a_hi[mt] = frag_elem<AKC>(A, lda, 16 * mt + g + 8, k);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = frag_elem<BKC>(B, ldb, 8 * nt + 2 * t, k);
      const float b1 = frag_elem<BKC>(B, ldb, 8 * nt + 2 * t + 1, k);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        c[mt][nt][0] = fmaf(a_lo[mt], b0, c[mt][nt][0]);
        c[mt][nt][1] = fmaf(a_lo[mt], b1, c[mt][nt][1]);
        c[mt][nt][2] = fmaf(a_hi[mt], b0, c[mt][nt][2]);
        c[mt][nt][3] = fmaf(a_hi[mt], b1, c[mt][nt][3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&c)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
}

// Two neighbouring output elements (columns 2t, 2t+1 of one row).
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Copy ROWS rows of COLS elements (a row starts every src_stride elements)
// into shared memory rows of stride ld, 16 bytes per thread and step; rows
// at or past n_valid are written as zeros. COLS*sizeof(T), ld*sizeof(T) and
// src_stride*sizeof(T) must be multiples of 16, src 16-byte aligned.
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t src_stride, int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// Shared-memory row padding: 16 bytes, which keeps rows 16-byte aligned and
// spreads the fragment loads of neighbouring rows over the banks.
template <typename T>
constexpr int kPad = 16 / sizeof(T);

}  // namespace dstorch
