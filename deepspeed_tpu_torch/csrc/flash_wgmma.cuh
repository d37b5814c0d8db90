// The pieces the bfloat16 flash-attention kernels for Hopper share
// (flash_attention_fwd.cu, flash_attention_bwd.cu): a CTA owns kOwn rows of
// one (batch, head), two consumer warpgroups of 64, and walks the other
// side in tiles loaded by TMA from the [B, S, H*hd] layout as it is
// (64-column boxes, 128-byte swizzle; rows past S arrive as zeros). The
// block-sparse kernels (block_sparse_attention_fwd.cu, _bwd.cu) use the
// raster, the products and the stores too.
#pragma once

#include "hopper_async.cuh"
#include "tile_mma.cuh"

namespace dstorch {
namespace wg {

constexpr int kOwn = 128;                 // rows a CTA owns
constexpr int kGroups = 2;                // consumer warpgroups, 64 rows each
constexpr int kHeadGroup = 16;            // (batch, head) pairs a raster group
constexpr int kBoxCols = 64;              // a TMA box row: 128 bytes

// The CTA's (rank, batch*H + head): (batch, head) pairs in raster groups
// of kHeadGroup, each group's CTAs in rank order across its pairs.
__device__ __forceinline__ void raster(int BH, int ranks, int& rank,
                                       int& bh) {
  const int per_group = kHeadGroup * ranks;
  const int first = (blockIdx.x / per_group) * kHeadGroup;
  const int gsize = min(BH - first, kHeadGroup);
  const int r = blockIdx.x % per_group;
  rank = r / gsize;
  bh = first + r % gsize;
}

// The warpgroups' turns at the tensor cores: warpgroup g issues a batch of
// wgmma after wait() and lets the other go with pass(), so one computes its
// probabilities while the other's products run (named barriers 1 and 2,
// one per warpgroup; warpgroup 1 passes first, once, before its first turn).
struct Turns {
  int g;
  __device__ __forceinline__ void wait() const {
    named_bar_sync(1 + g, kGroups * 128);
  }
  __device__ __forceinline__ void pass() const {
    named_bar_arrive(2 - g, kGroups * 128);
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit: relative error ~2^-22, subnormal
// results flushed to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Issues acc += A.B over a walked tile of WALK rows: A a [64 x WALK] tile
// as bf16 fragments (k16 slice j in a[j]), B the walked tile [WALK x HD]
// read with HD contiguous (64-column boxes of WALK rows, WALK * 128 bytes
// apart; 8-row groups 1024 apart).
template <int HD, int WALK>
__device__ __forceinline__ void walk_product(float (&acc)[HD / 2],
                                             const uint32_t (&a)[WALK / 16][4],
                                             uint32_t b) {
#pragma unroll
  for (int j = 0; j < WALK / 16; ++j) {
    const uint64_t desc = wgmma_desc_sw128(b + j * 16 * 128, WALK * 128, 1024);
    if constexpr (HD == 128) {
      wgmma_m64n128k16_rs(acc, a[j], desc);
    } else {
      wgmma_m64n64k16_rs(acc, a[j], desc);
    }
  }
}

constexpr int kBox64 = 64 * 128;          // bytes of a [64 x 64] box

// Issues S = A0.B0^T and dP = A1.B1^T for one warpgroup, both [64 x 64],
// as one wgmma group: A0, A1 its 64 owned rows (boxes `a_box` bytes
// apart), B0, B1 a walked tile's 64 rows (boxes of kBox64 bytes); all
// K-major over hd. The flash-attention backward and the block-sparse
// dK/dV kernel (block_sparse_attention_bwd.cu) issue their scores so.
template <int HD>
__device__ __forceinline__ void score_products(float (&s)[32],
                                               float (&dp)[32], uint32_t a0,
                                               uint32_t a1, uint32_t b0,
                                               uint32_t b1, uint32_t a_box) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ao = (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t bo = (kk / 4) * kBox64 + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, wgmma_desc_kmajor(a0 + ao),
                       wgmma_desc_kmajor(b0 + bo), kk);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ao = (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t bo = (kk / 4) * kBox64 + (kk % 4) * 32;
    wgmma_m64n64k16_ss(dp, wgmma_desc_kmajor(a1 + ao),
                       wgmma_desc_kmajor(b1 + bo), kk);
  }
  wgmma_commit();
}

// Rows row_lo and row_lo + 8 of a warp's [16 x HD] accumulator slice,
// rounded once to bfloat16; rows at or past S are not written.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[HD / 2],
                                           int row_lo, int S, int H, int b,
                                           int h) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* o = out + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      store_pair(o + 8 * j + 2 * t, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Columns [8*J0, 8*J1) of rows row_lo and row_lo + 8 of a warp's [16 x HD]
// accumulator slice in a [B*H, S, HD] output (the block-sparse layout),
// rounded once to bfloat16; rows at or past S are not written.
template <int HD, int J0 = 0, int J1 = HD / 8>
__device__ __forceinline__ void store_bhsd(__nv_bfloat16* out,
                                           const float (&acc)[HD / 2],
                                           int row_lo, int S, int bh) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* o = out + ((size_t)bh * S + row) * HD;
#pragma unroll
    for (int j = J0; j < J1; ++j) {
      store_pair(o + 8 * j + 2 * t, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

}  // namespace wg

// Tensor maps of a [B, S, H*hd] bfloat16 tensor with boxes of `rows` x 64.
inline bool encode_rows(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                        int B, int S, int H, int hd, int rows) {
  return encode_bf16_3d(enc, map, ptr, B, S, (uint64_t)H * hd, rows,
                        wg::kBoxCols, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The flat [B*H*S] row offsets and the grid are int: refuse what overflows.
inline bool fits(int B, int S, int H) {
  return (long long)B * H * S < (1ll << 31);
}

}  // namespace dstorch
