// Tile arithmetic shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_dq.cu, flash_attention_dkv.cu).
//
// Layout: q, o, dO are [b, s, n_q, hd] and k, v, dK, dV [b, s, n_kv, hd],
// the model's own layout, so no transpose copy is made; a query head h
// reads KV head h / (n_q / n_kv) (GQA; KV is never repeated in memory).
// Row statistics (lse, delta) are [b, n_q, s] fp32.
//
// Design, for Hopper (sm_90a), simple-and-correct first:
// - tiles of 64 query rows x 64 key rows, staged in shared memory as fp32
//   (converted once on load); every product accumulates in fp32 on the
//   CUDA cores. No tensor cores (mma/wgmma), no TMA, no pipelining yet;
// - 256 threads as 16 x 16: thread (ty, tx) owns score rows ty + 16 i and
//   score columns tx + 16 j (i, j < 4), and for a [64, hd] accumulator the
//   rows ty + 16 i and head-dim columns tx*4 + {0..3}, 64 + tx*4 + {0..3};
// - [64, hd] tiles are padded by 4 floats a row, so the 16-byte reads of
//   8 neighbouring lanes from 8 different rows hit all 32 banks once, and
//   the 16 lanes of a row read the other operand's same address
//   (broadcast); [64, 64] score tiles likewise;
// - row reductions (softmax max and sum) are shuffles inside the 16 lanes
//   that share a row;
// - masked logits take the reference's finite NEG_INF (-2**30): a row
//   whose first visited tile is all masked gets p = 1 there, and the next
//   tile's alpha = exp(NEG_INF - m) = 0 washes it out, as in the Pallas
//   kernels (with -inf that row would give NaN).
#pragma once

#include "paged_attend.cuh"  // to_f / from_f / bf16 unpacking, kft_error_string

namespace kft_flash {

constexpr int kHD = 128;          // head dim (llama3-1b)
constexpr int kTile = 64;         // query rows and key rows of a tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kStride = kHD + 4;  // padded fp32 row of a [64, hd] tile
constexpr int kPStride = kTile + 4;  // padded row of a [64, 64] tile
constexpr int kHdTileFloats = kTile * kStride;
constexpr int kPTileFloats = kTile * kPStride;
constexpr float kNegInf = kft::kNegInf;

// Is key kp visible to query qp? Both must lie inside the sequence.
__device__ __forceinline__ bool visible(int qp, int kp, int s, int causal,
                                        int window) {
  if (qp >= s || kp >= s) return false;
  if (!causal) return true;
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// Key tiles a causal query tile at q0 must visit: above the diagonal and
// (with a window) wholly older than the band are skipped (the
// reference's _block_relevant). Non-causal visits all nk tiles.
__device__ __forceinline__ void key_tiles(int q0, int nk, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = nk - 1;
  if (!causal) return;
  *hi = min(nk - 1, q0 / kTile);
  if (window > 0) *lo = max(0, q0 - window + 1) / kTile;
}

// Query tiles that see the key tile at k0 (the transpose of key_tiles).
__device__ __forceinline__ void query_tiles(int k0, int nq, int causal,
                                            int window, int* lo, int* hi) {
  *lo = 0;
  *hi = nq - 1;
  if (!causal) return;
  *lo = k0 / kTile;
  if (window > 0) *hi = min(nq - 1, (k0 + kTile - 1 + window - 1) / kTile);
}

__device__ __forceinline__ void store16(float* d, uint4 raw, float) {
  *reinterpret_cast<float4*>(d) = make_float4(
      __uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
      __uint_as_float(raw.w));
}
__device__ __forceinline__ void store16(float* d, uint4 raw, __nv_bfloat16) {
  const float2 a = kft::bf2_bits_to_f2(raw.x), b = kft::bf2_bits_to_f2(raw.y);
  const float2 c = kft::bf2_bits_to_f2(raw.z), e = kft::bf2_bits_to_f2(raw.w);
  *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(d + 4) = make_float4(c.x, c.y, e.x, e.y);
}

// Load 64 rows of one head into a padded fp32 tile. `src` points at the
// tile's first row of that head; consecutive rows are `row_stride`
// elements apart. Rows at or past `rows_valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          size_t row_stride, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = kHD / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int e = (i % kPerRow) * kVec;
    float* d = dst + r * kStride + e;
    if (r < rows_valid) {
      store16(d, *reinterpret_cast<const uint4*>(src + r * row_stride + e),
              T());
    } else {
#pragma unroll
      for (int x = 0; x < kVec; x += 4)
        *reinterpret_cast<float4*>(d + x) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Load 64 per-row fp32 statistics (lse or delta) starting at `src`; rows
// at or past `rows_valid` are zero.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int rows_valid) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r < rows_valid ? src[r] : 0.f;
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded
// [64, hd] tiles.
__device__ __forceinline__ void dot_tile(const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kHD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        acc[i][j] = t;
      }
  }
}

// acc[i][c] += sum_r P[ty + 16 i][r] * V[r][col(c)] for a padded [64, 64]
// P and a padded [64, hd] V; col(c) = tx*4 + c for c < 4, 64 + tx*4 +
// (c - 4) otherwise.
__device__ __forceinline__ void pv_tile(const float* __restrict__ P,
                                        const float* __restrict__ V, int ty,
                                        int tx, float acc[4][8]) {
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPStride + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float* vr = V + (r + rr) * kStride + tx * 4;
      const float4 v0 = *reinterpret_cast<const float4*>(vr);
      const float4 v1 = *reinterpret_cast<const float4*>(vr + 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = rr == 0 ? p[i].x : rr == 1 ? p[i].y
                       : rr == 2 ? p[i].z : p[i].w;
        acc[i][0] = fmaf(pv, v0.x, acc[i][0]);
        acc[i][1] = fmaf(pv, v0.y, acc[i][1]);
        acc[i][2] = fmaf(pv, v0.z, acc[i][2]);
        acc[i][3] = fmaf(pv, v0.w, acc[i][3]);
        acc[i][4] = fmaf(pv, v1.x, acc[i][4]);
        acc[i][5] = fmaf(pv, v1.y, acc[i][5]);
        acc[i][6] = fmaf(pv, v1.z, acc[i][6]);
        acc[i][7] = fmaf(pv, v1.w, acc[i][7]);
      }
    }
  }
}

// Write thread-owned [4][4] score values into a padded [64, 64] tile.
__device__ __forceinline__ void store_scores(float* __restrict__ P, int ty,
                                             int tx, const float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) P[(ty + 16 * i) * kPStride + tx + 16 * j] = v[i][j];
}

// Write a thread's [4][8] accumulator rows (times `mul`) to a [.., s,
// heads, hd] tensor. `dst` points at the tile's first row of the head;
// rows at or past `rows_valid` are not written.
template <typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          size_t row_stride, int rows_valid,
                                          int ty, int tx, const float acc[4][8],
                                          const float mul[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_valid) continue;
    T* row = dst + r * row_stride;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      T* out = row + half * 64 + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] = kft::from_f<T>(acc[i][half * 4 + c] * mul[i]);
    }
  }
}

// max / sum over the 16 lanes that share a score row
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace kft_flash
