// Tile arithmetic shared by the flash-attention kernels: the layout,
// masking and tile ranges of all of them, the padded fp32 tiles of the
// CUDA-core kernels, and the fp32 forward's products (the fp32 backward
// kernels stream through flash_fp32_ring.cuh; the bf16 kernels use
// flash_wgmma.cuh).
//
// Layout: q, o, dO are [b, s, n_q, hd] and k, v, dK, dV [b, s, n_kv, hd],
// the model's own layout, so no transpose copy is made; a query head h
// reads KV head h / (n_q / n_kv) (GQA; KV is never repeated in memory).
// Row statistics (lse, delta) are [b, n_q, s] fp32.
//
// Design of the fp32 forward's tiles, for Hopper (sm_90a), simple first:
// - tiles of 64 query rows x 64 key rows, staged in shared memory as
//   fp32; every product accumulates in fp32 on the CUDA cores. No tensor
//   cores, no TMA, no pipelining;
// - a template on the head dim HD (128 or 256): a [64, HD] tile is
//   HD / 64 column parts of 64;
// - 256 threads as 16 x 16: thread (ty, tx) owns score rows ty + 16 i and
//   score columns tx + 16 j (i, j < 4), and for a [64, HD] accumulator the
//   rows ty + 16 i and head-dim columns 64 part + tx*4 + {0..3} of every
//   part (HD / 16 columns a row: acc[4][HD / 16]);
// - [64, HD] tiles are padded by 4 floats a row, so the 16-byte reads of
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

#include "paged_attend.cuh"  // kNegInf, kft_error_string

namespace kft_flash {

// A padded fp32 [64, HD] tile is 33.8 KB at 128 and 66.5 KB at 256. At
// 256 the forward keeps three such tiles (Q, K, V) and a score tile (217
// KB of the 227 KB a block may have, one block an SM); the backward
// kernels keep two and stream the rest (flash_fp32_ring.cuh).
constexpr int kTile = 64;         // query rows and key rows of a tile
constexpr int kThreads = 256;     // 16 x 16
template <int HD>
constexpr int kStride = HD + 4;   // padded fp32 row of a [64, HD] tile
template <int HD>
constexpr int kHdTileFloats = kTile * kStride<HD>;
template <int HD>
constexpr int kParts = HD / 64;   // 64-column parts of a row
constexpr int kPStride = kTile + 4;  // padded row of a [64, 64] tile
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

// Load 64 rows of one head into a padded fp32 tile. `src` points at the
// tile's first row of that head; consecutive rows are `row_stride`
// elements apart. Rows at or past `rows_valid` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          size_t row_stride, int rows_valid) {
  constexpr int kPerRow = HD / 4;  // 16-byte loads a row
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int e = (i % kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * kStride<HD> + e) =
        r < rows_valid
            ? *reinterpret_cast<const float4*>(src + r * row_stride + e)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded
// [64, HD] tiles.
template <int HD>
__device__ __forceinline__ void dot_tile(const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kStride<HD>
                                              + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kStride<HD>
                                              + d);
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
// P and a padded [64, HD] V; col(c) = 64 (c / 4) + tx*4 + c % 4.
template <int HD>
__device__ __forceinline__ void pv_tile(const float* __restrict__ P,
                                        const float* __restrict__ V, int ty,
                                        int tx, float acc[4][HD / 16]) {
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPStride + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float* vr = V + (r + rr) * kStride<HD> + tx * 4;
#pragma unroll
      for (int part = 0; part < kParts<HD>; ++part) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + part * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = rr == 0 ? p[i].x : rr == 1 ? p[i].y
                         : rr == 2 ? p[i].z : p[i].w;
          const int c = part * 4;
          acc[i][c] = fmaf(pv, v4.x, acc[i][c]);
          acc[i][c + 1] = fmaf(pv, v4.y, acc[i][c + 1]);
          acc[i][c + 2] = fmaf(pv, v4.z, acc[i][c + 2]);
          acc[i][c + 3] = fmaf(pv, v4.w, acc[i][c + 3]);
        }
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

// Write a thread's [4][HD / 16] accumulator rows (times `mul`) to a
// [.., s, heads, HD] tensor. `dst` points at the tile's first row of the
// head; rows at or past `rows_valid` are not written.
template <int HD>
__device__ __forceinline__ void store_acc(float* __restrict__ dst,
                                          size_t row_stride, int rows_valid,
                                          int ty, int tx,
                                          const float acc[4][HD / 16],
                                          const float mul[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_valid) continue;
    float* row = dst + r * row_stride;
#pragma unroll
    for (int part = 0; part < kParts<HD>; ++part) {
      float* out = row + part * 64 + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = acc[i][part * 4 + c] * mul[i];
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
