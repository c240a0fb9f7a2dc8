// Tile arithmetic shared by the flash-attention kernels: the layout,
// masking and tile ranges of all of them, the padded fp32 tiles and row
// reductions of the CUDA-core kernels (whose products stream through
// flash_fp32_ring.cuh's cp.async ring; the bf16 kernels use
// flash_wgmma.cuh).
//
// Layout: q, o, dO are [b, s, n_q, hd] and k, v, dK, dV [b, s, n_kv, hd],
// the model's own layout, so no transpose copy is made; a query head h
// reads KV head h / (n_q / n_kv) (GQA; KV is never repeated in memory).
// Row statistics (lse, delta) are [b, n_q, s] fp32.
//
// The fp32 CUDA-core kernels, for Hopper (sm_90a):
// - tiles of 64 rows (queries or keys), staged in shared memory as fp32
//   and padded by 4 floats a row ([64, HD] tiles and [64, 64] score
//   tiles), so the 16-byte reads of 8 neighbouring lanes from 8
//   different rows hit all 32 banks once; every product accumulates in
//   fp32 on the CUDA cores (no tensor cores: TF32 would round what the
//   reference computes in full fp32);
// - a template on the head dim HD (128 or 256);
// - 256 threads, two warpgroups; each kernel keeps one or two operands
//   resident and streams the others through flash_fp32_ring.cuh's
//   3-stage cp.async ring, one barrier a chunk; a thread owns an 8 x 4
//   score micro-tile and an 8 x 8 or 8 x 16 accumulator micro-tile (the
//   kernels' notes give each one's layout);
// - masked logits take the reference's finite NEG_INF (-2**30): a row
//   whose first visited tile is all masked gets p = 1 there, and the next
//   tile's alpha = exp(NEG_INF - m) = 0 washes it out, as in the Pallas
//   kernels (with -inf that row would give NaN).
#pragma once

#include "paged_attend.cuh"  // kNegInf, kft_error_string

namespace kft_flash {

// A padded fp32 [64, HD] tile is 33.8 KB at 128 and 66.5 KB at 256.
constexpr int kTile = 64;         // query rows and key rows of a tile
constexpr int kThreads = 256;     // two warpgroups
template <int HD>
constexpr int kStride = HD + 4;   // padded fp32 row of a [64, HD] tile
template <int HD>
constexpr int kHdTileFloats = kTile * kStride<HD>;
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

// max / sum over the 16 lanes of a half-warp (a score row group)
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
