// The chunk ring of the fp32 CUDA-core flash kernels
// (flash_attention_fwd.cu, flash_attention_dq.cu, flash_attention_dkv.cu).
//
// Each kernel keeps one pair of [64, HD] fp32 tiles resident in shared
// memory (forward: Q of its 128 query rows; dQ: Q and dO; dK/dV: K and
// V) and streams the other operands through a ring of kRingStages stages
// of 18 KB. Every thread issues its 16-byte cp.async copies for the
// chunk kRingStages - 1 ahead right after the barrier that frees its
// stage, so device memory and L2 traffic overlap the products; one
// barrier a chunk both publishes the landed chunk and frees the stage the
// next copy fills. A chunk's products are 1024 fp32 FMAs a thread in the
// backward kernels and 2048 in the forward (two warpgroups of 64 query
// rows sharing each chunk), so a barrier comes once in about 2000 to
// 4000 cycles of issue.
//
// Why chunks and not whole tiles: at head dim 256 a padded [64, 256]
// fp32 tile is 66.5 KB, and the four operands of a step (K, V, Q, dO)
// would need 266 KB against the 227 KB a block may have. So the
// streamed operands arrive twice a step: for the score products (S =
// Q K^T and dP = dO V^T reduce over the head dim) as [64, 32] column
// chunks at a padded row of 36 floats, two to a stage; for the products
// that reduce over the tile's rows (O += P V, dQ += dS K, dV += P^T dO,
// dK += dS^T Q) as chunks of whole rows (padded to HD + 4), so that
// every thread's accumulator takes part in every chunk. The second pass
// reads from L2.
//
// Shared memory delivers 128 bytes a cycle to an SM's registers, 32
// floats, against 128 fp32 FMAs, so a thread's micro-tile of m x n
// outputs (m n FMAs for m + n loaded floats a step of the reduction)
// needs m n >= 4 (m + n) to leave the FMAs the limit: 8 x 4 (2.7 a
// float) for the 64 x 64 score products, one warpgroup each; 8 x 8 or
// 8 x 16 (4 and 5.3) for the products that write head-dim columns (8 x
// 4 for dQ at head dim 128). An 8 x 8 score tile, each warpgroup's
// halves summing 16 of a chunk's 32 columns and adding through shared
// memory, ran slower on an H100 (more live registers, one block of 8
// warps an SM to hide the loads' latency).
#pragma once

#include "flash_tile.cuh"
#include "flash_wgmma.cuh"  // cp.async helpers

namespace kft_flash {

constexpr int kChunk = 32;                 // head-dim columns of a chunk
constexpr int kCStride = kChunk + 4;       // padded row of a [64, 32] chunk
constexpr int kStageFloats = 2 * kTile * kCStride;  // two column chunks
constexpr int kRingStages = 3;
// whole rows of a [64, HD] tile in a stage: 4096 / HD (16 at 256, 32 at
// 128) padded rows take 4160 or 4224 of its 4608 floats
template <int HD>
constexpr int kStageRows = 4096 / HD;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Start copying ROWS rows x W columns of one head into a padded shared
// tile at `dst` (`dst_stride` floats a row). `src` points at the first
// row's first column; rows are `row_stride` elements apart; rows at or
// past `rows_valid` (>= 1) are zero-filled. W / 4 16-byte copies a row,
// spread over the block's threads.
template <int ROWS, int W>
__device__ __forceinline__ void load_async(float* dst, int dst_stride,
                                           const float* __restrict__ src,
                                           size_t row_stride,
                                           int rows_valid) {
  constexpr int kPerRow = W / 4;
  static_assert(ROWS * kPerRow % kThreads == 0, "copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * kPerRow / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / kPerRow, e = (i % kPerRow) * 4;
    const bool ok = r < rows_valid;
    kft_wgmma::cp_async16(kft_wgmma::smem_u32(dst + r * dst_stride + e),
                          src + (ok ? r * row_stride + e : 0), ok ? 16 : 0);
  }
}

// Does the tile pair (query tile at q0, key tile at k0) need masking: it
// meets the diagonal, the window's edge or the sequence's end.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int s, int causal,
                                          int window) {
  return q0 + kTile > s || k0 + kTile > s ||
         (causal && (k0 + kTile - 1 > q0 ||
                     (window > 0 && q0 + kTile - 1 - k0 >= window)));
}

// The ring over `total` chunks. `issue(J, stage)` starts chunk J's
// copies into `stage`; `next()` returns the stage holding the next chunk
// once every thread's copies of it have landed. All threads call
// `next()` the same number of times (it holds a barrier).
template <typename Issue>
struct ChunkRing {
  float* base;
  int total;
  const Issue& issue;
  int j = 0;

  __device__ __forceinline__ float* stage(int n) const {
    return base + (n % kRingStages) * kStageFloats;
  }
  // Copies of the first kRingStages - 1 chunks; the caller's own copies
  // issued before (the resident tiles) join the first group.
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int n = 0; n < kRingStages - 1; ++n) {
      if (n < total) issue(n, stage(n));
      kft_wgmma::cp_async_commit();
    }
  }
  __device__ __forceinline__ const float* next() {
    kft_wgmma::cp_async_wait<kRingStages - 2>();  // chunk j landed here
    __syncthreads();  // ... for every thread; chunk j - 1 is consumed
    const int ahead = j + kRingStages - 1;  // into chunk j - 1's stage
    if (ahead < total) issue(ahead, stage(ahead));
    kft_wgmma::cp_async_commit();  // an empty group past the end
    return stage(j++);
  }
};

}  // namespace kft_flash
