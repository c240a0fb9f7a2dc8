// Split-KV (flash-decoding) attention of one query token per row, shared
// by the paged decode kernel (paged_decode_attention.cu, cells reached
// through a block table) and the dense decode kernel (decode_attention.cu,
// cells of a [b, max_len, n_kv, hd] cache). Two launches, one call:
//
// - Split: one CUDA block per (kv head, row, split of `split_cells`
//   cells); the kv head's GQA group forms the rows of the tile. Block z
//   walks only [z split_cells, (z + 1) split_cells) intersected with the
//   row's live range [window lo, cursor] (`attend` with an explicit
//   range, paged_attend.cuh) and writes its partial row max m,
//   denominator l and unnormalised accumulator in fp32 to scratch.
// - Pad-split skip: before any K/V copy a block reads the kv_mask bytes
//   of its share of the live range (at most split_cells bytes, one per
//   thread). A block whose cells are all hidden (the left-pad run of a
//   window batch, a blanked range) writes l = 0 and exits, as a block
//   with an empty range does; l == 0 weighs 0 in the combine, so the
//   result is the same function. The Pallas kernels read those pad
//   blocks and mask them after the load.
// - Combine: one block per (query head, row), one thread per hd element
//   (128 or 256 threads; nothing in it depends on the count), merges
//   the splits by their m, divides by the merged l and rounds once to
//   the output dtype. A row whose splits all have l == 0 sees no cell
//   and is written as 0, the Pallas kernels' convention.
// - Head dims 128 (llama) and 256 (gemma) are instantiated. At 256 a
//   bf16 K/V row is 512 bytes, so `attend`'s chunk is 32 cells
//   (paged_attend.cuh's Tile) and a block's shared memory is ~85 KB at
//   gemma-2b's group of 8 (~102 KB at kMaxRows), above the 48 KB
//   default: set_smem_once raises the cap per instantiation.
//
// The split count, ceil(width / split_cells), follows from the shapes
// alone, and the skip reads its mask on the device: no host read of the
// cursors, no synchronisation, and the pair of launches can be captured
// in a CUDA graph. How a cell's K/V row is found is the `Cells` template
// argument.
#pragma once

#include "paged_attend.cuh"

namespace kft {

// A paged pool [num_blocks, bs, n_kv, hd] through per-row tables [b, nb].
struct PagedCells {
  using Addr = PagedAddr;
  const int* table;
  int nb, bs;
  __device__ __forceinline__ PagedAddr at(int row, int n_kv, int h) const {
    return PagedAddr{table + (size_t)row * nb, bs, n_kv, h};
  }
  __host__ __device__ __forceinline__ int width() const { return nb * bs; }
};
// A dense cache [b, max_len, n_kv, hd].
struct DenseCells {
  using Addr = DenseAddr;
  int max_len;
  __device__ __forceinline__ DenseAddr at(int row, int n_kv, int h) const {
    return DenseAddr{(size_t)row * max_len, n_kv, h};
  }
  __host__ __device__ __forceinline__ int width() const { return max_len; }
};

template <typename T, int HD, typename Cells>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q,  // [b, n_q, hd]
                    const T* __restrict__ k,  // pool or cache
                    const T* __restrict__ v,
                    const Cells cells,
                    const int* __restrict__ pos,             // [b]
                    const unsigned char* __restrict__ mask,  // [b, width]
                    float* __restrict__ part,  // [b, n_q, n_split, hd]
                    float* __restrict__ ml,    // [b, n_q, n_split, 2]
                    int n_kv, int group, int window, float scale,
                    int split_cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int R = group;
  const int n_q = n_kv * group;
  const int width = cells.width();
  const int p = pos[row];
  const int c_lo = z * split_cells;
  const int c_hi = c_lo + split_cells;  // exclusive
  int lo = max(c_lo, window > 0 ? max(p - window + 1, 0) : 0);
  int hi = min(c_hi - 1, min(p, width - 1));
  // opaque to the optimizer, as in `attend`: nvcc's front end otherwise
  // spends minutes on nested min / max feeding a loop bound
  asm volatile("" : "+r"(lo), "+r"(hi));
  const unsigned char* mask_row =
      mask ? mask + (size_t)row * width : nullptr;
  // partial (row, query head h * group + r, split z) at part_row + r n_split
  const size_t part_row = ((size_t)row * n_q + (size_t)h * group) * n_split + z;
  bool blank = lo > hi;  // nothing of the live range in this split
  if (!blank && mask_row != nullptr) {
    int seen = 0;
    for (int c = lo + threadIdx.x; c <= hi; c += kThreads) seen |= mask_row[c];
    blank = !__syncthreads_or(seen);
  }
  if (blank) {
    for (int r = threadIdx.x; r < R; r += kThreads) {
      ml[(part_row + (size_t)r * n_split) * 2] = kNegInf;
      ml[(part_row + (size_t)r * n_split) * 2 + 1] = 0.f;
    }
    return;
  }
  Smem<T, HD> sm(smem_raw, R);
  const T* q_row = q + ((size_t)row * n_q + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < R * HD; i += kThreads) sm.q[i] = to_f(q_row[i]);
  for (int r = threadIdx.x; r < R; r += kThreads) sm.qpos[r] = p;
  // attend synchronises before reading sm.q / sm.qpos, and after its last
  // chunk
  attend<T, HD, typename Cells::Addr, true>(
      sm, R, k, v, cells.at(row, n_kv, h), mask_row, width, window, scale, p,
      p, c_lo, c_hi);
  for (int i = threadIdx.x; i < R * HD; i += kThreads)
    part[(part_row + (size_t)(i / HD) * n_split) * HD + i % HD] = sm.acc[i];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    ml[(part_row + (size_t)r * n_split) * 2] = sm.m[r];
    ml[(part_row + (size_t)r * n_split) * 2 + 1] = sm.l[r];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ ml,
                      T* __restrict__ out,  // [b, n_q, hd]
                      int n_q, int n_split) {
  const int hq = blockIdx.x;
  const int row = blockIdx.y;
  const int d = threadIdx.x;
  const size_t base = (size_t)row * n_q + hq;
  const float* m_l = ml + base * n_split * 2;
  float m = -INFINITY;
  for (int z = 0; z < n_split; ++z)
    if (m_l[2 * z + 1] > 0.f) m = fmaxf(m, m_l[2 * z]);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float lz = m_l[2 * z + 1];
    if (lz > 0.f) {
      const float w = expf(m_l[2 * z] - m);
      l += w * lz;
      acc += w * part[(base * n_split + z) * HD + d];
    }
  }
  out[base * HD + d] = from_f<T>(l > 0.f ? acc / l : 0.f);
}

// The arguments both C entry points accept: hd 128 (llama) or 256
// (gemma), a GQA group of at most kMaxRows, split_cells a positive
// multiple of 64.
inline bool decode_split_args_ok(int hd, int group, int split_cells) {
  return (hd == 128 || hd == 256) && group >= 1 && group <= kMaxRows &&
         split_cells >= 64 && split_cells % 64 == 0;
}

// Both launches on `stream`. scratch: fp32 room for b x n_q x n_split x
// (hd + 2) values, n_split = ceil(width / split_cells).
template <typename T, int HD, typename Cells>
cudaError_t launch_decode_split(const void* q, const void* k, const void* v,
                                Cells cells, const void* pos,
                                const void* mask, void* out, void* scratch,
                                int b, int n_kv, int group, int window,
                                float scale, int split_cells,
                                cudaStream_t stream) {
  const int n_q = n_kv * group;
  const int n_split = (cells.width() + split_cells - 1) / split_cells;
  float* part = static_cast<float*>(scratch);
  float* ml = part + (size_t)b * n_q * n_split * HD;
  cudaError_t err =
      set_smem_once<T, HD>(decode_split_kernel<T, HD, Cells>);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, HD, Cells>
      <<<dim3(n_kv, b, n_split), kThreads, Smem<T, HD>::bytes(group),
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), cells,
                   static_cast<const int*>(pos),
                   static_cast<const unsigned char*>(mask), part, ml, n_kv,
                   group, window, scale, split_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<dim3(n_q, b), HD, 0, stream>>>(
      part, ml, static_cast<T*>(out), n_q, n_split);
  return cudaGetLastError();
}

}  // namespace kft
