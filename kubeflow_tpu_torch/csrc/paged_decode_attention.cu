// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/paged_attention.py::paged_decode_attention
// (its `_kernel`): one query token per row attends that row's cells in
// the paged KV pool [num_blocks, bs, n_kv, hd], reached through the
// row's block table. GQA stays at KV resolution. Visible cells: causal
// against the row's cursor (cell index == token position, the pool's
// compaction invariant), kv_mask, and an optional sliding window.
//
// Bound on this card: device-memory bytes. Per layer and step it must
// read the live cells' K and V, live_cells x n_kv x hd x 2 (K,V) x 2 B,
// against ~4 flops per (query head, cell, hd element): far below the
// ~295 flops/byte at which the H100's bf16 tensor cores would bind. At
// the serving shape (8 rows, cursors 16 .. 1023, 3,751 live cells) that
// is 15.4 MB, 4.6 us at 3.35 TB/s.
//
// Design: split-KV (flash-decoding), two launches.
// - Split: one CUDA block per (kv head, row, split of `split_cells`
//   cells); the kv head's GQA group (2 query heads at llama3-1b) forms the
//   rows of the tile. Block z walks only [z split_cells, (z + 1)
//   split_cells) intersected with the row's live range [window lo,
//   cursor] (the loop in paged_attend.cuh, 64 cells a chunk, the next
//   chunk's cp.async copy overlapping this one's arithmetic) and writes
//   its partial row max m, denominator l and unnormalised accumulator in
//   fp32 to scratch. A block whose intersection is empty writes l = 0 and
//   exits: it reads no K/V and no table entry, so the table's trash tail
//   past the cursor's block stays unread. The split count, ceil(nb bs /
//   split_cells), follows from the shapes alone: no host read of the
//   cursors, no synchronisation, and the pair of launches can be captured
//   in a CUDA graph.
// - Combine: one block per (query head, row), one thread per hd element,
//   merges the splits by their m (a split with l == 0 weighs 0), divides
//   by the merged l and rounds once to the output dtype. A row whose
//   splits all have l == 0 sees no cell and is written as 0, the Pallas
//   kernel's convention.
// The first kernel walked a row's whole live range in one block per (kv
// head, row): 64 blocks at batch 8 on 132 SMs, the 1024-cell row setting
// the pace 16 chunks deep. Splitting puts the bytes of every live chunk
// in flight on more SMs at once. Scores and P.V stay on the CUDA cores: at
// a GQA group of 2 a 64-row wgmma tile would be ~97% idle, and bytes, not
// operations, bind this kernel.
#include "paged_attend.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kft::kThreads)
paged_decode_split_kernel(const T* __restrict__ q,       // [b, n_q, hd]
                          const T* __restrict__ k_pool,  // [nblk, bs, n_kv, hd]
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,  // [b, nb]
                          const int* __restrict__ pos,    // [b]
                          const unsigned char* __restrict__ mask,  // [b, nb*bs]
                          float* __restrict__ part,  // [b, n_q, n_split, hd]
                          float* __restrict__ ml,    // [b, n_q, n_split, 2]
                          int nb, int bs, int n_kv, int group, int window,
                          float scale, int split_cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int R = group;
  const int n_q = n_kv * group;
  const int width = nb * bs;
  const int p = pos[row];
  const int c_lo = z * split_cells;
  const int c_hi = c_lo + split_cells;  // exclusive
  const int live_lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int live_hi = min(p, width - 1);
  // partial (row, query head h * group + r, split z) at part_row + r n_split
  const size_t part_row = ((size_t)row * n_q + (size_t)h * group) * n_split + z;
  if (max(c_lo, live_lo) > min(c_hi - 1, live_hi)) {  // nothing to see
    for (int r = threadIdx.x; r < R; r += kft::kThreads) {
      ml[(part_row + (size_t)r * n_split) * 2] = kft::kNegInf;
      ml[(part_row + (size_t)r * n_split) * 2 + 1] = 0.f;
    }
    return;
  }
  kft::Smem<T, HD> sm(smem_raw, R);
  const T* q_row = q + ((size_t)row * n_q + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads)
    sm.q[i] = kft::to_f(q_row[i]);
  for (int r = threadIdx.x; r < R; r += kft::kThreads) sm.qpos[r] = p;
  // attend synchronises before reading sm.q / sm.qpos, and after its last
  // chunk
  const kft::PagedAddr addr{table + (size_t)row * nb, bs, n_kv, h};
  kft::attend<T, HD, kft::PagedAddr, true>(
      sm, R, k_pool, v_pool, addr, mask ? mask + (size_t)row * width : nullptr,
      width, window, scale, p, p, c_lo, c_hi);
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads)
    part[(part_row + (size_t)(i / HD) * n_split) * HD + i % HD] = sm.acc[i];
  for (int r = threadIdx.x; r < R; r += kft::kThreads) {
    ml[(part_row + (size_t)r * n_split) * 2] = sm.m[r];
    ml[(part_row + (size_t)r * n_split) * 2 + 1] = sm.l[r];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_combine_kernel(const float* __restrict__ part,
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
  out[base * HD + d] = kft::from_f<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* pos, const void* mask, void* out,
           void* scratch, int b, int nb, int bs, int n_kv, int group,
           int window, float scale, int split_cells, cudaStream_t stream) {
  const int n_q = n_kv * group;
  const int n_split = (nb * bs + split_cells - 1) / split_cells;
  float* part = static_cast<float*>(scratch);
  float* ml = part + (size_t)b * n_q * n_split * HD;
  const size_t smem = kft::Smem<T, HD>::bytes(group);
  cudaError_t err =
      kft::set_smem_once<T, HD>(paged_decode_split_kernel<T, HD>);
  if (err != cudaSuccess) return err;
  paged_decode_split_kernel<T, HD>
      <<<dim3(n_kv, b, n_split), kft::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), static_cast<const int*>(table),
          static_cast<const int*>(pos),
          static_cast<const unsigned char*>(mask), part, ml, nb, bs, n_kv,
          group, window, scale, split_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, HD><<<dim3(n_q, b), HD, 0, stream>>>(
      part, ml, static_cast<T*>(out), n_q, n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-1b; other
// head dims come with a model that needs them). window <= 0 means none.
// mask may be null (every cell valid). split_cells: cells per block of
// the split launch, a positive multiple of 64. scratch: fp32 room for
// b x n_q x n_split x (hd + 2) values, n_split = ceil(nb bs /
// split_cells). Returns cudaGetLastError() after the launches.
extern "C" int kft_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, const void* mask, void* out, void* scratch, int b,
    int nb, int bs, int n_kv, int group, int hd, int window, float scale,
    int split_cells, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 128 || group < 1 || group > kft::kMaxRows || split_cells < 64 ||
      split_cells % 64)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128>(q, k_pool, v_pool, table, pos, mask, out,
                              scratch, b, nb, bs, n_kv, group, window, scale,
                              split_cells, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, table, pos, mask,
                                      out, scratch, b, nb, bs, n_kv, group,
                                      window, scale, split_cells, s);
  return cudaErrorInvalidValue;
}
