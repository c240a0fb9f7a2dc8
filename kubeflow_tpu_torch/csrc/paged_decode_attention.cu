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
// Design: split-KV (flash-decoding), two launches (decode_split.cuh,
// shared with the dense decode kernel): a split launch, one CUDA block per
// (kv head, row, split of `split_cells` cells), the kv head's GQA group
// (2 query heads at llama3-1b) forming the rows of the tile; a block
// whose share of the live range is empty, or hidden entirely by the
// kv_mask, writes l = 0 and exits, so the table's trash tail past the
// cursor's block stays unread. A combine launch merges the splits by
// their m. The split count, ceil(nb bs / split_cells), follows from the
// shapes alone, so the pair can be captured in a CUDA graph.
// The first kernel walked a row's whole live range in one block per (kv
// head, row): 64 blocks at batch 8 on 132 SMs, the 1024-cell row setting
// the pace 16 chunks deep. Splitting puts the bytes of every live chunk
// in flight on more SMs at once. Scores and P.V stay on the CUDA cores: at
// a GQA group of 2 a 64-row wgmma tile would be ~97% idle, and bytes, not
// operations, bind this kernel.
//
// gemma-2b (hd 256, one kv head for 8 query heads): the grid is (1, b,
// n_split), and a block's work per cell is 8 rows x 256 against llama3-1b's
// 2 x 128, while its bytes per cell are a quarter (one kv head). At 128-cell
// splits only 33 blocks of the ragged batch see a cell, each walking up to
// 4 chunks of 32 cells; the wrapper's default for such wide rows is 64
// (ops/cuda/paged_attention.py, default_split_cells), which doubles the
// blocks in flight and halves each block's serial chain.
#include "decode_split.cuh"

namespace {

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* pos, const void* mask, void* out,
           void* scratch, int b, int nb, int bs, int n_kv, int group,
           int window, float scale, int split_cells, cudaStream_t stream) {
  return kft::launch_decode_split<T, HD>(
      q, k_pool, v_pool, kft::PagedCells{static_cast<const int*>(table), nb, bs},
      pos, mask, out, scratch, b, n_kv, group, window, scale, split_cells,
      stream);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k_pool, const void* v_pool,
              const void* table, const void* pos, const void* mask,
              void* out, void* scratch, int b, int nb, int bs, int n_kv,
              int group, int window, float scale, int split_cells,
              cudaStream_t stream) {
  if (hd == 256)
    return launch<T, 256>(q, k_pool, v_pool, table, pos, mask, out, scratch,
                          b, nb, bs, n_kv, group, window, scale, split_cells,
                          stream);
  return launch<T, 128>(q, k_pool, v_pool, table, pos, mask, out, scratch, b,
                        nb, bs, n_kv, group, window, scale, split_cells,
                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama) or 256
// (gemma). window <= 0 means none.
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
  if (!kft::decode_split_args_ok(hd, group, split_cells))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pool, v_pool, table, pos, mask, out,
                            scratch, b, nb, bs, n_kv, group, window, scale,
                            split_cells, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, table, pos, mask,
                                    out, scratch, b, nb, bs, n_kv, group,
                                    window, scale, split_cells, s);
  return cudaErrorInvalidValue;
}
