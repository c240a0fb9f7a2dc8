// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/decode_attention.py::decode_attention (its
// `_kernel`): one query token per row attends that row's cells of a dense
// KV cache [b, max_len, n_kv, hd] (the one-shot engine's cache, and the
// speculative draft's). GQA stays at KV resolution. A cell is visible iff
// idx <= the row's cursor, kv_mask[row, idx] (the engine's left-pad
// holes), and, with a window, cursor - idx < window. fp32 logits scaled by
// hd**-0.5, fp32 online softmax; a row with no visible cell is written as
// 0, as the Pallas kernel does.
//
// Bound on this card: device-memory bytes. Per layer and step it must
// read each row's visible cells' K and V, n_kv x hd x 2 (K, V) x 2 B a
// cell in bf16, against ~4 flops per (query head, visible cell, hd
// element): far below the ~295 flops/byte at which the H100's bf16 tensor
// cores would bind.
//
// Design: split-KV, the paged decode kernel's split and combine launches
// (decode_split.cuh) with cells addressed in the dense cache
// (`DenseCells`). Block (kv head, row, split z) walks only the split's
// share of the row's live range [max(0, cursor - window + 1), cursor];
// the split count, ceil(max_len / split_cells), follows from the shapes,
// so no host read of the cursor. The pad-split skip matters here: a
// window batch left-pads every prompt to its bucket, so most of a row's
// live range can be pad (the kv_mask hides it); a split that the mask
// hides entirely reads no K/V. What held the first kernel (one block per
// (kv head, row) walking the whole live range) back: 64 blocks at batch
// 8 (8 at the draft's batch 1) on 132 SMs, each walking its row's chunks
// in series, pad chunks loaded and then masked. Scores and P.V stay on
// the CUDA cores: the GQA group is 4 at llama3-8b and 2 at the draft, so
// a 64-row wgmma tile would be 94-97% idle, and bytes bind this kernel.
#include "decode_split.cuh"

namespace {

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* mask, void* out, void* scratch, int b, int max_len,
           int n_kv, int group, int window, float scale, int split_cells,
           cudaStream_t stream) {
  return kft::launch_decode_split<T, HD>(
      q, k, v, kft::DenseCells{max_len}, pos, mask, out, scratch, b, n_kv,
      group, window, scale, split_cells, stream);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* pos, const void* mask, void* out, void* scratch,
              int b, int max_len, int n_kv, int group, int window,
              float scale, int split_cells, cudaStream_t stream) {
  if (hd == 256)
    return launch<T, 256>(q, k, v, pos, mask, out, scratch, b, max_len, n_kv,
                          group, window, scale, split_cells, stream);
  return launch<T, 128>(q, k, v, pos, mask, out, scratch, b, max_len, n_kv,
                        group, window, scale, split_cells, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-8b and
// llama3-1b) or 256 (gemma-2b). group <= kft::kMaxRows. window <= 0
// means none. mask may be null (every cell valid). split_cells: cells
// per block of the split launch, a positive multiple of 64. scratch: fp32
// room for b x n_q x n_split x (hd + 2) values, n_split = ceil(max_len /
// split_cells). Returns cudaGetLastError() after the launches.
extern "C" int kft_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* mask, void* out,
                                    void* scratch, int b, int max_len,
                                    int n_kv, int group, int hd, int window,
                                    float scale, int split_cells, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!kft::decode_split_args_ok(hd, group, split_cells))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, pos, mask, out, scratch, b,
                            max_len, n_kv, group, window, scale, split_cells,
                            s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, pos, mask, out, scratch, b,
                                    max_len, n_kv, group, window, scale,
                                    split_cells, s);
  return cudaErrorInvalidValue;
}
