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
// Grid: one CUDA block per (kv head, row); the kv head's GQA group (2
// query heads at llama3-1b) forms the rows of the tile. The TPU's
// sequential block axis becomes the loop in paged_attend.cuh, which
// reads only [window lo, cursor] of the row's cells.
//
// Bound on this card: device-memory bytes. Per layer and step it must
// read the live cells' K and V, live_cells x n_kv x hd x 2 (K,V) x 2 B,
// against ~4 flops per (query head, cell, hd element): far below the
// ~295 flops/byte at which the H100's bf16 tensor cores would bind. The
// design reads each live K/V row exactly once per (row, kv head) and
// nothing of the dead tail. Known limit: at batch 8 the grid is 64
// blocks, under the card's 132 SMs, so a split over the cell range
// (flash-decoding) is the next step for this kernel.
#include "paged_attend.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kft::kThreads)
paged_decode_kernel(const T* __restrict__ q,         // [b, n_q, hd]
                    const T* __restrict__ k_pool,    // [nblk, bs, n_kv, hd]
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,   // [b, nb]
                    const int* __restrict__ pos,     // [b]
                    const unsigned char* __restrict__ mask,  // [b, nb*bs]
                    T* __restrict__ out,             // [b, n_q, hd]
                    int nb, int bs, int n_kv, int group, int window,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int R = group;
  const int n_q = n_kv * group;
  kft::Smem<T, HD> sm(smem_raw, R);
  const int p = pos[row];
  const T* q_row = q + ((size_t)row * n_q + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads)
    sm.q[i] = kft::to_f(q_row[i]);
  for (int r = threadIdx.x; r < R; r += kft::kThreads) sm.qpos[r] = p;
  // paged_attend synchronises before reading sm.q / sm.qpos
  kft::paged_attend<T, HD>(sm, R, k_pool, v_pool, table + (size_t)row * nb,
                           mask ? mask + (size_t)row * nb * bs : nullptr, nb,
                           bs, n_kv, h, window, scale, p, p);
  T* o_row = out + ((size_t)row * n_q + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads) {
    const float l = sm.l[i / HD];
    o_row[i] = kft::from_f<T>(sm.acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* pos, const void* mask, void* out,
           int b, int nb, int bs, int n_kv, int group, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = kft::Smem<T, HD>::bytes(group);
  cudaError_t err = kft::set_smem_once<T, HD>(paged_decode_kernel<T, HD>);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, HD><<<dim3(n_kv, b), kft::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const unsigned char*>(mask),
      static_cast<T*>(out), nb, bs, n_kv, group, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-1b; other
// head dims come with a model that needs them). window <= 0 means none.
// mask may be null (every cell valid). Returns cudaGetLastError() after
// the launch.
extern "C" int kft_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, const void* mask, void* out, int b, int nb, int bs,
    int n_kv, int group, int hd, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 128) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128>(q, k_pool, v_pool, table, pos, mask, out, b, nb,
                              bs, n_kv, group, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, table, pos, mask,
                                      out, b, nb, bs, n_kv, group, window,
                                      scale, s);
  return cudaErrorInvalidValue;
}
