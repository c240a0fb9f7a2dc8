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
// Grid: one CUDA block per (kv head, row); the kv head's GQA group (4
// query heads at llama3-8b, 2 at llama3-1b) forms the rows of the tile.
// The TPU kernel's sequential block axis, with blocks past the cursor and
// older than the window skipped by clamped index maps, becomes the loop
// in paged_attend.cuh (`attend` with `DenseAddr`), which visits only the
// cells [max(0, cursor - window + 1), cursor], rounded out to whole
// 64-cell chunks at the low end and masked at the high end, so any
// max_len works and no cell past the cursor is ever read.
//
// Bound on this card: device-memory bytes. Per layer and step it must
// read each row's live cells' K and V, live x n_kv x hd x 2 (K, V) x 2 B
// in bf16, against ~4 flops per (query head, visible cell, hd element):
// far below the ~295 flops/byte at which the H100's bf16 tensor cores
// would bind. The design reads each live K/V row once per (row, kv head)
// and nothing of the dead tail, so traffic follows the cache fill, not
// max_len. Known limit: the grid is b x n_kv blocks (64 at batch 8, 8 at
// the speculative draft's batch 1) on 132 SMs; splitting the cell range
// across blocks (flash-decoding) is the next step for this kernel.
#include "paged_attend.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kft::kThreads)
decode_kernel(const T* __restrict__ q,     // [b, n_q, hd]
              const T* __restrict__ k,     // [b, max_len, n_kv, hd]
              const T* __restrict__ v,
              const int* __restrict__ pos,  // [b]
              const unsigned char* __restrict__ mask,  // [b, max_len]
              T* __restrict__ out,          // [b, n_q, hd]
              int max_len, int n_kv, int group, int window, float scale) {
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
  // attend synchronises before reading sm.q / sm.qpos
  const kft::DenseAddr addr{(size_t)row * max_len, n_kv, h};
  kft::attend<T, HD>(sm, R, k, v, addr,
                     mask ? mask + (size_t)row * max_len : nullptr, max_len,
                     window, scale, p, p);
  T* o_row = out + ((size_t)row * n_q + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads) {
    const float l = sm.l[i / HD];
    o_row[i] = kft::from_f<T>(sm.acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* mask, void* out, int b, int max_len, int n_kv,
           int group, int window, float scale, cudaStream_t stream) {
  const size_t smem = kft::Smem<T, HD>::bytes(group);
  cudaError_t err = kft::set_smem_once<T, HD>(decode_kernel<T, HD>);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD><<<dim3(n_kv, b), kft::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), max_len,
      n_kv, group, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-8b and
// llama3-1b; other head dims come with a model that needs them). group
// <= kft::kMaxRows. window <= 0 means none. mask may be null (every cell
// valid). Returns cudaGetLastError() after the launch.
extern "C" int kft_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* mask, void* out, int b,
                                    int max_len, int n_kv, int group, int hd,
                                    int window, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 128 || group < 1 || group > kft::kMaxRows)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128>(q, k, v, pos, mask, out, b, max_len, n_kv,
                              group, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, pos, mask, out, b, max_len,
                                      n_kv, group, window, scale, s);
  return cudaErrorInvalidValue;
}
