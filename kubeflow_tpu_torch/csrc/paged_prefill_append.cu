// Paged prefill-append attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/prefill_append.py::paged_prefill_append (its
// `_kernel`): each row appends q_lens[row] new K/V cells at cell
// q_start[row] through its block table, IN PLACE in the pool, and all s
// queries of the row attend causally over prefix + new cells.
//
// Two launches on one stream:
// 1. scatter: writes only the valid new cells t < q_lens[row] to
//    (table[row, (q_start+t) / bs], (q_start+t) % bs). A row with
//    q_lens == 0 writes nothing. The TPU kernel rewrites every visited
//    block whole (a constraint of how Pallas flushes output buffers,
//    prefill_append.py:25-32); nothing like it holds here. The reference
//    scatter (ops/attention.py, plain path) routes padding tokens to
//    trash block 0; this kernel writes nothing there, so pools compare
//    with block 0 excluded. Cells at or past the window end
//    (nb * bs) are never written; q_start + q_lens <= nb * bs is the
//    caller's precondition (the engine checks it on the host).
// 2. attention: one CUDA block per (query tile, kv head, row); a tile
//    is kRows consecutive (token, group member) query rows. It reads the
//    pool AFTER the scatter, so it attends what the pool holds, in the
//    pool's dtype, as the reference does (prefill_append.py:114-121).
//    Write disjointness between rows (the serving engine's invariant,
//    see serving/paged.py) makes launch 1's writes race-free.
//
// Bound on this card: device-memory bytes at serving shapes (a 64-token
// chunk over a few hundred cells): q, the new K/V (read once, written
// once) and each row's live K/V cells, against ~4 flops per (query
// head, visible cell, hd element) in fp32 on the CUDA cores. A tile's
// loop stops at its own last query's cell, so early tiles read less.
// Each K/V cell is re-read once per query tile: s * group / kRows tiles
// per (row, kv head). Tensor-core (wgmma) tiles are later work.
#include "paged_attend.cuh"

namespace {

constexpr int kRows = kft::kMaxRows;  // query rows per attention block

template <typename T>
__global__ void __launch_bounds__(kft::kThreads)
scatter_kernel(const T* __restrict__ k_new,  // [b, s, n_kv, hd]
               const T* __restrict__ v_new,
               T* __restrict__ k_pool,        // [nblk, bs, n_kv, hd]
               T* __restrict__ v_pool,
               const int* __restrict__ table,    // [b, nb]
               const int* __restrict__ q_start,  // [b]
               const int* __restrict__ q_lens,   // [b]
               int s, int nb, int bs, int row_elems) {
  const int t = blockIdx.x;
  const int row = blockIdx.y;
  if (t >= q_lens[row]) return;
  const int p = q_start[row] + t;
  if (p >= nb * bs) return;
  const size_t phys = (size_t)table[(size_t)row * nb + p / bs];
  const size_t dst = (phys * bs + p % bs) * row_elems;
  const size_t src = ((size_t)row * s + t) * row_elems;
  constexpr int kVec = 16 / sizeof(T);
  const int n_vec = row_elems / kVec;
  for (int i = threadIdx.x; i < n_vec; i += kft::kThreads) {
    reinterpret_cast<uint4*>(k_pool + dst)[i] =
        reinterpret_cast<const uint4*>(k_new + src)[i];
    reinterpret_cast<uint4*>(v_pool + dst)[i] =
        reinterpret_cast<const uint4*>(v_new + src)[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kft::kThreads)
prefill_attention_kernel(const T* __restrict__ q,       // [b, s, n_q, hd]
                         const T* __restrict__ k_pool,  // [nblk, bs, n_kv, hd]
                         const T* __restrict__ v_pool,
                         const int* __restrict__ table,    // [b, nb]
                         const int* __restrict__ q_start,  // [b]
                         const unsigned char* __restrict__ mask,  // [b, nb*bs]
                         T* __restrict__ out,              // [b, s, n_q, hd]
                         int s, int nb, int bs, int n_kv, int group,
                         int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int row = blockIdx.z;
  const int R = min(kRows, s * group - r0);
  const int n_q = n_kv * group;
  kft::Smem<T, HD> sm(smem_raw, R);
  const int start = q_start[row];
  // tile row r is query (token t, group member g) with r0 + r = t*group + g
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads) {
    const int f = r0 + i / HD;
    const int t = f / group;
    const int head = h * group + f % group;
    sm.q[i] = kft::to_f(q[(((size_t)row * s + t) * n_q + head) * HD + i % HD]);
  }
  for (int r = threadIdx.x; r < R; r += kft::kThreads)
    sm.qpos[r] = start + (r0 + r) / group;
  const kft::PagedAddr addr{table + (size_t)row * nb, bs, n_kv, h};
  kft::attend<T, HD>(sm, R, k_pool, v_pool, addr,
                     mask ? mask + (size_t)row * nb * bs : nullptr, nb * bs,
                     window, scale, start + r0 / group,
                     start + (r0 + R - 1) / group);
  for (int i = threadIdx.x; i < R * HD; i += kft::kThreads) {
    const int f = r0 + i / HD;
    const int t = f / group;
    const int head = h * group + f % group;
    const float l = sm.l[i / HD];
    out[(((size_t)row * s + t) * n_q + head) * HD + i % HD] =
        kft::from_f<T>(sm.acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const void* table, const void* q_start,
           const void* q_lens, const void* mask, void* out, int b, int s,
           int nb, int bs, int n_kv, int group, int window, float scale,
           cudaStream_t stream) {
  scatter_kernel<T><<<dim3(s, b), kft::kThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(q_start),
      static_cast<const int*>(q_lens), s, nb, bs, n_kv * HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = kft::Smem<T, HD>::bytes(kRows);
  err = kft::set_smem_once<T, HD>(prefill_attention_kernel<T, HD>);
  if (err != cudaSuccess) return err;
  const int tiles = (s * group + kRows - 1) / kRows;
  prefill_attention_kernel<T, HD>
      <<<dim3(tiles, n_kv, b), kft::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), static_cast<const int*>(table),
          static_cast<const int*>(q_start),
          static_cast<const unsigned char*>(mask), static_cast<T*>(out), s,
          nb, bs, n_kv, group, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-1b; other
// head dims come with a model that needs them). window <= 0 means none.
// mask may be null (every cell valid). Returns cudaGetLastError() after
// the launches.
extern "C" int kft_paged_prefill_append(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* table, const void* q_start, const void* q_lens,
    const void* mask, void* out, int b, int s, int nb, int bs, int n_kv,
    int group, int hd, int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 128) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128>(q, k_new, v_new, k_pool, v_pool, table, q_start,
                              q_lens, mask, out, b, s, nb, bs, n_kv, group,
                              window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k_new, v_new, k_pool, v_pool, table,
                                      q_start, q_lens, mask, out, b, s, nb, bs,
                                      n_kv, group, window, scale, st);
  return cudaErrorInvalidValue;
}
