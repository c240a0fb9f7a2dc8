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
// 2. attention: it reads the pool AFTER the scatter, so it attends what
//    the pool holds, in the pool's dtype, as the reference does
//    (prefill_append.py:114-121). Write disjointness between rows (the
//    serving engine's invariant, see serving/paged.py) makes launch 1's
//    writes race-free. A tile's loop starts at the window's first chunk
//    and stops at the cell of its last valid query (t < q_lens), so early
//    tiles read less and padding tokens add no cells.
//
// Bound on this card: device-memory bytes at serving shapes (a 64-token
// chunk over a few hundred cells): q, the new K/V (read once, written
// once) and each row's live K/V cells, against 4 flops per (query head,
// visible cell, hd element).
//
// bf16 (the serving path), on the tensor cores: one warpgroup per (64
// query rows, kv head, row); tile row r is (token, group member)
// ((r0 + r) / group, (r0 + r) % group), so at the path's shape (s 64,
// group 2) a kv head's 128 query rows are 2 tiles and each K/V chunk is
// read once per 64 query rows. Q sits in shared memory as a swizzled bf16
// tile (flash_wgmma.cuh), its rows gathered from q [b, s, n_q, hd]; 64-cell
// K/V chunks come through a 2-stage cp.async ring, each cell's row found
// through the block table (a chunk may span blocks when bs < 64). S = Q K^T
// is 8 wgmma k-steps (m64n64k16); causal, window and kv_mask are applied to
// the fp32 fragment in registers (-inf, so exp gives exactly 0, and a row
// that sees no cell keeps l == 0 and is written as 0, the Pallas kernel's
// convention); P is rounded to bf16 in registers as the A operand of
// O += P V (4 k-steps of m64n128k16, V read MN-major). What held the first
// kernel (kept for fp32, below) back: 16 query rows a block, so each K/V
// cell was re-read once per 16 rows, and scores and P.V in fp32 on the CUDA
// cores with a barrier between each step.
//
// Head dim 256 (gemma-2b: one kv head for 8 query heads) keeps the
// [64, 128] swizzled tile as the unit, so flash_wgmma.cuh's descriptors
// serve unchanged: a 256-wide row of Q, K or V is two tiles, one per
// 128-column half. S = Q K^T chains 16 k-steps (8 per half) into one
// [64, 64] accumulator; O += P V is two m64n128 RS products sharing one
// bf16 P fragment, into two fp32 accumulators (128 registers a thread).
// Shared memory is Q 32 KB + 2 stages x (K, V) 64 KB = 161 KB with the
// alignment slack, so one block an SM (launch bounds 1 instead of 2). At
// group 8 a 64-row tile is 8 tokens, so a 64-token slice is 8 tiles per
// kv head, each reading the K/V chunks up to its last token's cell.
//
// The scatter stays its own launch (about 2 us): fusing it would let the
// attention blocks read the slice's own cells from k_new / v_new instead
// of the pool.
//
// fp32: one CUDA block per (16 query rows, kv head, row) over
// paged_attend.cuh's `attend` (fp32 tiles, CUDA cores).
#include "flash_wgmma.cuh"
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

namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

constexpr int kTcStages = 2;  // K/V ring

// Geometry of the tensor-core kernel at head dim HD (128 or 256): a
// 64-row operand is an Operand<HD>, HD / 128 swizzled [64, 128] tiles
// (flash_wgmma.cuh), one per 128-column part of the head dim. Shared
// memory: Q, then kTcStages x (K, V); 1 KB of slack for the 1024-byte
// alignment. 81 KB at 128 (two blocks an SM), 161 KB at 256 (one).
template <int HD>
struct TcGeom {
  static constexpr int kParts = wg::Operand<HD>::kParts;
  static constexpr uint32_t kOperandBytes = wg::Operand<HD>::kBytes;
  static constexpr size_t kSmemBytes =
      1024 + (size_t)kOperandBytes * (1 + 2 * kTcStages);
  static constexpr int kMinBlocks = HD == 128 ? 2 : 1;
};

template <int HD>
__global__ void __launch_bounds__(wg::kThreads, TcGeom<HD>::kMinBlocks)
prefill_attention_tc_kernel(const bf16* __restrict__ q,       // [b, s, n_q, hd]
                            const bf16* __restrict__ k_pool,  // [nblk, bs, n_kv, hd]
                            const bf16* __restrict__ v_pool,
                            const int* __restrict__ table,    // [b, nb]
                            const int* __restrict__ q_start,  // [b]
                            const int* __restrict__ q_lens,   // [b]
                            const unsigned char* __restrict__ mask,  // [b, nb*bs]
                            bf16* __restrict__ out,           // [b, s, n_q, hd]
                            int s, int nb, int bs, int n_kv, int group,
                            int window, float scale) {
  using G = TcGeom<HD>;
  constexpr int kParts = G::kParts;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t qs = wg::align_1k(tc_smem);
  const int r0 = blockIdx.x * wg::kRows;
  const int h = blockIdx.y;
  const int row = blockIdx.z;
  const int n_q = n_kv * group;
  const int width = nb * bs;
  const int rows = min(wg::kRows, s * group - r0);  // tile rows holding queries
  const int start = q_start[row];
  // cells the tile can need: from the window's first chunk for its first
  // query to its last valid query's cell
  const int t_last = min((r0 + rows - 1) / group, q_lens[row] - 1);
  int hi_cell = t_last < r0 / group ? -1 : min(start + t_last, width - 1);
  int lo_cell = window > 0 ? max(start + r0 / group - window + 1, 0) : 0;
  lo_cell = lo_cell / wg::kRows * wg::kRows;
  // opaque loop bounds, as in paged_attend.cuh's `attend`
  asm volatile("" : "+r"(lo_cell), "+r"(hi_cell));
  const kft::PagedAddr addr{table + (size_t)row * nb, bs, n_kv, h};
  const unsigned char* mask_row =
      mask ? mask + (size_t)row * width : nullptr;
  // tile row r -> query (token (r0 + r) / group, head h group + member)
  auto q_off = [&](int r) {
    const int f = r0 + r;
    return (((size_t)row * s + f / group) * n_q + (size_t)h * group +
            f % group) * HD;
  };
  // part p of an operand: head-dim columns [128 p, 128 p + 128)
  auto q_tile = [&](int p) { return qs + wg::kTileBytes * p; };
  auto k_tile = [&](int st, int p) {
    return qs + G::kOperandBytes * (1 + 2 * st) + wg::kTileBytes * p;
  };
  auto v_tile = [&](int st, int p) {
    return k_tile(st, p) + G::kOperandBytes;
  };
  auto load_kv = [&](int c0, int st) {
    const int n = min(wg::kRows, hi_cell - c0 + 1);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      wg::load_rows_async(
          k_tile(st, p),
          [&](int r) { return k_pool + addr(c0 + r) * HD + 128 * p; }, n);
      wg::load_rows_async(
          v_tile(st, p),
          [&](int r) { return v_pool + addr(c0 + r) * HD + 128 * p; }, n);
    }
  };
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    wg::load_rows_async(
        q_tile(p), [&](int r) { return q + q_off(r) + 128 * p; }, rows);
  if (lo_cell <= hi_cell) load_kv(lo_cell, 0);
  wg::cp_async_commit();

  const float sl2 = scale * wg::kLog2e;  // logits in log2 units
  const int fr = wg::frag_row(0);        // this thread's rows: fr, fr + 8
  const int qpos[2] = {start + (r0 + fr) / group,
                       start + (r0 + fr + 8) / group};
  // O's parts: acc[p] holds head-dim columns [128 p, 128 p + 128)
  float acc[kParts][64];
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
  // m starts finite and masked logits are -inf: exp2 of a masked logit is
  // exactly 0 even before the row's first visible cell
  float m[2] = {kft::kNegInf, kft::kNegInf}, l[2] = {0.f, 0.f};
  for (int c0 = lo_cell, st = 0; c0 <= hi_cell; c0 += wg::kRows, st ^= 1) {
    if (c0 + wg::kRows <= hi_cell) load_kv(c0 + wg::kRows, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this chunk (and Q) landed
    wg::fence_async_smem();
    __syncthreads();

    // S = Q K^T: 8 k-steps per 128-column part, chained into one
    // accumulator
    float sc[32];
    wg::mma_fence();
    wg::mma_hd<HD>(sc, qs, k_tile(st, 0));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(sc);

    float mx[2] = {kft::kNegInf, kft::kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int idx = c0 + wg::frag_col(i);
      const bool vis = idx <= min(qpos[r], hi_cell) &&
                       (window <= 0 || qpos[r] - idx < window) &&
                       (mask_row == nullptr || mask_row[idx]);
      sc[i] = vis ? sc[i] * sl2 : -INFINITY;
      mx[r] = fmaxf(mx[r], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], wg::quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - m[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
    uint32_t pa[16];
    wg::to_a<4>(sc, pa);  // P in bf16, as the A operand

    // O += P V: one m64n128 product per part, sharing P
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(acc[p]);
    wg::fence_regs(pa);
    wg::mma_fence();
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int kk = 0; kk < wg::kRows / 16; ++kk)
        wg::mma_rs_n128(acc[p], pa + 4 * kk, wg::desc_mn(v_tile(st, p), kk));
    wg::mma_commit();
    wg::mma_wait<0>();
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(acc[p]);
    __syncthreads();  // stage st is consumed before the next refill
  }
  wg::cp_async_wait<0>();  // Q's copy, if no chunk was visited
  __syncthreads();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = wg::quad_sum(l[r]);
    inv[r] = sum == 0.f ? 0.f : 1.f / sum;  // no visible cell: 0
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p)  // Q's tiles are free now
    wg::stage_acc(q_tile(p), acc[p], inv[0], inv[1]);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    wg::store_rows([&](int r) { return out + q_off(r) + 128 * p; }, rows,
                   q_tile(p));
}

template <typename T>
cudaError_t launch_scatter(const void* k_new, const void* v_new, void* k_pool,
                           void* v_pool, const void* table,
                           const void* q_start, const void* q_lens, int b,
                           int s, int nb, int bs, int row_elems,
                           cudaStream_t stream) {
  scatter_kernel<T><<<dim3(s, b), kft::kThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(q_start),
      static_cast<const int*>(q_lens), s, nb, bs, row_elems);
  return cudaGetLastError();
}

template <int HD>
int launch_fp32(const void* q, const void* k_new, const void* v_new,
                void* k_pool, void* v_pool, const void* table,
                const void* q_start, const void* q_lens, const void* mask,
                void* out, int b, int s, int nb, int bs, int n_kv, int group,
                int window, float scale, cudaStream_t stream) {
  cudaError_t err = launch_scatter<float>(k_new, v_new, k_pool, v_pool, table,
                                          q_start, q_lens, b, s, nb, bs,
                                          n_kv * HD, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = kft::Smem<float, HD>::bytes(kRows);
  err = kft::set_smem_once<float, HD>(prefill_attention_kernel<float, HD>);
  if (err != cudaSuccess) return err;
  const int tiles = (s * group + kRows - 1) / kRows;
  prefill_attention_kernel<float, HD>
      <<<dim3(tiles, n_kv, b), kft::kThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k_pool),
          static_cast<const float*>(v_pool), static_cast<const int*>(table),
          static_cast<const int*>(q_start),
          static_cast<const unsigned char*>(mask), static_cast<float*>(out),
          s, nb, bs, n_kv, group, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k_new, const void* v_new,
                void* k_pool, void* v_pool, const void* table,
                const void* q_start, const void* q_lens, const void* mask,
                void* out, int b, int s, int nb, int bs, int n_kv, int group,
                int window, float scale, cudaStream_t stream) {
  cudaError_t err = launch_scatter<bf16>(k_new, v_new, k_pool, v_pool, table,
                                         q_start, q_lens, b, s, nb, bs,
                                         n_kv * HD, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t kSmem = TcGeom<HD>::kSmemBytes;
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const int tiles = (s * group + wg::kRows - 1) / wg::kRows;
  prefill_attention_tc_kernel<HD><<<dim3(tiles, n_kv, b), wg::kThreads,
                                    kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(q_start), static_cast<const int*>(q_lens),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), s,
      nb, bs, n_kv, group, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k_new, const void* v_new,
           void* k_pool, void* v_pool, const void* table,
           const void* q_start, const void* q_lens, const void* mask,
           void* out, int b, int s, int nb, int bs, int n_kv, int group,
           int window, float scale, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_fp32<HD>(q, k_new, v_new, k_pool, v_pool, table, q_start,
                           q_lens, mask, out, b, s, nb, bs, n_kv, group,
                           window, scale, stream);
  if (dtype == 1)
    return launch_bf16<HD>(q, k_new, v_new, k_pool, v_pool, table, q_start,
                           q_lens, mask, out, b, s, nb, bs, n_kv, group,
                           window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). hd must
// be 128 (llama) or 256 (gemma). window <= 0 means none. mask may be null
// (every cell valid). Returns cudaGetLastError() after the launches.
extern "C" int kft_paged_prefill_append(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* table, const void* q_start, const void* q_lens,
    const void* mask, void* out, int b, int s, int nb, int bs, int n_kv,
    int group, int hd, int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((hd != 128 && hd != 256) || group < 1 || group > kft::kMaxRows)
    return cudaErrorInvalidValue;
  if (hd == 256)
    return launch<256>(q, k_new, v_new, k_pool, v_pool, table, q_start,
                       q_lens, mask, out, b, s, nb, bs, n_kv, group, window,
                       scale, dtype, st);
  return launch<128>(q, k_new, v_new, k_pool, v_pool, table, q_start, q_lens,
                     mask, out, b, s, nb, bs, n_kv, group, window, scale,
                     dtype, st);
}
