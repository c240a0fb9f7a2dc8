// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/flash_attention.py::_dkv_kernel (called from
// `_bwd`): with P = exp(logits - lse) and dS = P * (dO V^T - delta),
// dV = P^T dO and dK = dS^T Q * scale.
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 68.7 GFLOP (QK, P^T dO, dO V^T and
// dS^T Q over the visible pairs) against 67.6 MB moved, so operations
// bound it: 69 us at the bf16 tensor rate (989 TFLOP/s).
//
// Both kernels: one CUDA block per (KV head, batch row, 64-key tile),
// holding its K and V tiles in shared memory. It loops over the group's
// query heads and, for each, over the query tiles that see its keys
// (causal: from the diagonal on; with a window, only up to the band's
// end), and accumulates dK and dV for all of them in fp32 registers. So
// GQA's group sum happens inside the kernel: the reference writes
// per-query-head [b, n_q, s, hd] outputs and sums the group outside
// (flash_attention.py:337-349); here dK and dV are written once, at
// KV-head resolution, with no atomics. Scores are computed key-major
// (rows = keys, columns = queries). The heaviest key tiles (the first,
// under causal masking) are launched first.
//
// bf16 (the training path), on the tensor cores: one warpgroup per block
// (M = the block's 64 keys). K and V sit in shared memory as swizzled
// bf16 tiles (flash_wgmma.cuh); Q, dO, lse and delta of the next query
// tile stream into a 2-stage cp.async ring while this one computes.
// S^T = K Q^T and dP^T = V dO^T are 8 wgmma k-steps each (m64n64k16,
// both operands K-major in shared memory), issued back to back; P^T =
// exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) are formed in the
// fp32 accumulator fragments, rounded to bf16 in registers, and are the
// A operands of dV += P^T dO and dK += dS^T Q (4 k-steps of m64n128k16
// each, dO and Q read MN-major in their natural [queries, hd] layout).
// No P^T or dS^T tile goes through shared memory. Live accumulators: dK
// 64, dV 64, S^T 32, dP^T 32 fp32 registers a thread. 98 KB of shared
// memory a block, so two blocks share an SM. dK and dV leave through
// shared memory in 16-byte stores. What held the first kernel (below)
// back: fp32 products on the CUDA cores (67 TFLOP/s peak against 989),
// P^T and dS^T round-tripped through shared memory with barriers around
// each, synchronous loads, and 150 KB of fp32 tiles (one block an SM).
//
// Head dim 256 and one KV head for 8 query heads (gemma-2b: b 2, s 2048;
// the same 68.7 GFLOP and bound as llama3-1b's shape): the bf16 kernel is
// a template on the head dim, rows of K, V, Q and dO two [64, 128] tiles
// each (flash_wgmma.cuh's Operand), S^T and dP^T 16 k-steps each. Two
// problems, and what the design does about them:
// - registers: dK and dV at [64, 256] would be 128 + 128 fp32 registers
//   a thread before S^T and dP^T. So a block computes one 128-column
//   part of both (grid.x counts the parts): each part's block forms
//   S^T and dP^T over the full head dim (1.5x the tensor work at 256),
//   and keeps llama's register budget (dK 64, dV 64, S^T 32, dP^T 32).
// - parallelism: one KV head, batch 2 and 32 key tiles are 64 blocks (128
//   with the parts) on 132 SMs, the first key tile walking 8 heads x 32
//   query tiles. So the group's query heads may be split into `splits`
//   subgroups, one block each, that write fp32 partial dK and dV at
//   [b, s, n_kv, splits, hd] for the caller to sum: the reference's own
//   placement of the group sum (it writes per-query-head dK and dV and
//   sums them outside its kernel, flash_attention.py:337-349). The
//   wrapper picks `splits` from the shapes alone; at llama3-1b's shape
//   (512 blocks) it is 1, the in-kernel group sum and one bf16 output.
//
// fp32 (the CUDA cores; TF32 would round the products), a template on
// the head dim. Bound at gemma-2b's shape: the 68.7 GFLOP over 67
// TFLOP/s, 1.026 ms. Two problems of the first fp32 kernel, and what the
// design does about them:
// - parallelism: 64 blocks on 132 SMs at gemma-2b's one KV head, the
//   first key tile walking 8 heads x 32 query tiles while the average SM
//   had 64 steps of work. The query-head split above applies to fp32 as
//   well: `splits` subgroups write fp32 dK and dV at [b, s, n_kv, splits,
//   hd], summed by the caller (`default_head_splits` picks 4 there: 256
//   blocks, heaviest key tiles first);
// - the step: synchronous loads (Q read twice at 256), five barriers a
//   step and 4 x 4 micro-tiles. Now K and V stay resident as padded [64,
//   HD] tiles; Q and dO of each (query head, query tile) step stream
//   through flash_fp32_ring.cuh's cp.async ring, as 32-column chunks for
//   S^T = K Q^T and dP^T = V dO^T, then as chunks of whole rows (8 at
//   256, 16 at 128) for dV += P^T dO and dK += dS^T Q (all four operands
//   would need 266 KB at 256); lse and delta come in registers. The two
//   warpgroups split the work: one forms S^T, P^T and dV, the other
//   dP^T, dS^T and dK, each thread an 8 x 4 micro-tile of its score
//   product and 8 rows x 16 columns of its accumulator at 256 (8 x 8 at
//   128; 5.3 and 4 FMAs a loaded float). P^T is formed once into a
//   shared [query][key] tile, dS^T beside it; one barrier a chunk and
//   one more a step. dK or dV: 128 fp32 registers a thread at 256. 218
//   KB of shared memory at 256 (154 KB at 128), one block an SM.
// On an H100 80GB HBM3 at 700 W: 2.07 ms at gemma-2b's shape (50% of the
// bound; the first kernel 9.02 in the same run), 2.16 ms at llama3-1b's
// (48%; 2.41).
#include "flash_fp32_ring.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace kft_flash;
namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

// -- fp32 -------------------------------------------------------------------

// K and V resident, P^T and dS^T tiles and the ring: 154 KB at head dim
// 128, 218 KB at 256 (one block an SM).
template <int HD>
constexpr size_t fp32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kHdTileFloats<HD> + 2 * kPTileFloats +
                          kRingStages * kStageFloats);
}

// grid.x = n_kv x splits: block x takes KV head x / splits and query-head
// subgroup x % splits of its group; it writes fp32 dK and dV at [b, s,
// n_kv, splits, hd] (with splits == 1, [b, s, n_kv, hd]).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const float* __restrict__ q,      // [b, s, n_q, hd]
                 const float* __restrict__ k,      // [b, s, n_kv, hd]
                 const float* __restrict__ v,
                 const float* __restrict__ dout,   // [b, s, n_q, hd]
                 const float* __restrict__ lse,    // [b, n_q, s]
                 const float* __restrict__ delta,  // [b, n_q, s]
                 float* __restrict__ dk,  // [b, s, n_kv, splits, hd]
                 float* __restrict__ dv,
                 int s, int n_q, int n_kv, int splits, int causal,
                 int window, float scale) {
  constexpr int kP1 = HD / kChunk;           // Q and dO column chunks a step
  constexpr int kRows = kStageRows<HD> / 2;  // Q and dO rows of a phase-3 chunk
  constexpr int kP3 = kTile / kRows;
  constexpr int kIters = kP1 + kP3;          // ring chunks a step
  constexpr int kCols = HD / 64;             // float4 columns of dK or dV a thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kHdTileFloats<HD>;
  float* pq = vs + kHdTileFloats<HD>;  // P: [query][key]
  float* sq = pq + kPTileFloats;       // dS: [query][key]
  float* ring_base = sq + kPTileFloats;
  const int sub = blockIdx.x % splits;
  const int hk = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // heaviest (earliest) tiles first
  const int nq = (s + kTile - 1) / kTile;
  const int heads = n_q / n_kv / splits;  // query heads of the subgroup
  const int h0 = hk * (n_q / n_kv) + sub * heads;
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * HD;
  int lo, hi;
  query_tiles(k0, nq, causal, window, &lo, &hi);
  const int per_head = hi - lo + 1;
  const int steps = heads * per_head;  // (query head, query tile) pairs
  // chunk J: step J / kIters; for r = J % kIters < kP1 its Q and dO
  // columns [32 r, 32 r + 32), else its Q and dO rows [kRows (r - kP1),
  // + kRows)
  auto issue = [&](int J, float* st) {
    const int t = J / kIters, r = J % kIters;
    const int h = h0 + t / per_head;
    const int q0 = (lo + t % per_head) * kTile;
    const size_t off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
    if (r < kP1) {
      load_async<kTile, kChunk>(st, kCStride, q + off + r * kChunk, q_row,
                                s - q0);
      load_async<kTile, kChunk>(st + kTile * kCStride, kCStride,
                                dout + off + r * kChunk, q_row, s - q0);
    } else {
      const int r0 = (r - kP1) * kRows;
      const int valid = s - q0 - r0;  // <= 0: zeros, from the tile's row 0
      const size_t at = off + (valid > 0 ? r0 * q_row : 0);
      load_async<kRows, HD>(st, kStride<HD>, q + at, q_row, valid);
      load_async<kRows, HD>(st + kRows * kStride<HD>, kStride<HD>,
                            dout + at, q_row, valid);
    }
  };
  load_async<kTile, HD>(ks, kStride<HD>, k + kv_off, kv_row, s - k0);
  load_async<kTile, HD>(vs, kStride<HD>, v + kv_off, kv_row, s - k0);
  ChunkRing<decltype(issue)> ring{ring_base, steps * kIters, issue};
  ring.start();

  // Two warpgroups: grp 0 forms S^T = K Q^T, P^T and dV += P^T dO; grp 1
  // forms dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q.
  // Phase 1: rows (keys) ka + 8 i, columns (queries) qa + 16 j; a warp
  // is 4 x 8 of (ka, qa). Phase 3: rows 8 kt + i, head-dim columns 64 m
  // + 4 dt + j; a warp is 2 x 16 of (kt, dt).
  const int grp = threadIdx.x / 128;
  const int gw = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int ka = (gw % 2) * 4 + lane / 8, qa = (gw / 2) * 8 + lane % 8;
  const int kt = 2 * gw + lane / 16, dt = lane % 16;
  const float* rows = grp ? vs : ks;       // phase 1's A operand
  const float* stat = grp ? delta : lse;
  const float* pd = (grp ? sq : pq) + 8 * kt;  // phase 3's A operand
  float acc[8][4 * kCols];                 // dV (grp 0) or dK (grp 1)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int h = h0 + t / per_head;
    const int q0 = (lo + t % per_head) * kTile;
    const size_t so = ((size_t)b * n_q + h) * s;
    float rs[4];  // lse (grp 0) or delta (grp 1) of the columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + qa + 16 * j;
      rs[j] = qp < s ? stat[so + qp] : 0.f;
    }
    float x[8][4];  // S^T (grp 0) or dP^T (grp 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kP1; ++c) {
      // grp 0 reads the Q chunk, grp 1 the dO chunk
      const float* cb = ring.next() + grp * kTile * kCStride;
      const float* ab = rows + c * kChunk;
#pragma unroll 4
      for (int d = 0; d < kChunk; d += 4) {
        float4 bq[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bq[j] = ld4(cb + (qa + 16 * j) * kCStride + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(ab + (ka + 8 * i) * kStride<HD> + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float y = x[i][j];
            y = fmaf(a.x, bq[j].x, y);
            y = fmaf(a.y, bq[j].y, y);
            y = fmaf(a.z, bq[j].z, y);
            y = fmaf(a.w, bq[j].w, y);
            x[i][j] = y;
          }
        }
      }
    }
    if (grp == 0) {  // P^T, stored [query][key]
      const bool edge = edge_tile(q0, k0, s, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = expf(x[i][j] * scale - rs[j]);
          if (edge && !visible(q0 + qa + 16 * j, k0 + ka + 8 * i, s, causal,
                               window))
            p = 0.f;
          pq[(qa + 16 * j) * kPStride + ka + 8 * i] = p;
        }
    }
    __syncthreads();  // P^T is in shared memory
    if (grp == 1) {   // dS^T at the same places
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (qa + 16 * j) * kPStride + ka + 8 * i;
          sq[at] = pq[at] * (x[i][j] - rs[j]);
        }
    }
    // Phase 3 (the next chunk's barrier publishes dS^T): grp 0 dV += P^T
    // dO, grp 1 dK += dS^T Q, over kRows queries a chunk
#pragma unroll 1
    for (int c = 0; c < kP3; ++c) {
      // grp 0 reads the dO rows, grp 1 the Q rows
      const float* cb = ring.next() + (1 - grp) * kRows * kStride<HD> +
                        4 * dt;
      const float* ac = pd + c * kRows * kPStride;
#pragma unroll 8
      for (int qq = 0; qq < kRows; ++qq) {
        const float4 a0 = ld4(ac + qq * kPStride);
        const float4 a1 = ld4(ac + qq * kPStride + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const float4 b4 = ld4(cb + qq * kStride<HD> + 64 * m);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * m] = fmaf(av[i], b4.x, acc[i][4 * m]);
            acc[i][4 * m + 1] = fmaf(av[i], b4.y, acc[i][4 * m + 1]);
            acc[i][4 * m + 2] = fmaf(av[i], b4.z, acc[i][4 * m + 2]);
            acc[i][4 * m + 3] = fmaf(av[i], b4.w, acc[i][4 * m + 3]);
          }
        }
      }
    }
  }
  kft_wgmma::cp_async_wait<0>();
  float* out = grp ? dk : dv;
  const float mul = grp ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kp = k0 + 8 * kt + i;
    if (kp >= s) continue;
    float* row = out + ((((size_t)b * s + kp) * n_kv + hk) * splits + sub) *
                           HD + 4 * dt;
#pragma unroll
    for (int m = 0; m < kCols; ++m)
      *reinterpret_cast<float4*>(row + 64 * m) = make_float4(
          acc[i][4 * m] * mul, acc[i][4 * m + 1] * mul,
          acc[i][4 * m + 2] * mul, acc[i][4 * m + 3] * mul);
  }
}

// -- bf16: tensor cores -----------------------------------------------------

constexpr int kStages = 2;  // Q / dO / lse / delta ring
constexpr uint32_t kStatBytes = 2 * kTile * sizeof(float);  // lse, delta

// Shared memory at head dim HD: K, V, kStages x (Q, dO), each an
// Operand<HD>, then kStages x (lse, delta); 1 KB of slack for the
// 1024-byte alignment. 98 KB at 128 (two blocks an SM), 194 KB at 256
// (one).
template <int HD>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)wg::Operand<HD>::kBytes * (2 + 2 * kStages) +
         kStatBytes * kStages;
}

// grid.x = n_kv x splits x HD / 128: block x takes KV head x / (splits
// HD / 128), query-head subgroup (x / (HD / 128)) % splits of that head's
// group, and output part x % (HD / 128) (dK and dV head-dim columns
// [128 part, 128 part + 128)). With splits == 1 it writes dK and dV in
// bf16 at [b, s, n_kv, hd]; otherwise fp32 partials at [b, s, n_kv,
// splits, hd], which the caller sums over the splits.
template <int HD>
__global__ void __launch_bounds__(wg::kThreads, HD == 128 ? 2 : 1)
flash_dkv_tc_kernel(const bf16* __restrict__ q,       // [b, s, n_q, hd]
                    const bf16* __restrict__ k,       // [b, s, n_kv, hd]
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,    // [b, s, n_q, hd]
                    const float* __restrict__ lse,    // [b, n_q, s]
                    const float* __restrict__ delta,  // [b, n_q, s]
                    bf16* __restrict__ dk,            // [b, s, n_kv, hd]
                    bf16* __restrict__ dv,
                    float* __restrict__ dk_part,  // [b, s, n_kv, splits, hd]
                    float* __restrict__ dv_part,
                    int s, int n_q, int n_kv, int splits, int causal,
                    int window, float scale) {
  constexpr int kParts = wg::Operand<HD>::kParts;
  constexpr uint32_t kOpBytes = wg::Operand<HD>::kBytes;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t ks = wg::align_1k(tc_smem);
  const uint32_t vs = ks + kOpBytes;
  auto q_tile = [&](int st) { return ks + kOpBytes * (2 + 2 * st); };
  auto do_tile = [&](int st) { return q_tile(st) + kOpBytes; };
  auto stats = [&](int st) {  // lse [64] then delta [64]
    return ks + kOpBytes * (2 + 2 * kStages) + kStatBytes * st;
  };
  const float* stats_ptr = reinterpret_cast<const float*>(
      tc_smem + (stats(0) - wg::smem_u32(tc_smem)));
  const int op = blockIdx.x % kParts;  // output part
  const int sub = blockIdx.x / kParts % splits;
  const int hk = blockIdx.x / kParts / splits;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // heaviest (earliest) tiles first
  const int nq = (s + kTile - 1) / kTile;
  const int heads = n_q / n_kv / splits;  // query heads of the subgroup
  const int h0 = hk * (n_q / n_kv) + sub * heads;
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * HD;
  int lo, hi;
  query_tiles(k0, nq, causal, window, &lo, &hi);
  const int per_head = hi - lo + 1;
  const int steps = heads * per_head;  // (query head, query tile) pairs
  const int tid = threadIdx.x;
  auto load_q = [&](int it, int st) {
    const int h = h0 + it / per_head;
    const int q0 = (lo + it % per_head) * kTile;
    const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
    wg::load_operand_async<HD>(q_tile(st), q + q_off, q_row, s - q0);
    wg::load_operand_async<HD>(do_tile(st), dout + q_off, q_row, s - q0);
    const size_t stat = ((size_t)b * n_q + h) * s + q0;
    wg::load_row_async(stats(st) + (tid < kTile ? 0 : kTile * 4),
                       (tid < kTile ? lse : delta) + stat, tid % kTile,
                       s - q0);
  };
  wg::load_operand_async<HD>(ks, k + kv_off, kv_row, s - k0);
  wg::load_operand_async<HD>(vs, v + kv_off, kv_row, s - k0);
  load_q(0, 0);
  wg::cp_async_commit();

  const float sl2 = scale * wg::kLog2e;  // logits in log2 units
  const int key0 = k0 + wg::frag_row(0);  // this thread's keys: +0, +8
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    if (it + 1 < steps) load_q(it + 1, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this step's tiles (and K, V) landed
    wg::fence_async_smem();
    __syncthreads();

    float sT[32], dpT[32];
    wg::mma_fence();
    wg::mma_hd<HD>(sT, ks, q_tile(st));
    wg::mma_commit();
    wg::mma_hd<HD>(dpT, vs, do_tile(st));
    wg::mma_commit();

    // masking only where the tile meets the diagonal, the window's edge
    // or the sequence's end
    const int q0 = (lo + it % per_head) * kTile;
    const bool edge =
        q0 + kTile > s || k0 + kTile > s ||
        (causal && (k0 + kTile - 1 > q0 ||
                    (window > 0 && q0 + kTile - 1 - k0 >= window)));
    const float* lse_s = stats_ptr + st * (kStatBytes / 4);
    const float* delta_s = lse_s + kTile;
    wg::mma_wait<1>();  // S^T is done, dP^T may still run
    wg::fence_regs(sT);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = wg::frag_col(i);
      float p = exp2f(sT[i] * sl2 - lse_s[c] * wg::kLog2e);
      if (edge && !visible(q0 + c, key0 + 8 * ((i >> 1) & 1), s, causal,
                           window))
        p = 0.f;
      sT[i] = p;  // P^T
    }
    wg::mma_wait<0>();
    wg::fence_regs(dpT);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dpT[i] = sT[i] * (dpT[i] - delta_s[wg::frag_col(i)]);  // dS^T
    uint32_t pa[16], dsa[16];
    wg::to_a<4>(sT, pa);  // bf16 A operands
    wg::to_a<4>(dpT, dsa);

    wg::fence_regs(pa);
    wg::fence_regs(dsa);
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    wg::mma_fence();
    const uint32_t do_part = do_tile(st) + wg::kTileBytes * op;
    const uint32_t q_part = q_tile(st) + wg::kTileBytes * op;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::mma_rs_n128(dv_acc, pa + 4 * kk, wg::desc_mn(do_part, kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::mma_rs_n128(dk_acc, dsa + 4 * kk, wg::desc_mn(q_part, kk));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    __syncthreads();  // stage st is consumed before the next refill
  }

  if (splits > 1) {  // fp32 partials, straight from the fragments
    auto row = [&](float* base) {
      return [=](int r) {
        return base + ((((size_t)b * s + k0 + r) * n_kv + hk) * splits +
                       sub) * HD + 128 * op;
      };
    };
    wg::store_acc_f32(row(dv_part), s - k0, dv_acc, 1.f);
    wg::store_acc_f32(row(dk_part), s - k0, dk_acc, scale);
    return;
  }
  // K and V were read for the last time above: their tiles hold the output
  wg::stage_acc(vs, dv_acc, 1.f, 1.f);
  wg::stage_acc(ks, dk_acc, scale, scale);
  __syncthreads();
  wg::store_tile(dv + kv_off + 128 * op, kv_row, s - k0, vs);
  wg::store_tile(dk + kv_off + 128 * op, kv_row, s - k0, ks);
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int s, int n_q, int n_kv,
                int splits, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t kSmem = fp32_smem_bytes<HD>();
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_kv * splits, b, (s + kTile - 1) / kTile);
  flash_dkv_kernel<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s, n_q, n_kv,
      splits, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int s, int n_q, int n_kv,
                int splits, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t kSmem = tc_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const bool part = splits > 1;
  const dim3 grid(n_kv * splits * wg::Operand<HD>::kParts, b,
                  (s + kTile - 1) / kTile);
  flash_dkv_tc_kernel<HD><<<grid, wg::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      part ? nullptr : static_cast<bf16*>(dk),
      part ? nullptr : static_cast<bf16*>(dv),
      part ? static_cast<float*>(dk) : nullptr,
      part ? static_cast<float*>(dv) : nullptr, s, n_q, n_kv, splits,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); hd 128
// or 256. splits: query-head subgroups of each GQA group, a divisor of
// n_q / n_kv. fp32 writes dk and dv at [b, s, n_kv, splits, hd] (the
// outputs themselves at splits 1); bf16 writes bf16 dk and dv at splits
// 1, else fp32 partials [b, s, n_kv, splits, hd]; the caller sums
// partials over splits. window <= 0 means none. Returns
// cudaGetLastError() after the launch.
extern "C" int kft_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int s,
                                       int n_q, int n_kv, int hd, int causal,
                                       int window, float scale, int dtype,
                                       int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || n_kv < 1 || n_q % n_kv || splits < 1 ||
      (n_q / n_kv) % splits)
    return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 128)
    return launch_fp32<128>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q,
                            n_kv, splits, causal, window, scale, st);
  if (dtype == 0 && hd == 256)
    return launch_fp32<256>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q,
                            n_kv, splits, causal, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q,
                            n_kv, splits, causal, window, scale, st);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q,
                            n_kv, splits, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
