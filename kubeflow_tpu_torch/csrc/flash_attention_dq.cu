// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/flash_attention.py::_dq_kernel (called from
// `_bwd`): with P = exp(logits - lse) recomputed from the forward's
// logsumexp and delta = rowsum(dO * O) (computed by the caller, as the
// reference does outside its kernels), dS = P * (dO V^T - delta) and
// dQ = dS K * scale, accumulated in fp32 and written once in the input
// dtype.
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 51.6 GFLOP (QK, dO V^T and dS K over the
// visible pairs) against 67.6 MB moved (20 us at 3.35 TB/s), so
// operations bound it: 52 us at the bf16 tensor rate (989 TFLOP/s).
//
// Both kernels: one CUDA block per (query head, batch row, 64-query
// tile), holding its Q and dO tiles and their lse and delta; it walks the
// same key tiles as the forward (causal and window skipping, masked tail)
// and keeps the [64, hd] dQ accumulator in registers. The heaviest query
// tiles (the last, under causal masking) are launched first.
//
// bf16 (the training path), on the tensor cores: one warpgroup per block
// (M = the block's 64 queries). Q and dO sit in shared memory as swizzled
// bf16 tiles (flash_wgmma.cuh), loaded once; each thread keeps the lse and
// delta of its two fragment rows in registers. K and V tiles stream
// through a 2-stage cp.async ring, the next key tile's copy overlapping
// this one's products. S = Q K^T and dP = dO V^T are 8 wgmma k-steps each
// (m64n64k16, both operands K-major in shared memory), issued back to
// back; P = exp2(S scale log2e - lse log2e) and dS = P (dP - delta) are
// formed in the fp32 accumulator fragments (masked only on tiles that
// meet the diagonal, the window's edge or the sequence's end), rounded to
// bf16 in registers, and are the A operand of dQ += dS K (4 k-steps of
// m64n128k16, K read MN-major from the tile S already used). No dS tile
// goes through shared memory. Live accumulators: dQ 64, S 32, dP 32 fp32
// registers a thread. 97 KB of shared memory a block, so two blocks share
// an SM. dQ leaves through Q's tile in 16-byte stores. What held the
// first kernel (below) back: all three products in fp32 on the CUDA cores
// (67 TFLOP/s peak against 989), synchronous K/V loads, dS round-tripped
// through shared memory with three barriers a key tile, and 150 KB of
// fp32 tiles (one block an SM).
//
// Head dim 256 (gemma-2b: b 2, s 2048, n_q 8, n_kv 1; the same 51.6
// GFLOP and bound as llama3-1b's shape): the bf16 kernel is a template on
// the head dim. Q, dO, K and V rows are two [64, 128] tiles each
// (flash_wgmma.cuh's Operand); S and dP chain 16 k-steps each; dQ is two
// m64n128 accumulators sharing one bf16 dS fragment: dQ 128, S 32 and
// dP 32 fp32 registers a thread. Q, dO and a 2-stage K/V ring: 193 KB,
// one block an SM; the grid stays (query head, batch row, 64-query
// tile). ptxas fits it in 255 registers with no spill (204 when dQ's
// head dim was split over two blocks that each form dS, which does 5/3
// the tensor work; 205 at hd 128).
//
// fp32 (the CUDA cores; TF32 would round the products the reference's
// fp32 kernels take in full fp32), a template on the head dim. Bound at
// gemma-2b's shape: the 51.6 GFLOP over the card's 67 TFLOP/s of fp32
// FMAs, 0.770 ms. The first fp32 kernel lost its time in the step:
// synchronous K and V loads (at 256 one tile took V, then K), three
// barriers a key tile, and 4 x 4 micro-tiles whose shared loads outran
// the FMAs. Design:
// - Q and dO stay resident as padded [64, HD] tiles; K and V stream
//   through flash_fp32_ring.cuh's cp.async ring, as 32-column chunks for
//   S = Q K^T and dP = dO V^T, then K again as chunks of whole rows (16
//   at 256, 32 at 128) for dQ += dS K (all four operands would need 266
//   KB at 256), so no load waits in line: one barrier a chunk, and one
//   a key tile for P;
// - the two warpgroups split the score products: one forms S and P =
//   exp(S scale - lse), the other dP and dS = P (dP - delta) from P in
//   shared memory; 8 x 4 micro-tiles (rows 8 apart, columns 16 apart);
// - dQ += dS K over all 256 threads, dS^T from a shared [key][query]
//   tile: 8 rows x 8 columns a thread at 256 (8 x 4 at 128), 4 FMAs a
//   loaded float, a warp reading one row of the K chunk in 16-byte loads.
// 218 KB of shared memory at 256 (154 KB at 128), one block an SM; the
// grid stays (query head, batch row, 64-query tile), 512 blocks at
// gemma-2b's shape, the heaviest first. On an H100 80GB HBM3 at 700 W:
// 1.48 ms at gemma-2b's shape (52% of the bound; the first kernel 1.72
// in the same run), 1.60 ms at llama3-1b's (48%; 1.85).
#include "flash_fp32_ring.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace kft_flash;
namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

// -- fp32 -------------------------------------------------------------------

// Q and dO resident, the P and dS^T tiles and the ring: 154 KB at head
// dim 128, 218 KB at 256 (one block an SM).
template <int HD>
constexpr size_t fp32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kHdTileFloats<HD> + 2 * kPTileFloats +
                          kRingStages * kStageFloats);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const float* __restrict__ q,      // [b, s, n_q, hd]
                const float* __restrict__ k,      // [b, s, n_kv, hd]
                const float* __restrict__ v,
                const float* __restrict__ dout,   // [b, s, n_q, hd]
                const float* __restrict__ lse,    // [b, n_q, s]
                const float* __restrict__ delta,  // [b, n_q, s]
                float* __restrict__ dq,           // [b, s, n_q, hd]
                int s, int n_q, int n_kv, int causal, int window,
                float scale) {
  constexpr int kP1 = HD / kChunk;       // K and V column chunks a key tile
  constexpr int kRows = kStageRows<HD>;  // K rows of a phase-3 chunk
  constexpr int kP3 = kTile / kRows;
  constexpr int kIters = kP1 + kP3;      // ring chunks a key tile
  constexpr int kCols = HD / 128;        // float4 columns of dQ a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kHdTileFloats<HD>;
  float* ps = dos + kHdTileFloats<HD>;   // P: [key][query]
  float* ds_s = ps + kPTileFloats;       // dS^T: [key][query]
  float* ring_base = ds_s + kPTileFloats;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.z) * kTile;  // heaviest tiles first
  const int hk = h / (n_q / n_kv);
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
  const size_t kv_head = (size_t)b * s * kv_row + (size_t)hk * HD;
  int lo, hi;
  key_tiles(q0, nq, causal, window, &lo, &hi);
  // chunk J: key tile lo + J / kIters; for r = J % kIters < kP1 its K
  // and V columns [32 r, 32 r + 32), else its K rows [kRows (r - kP1),
  // + kRows)
  auto issue = [&](int J, float* st) {
    const int k0 = (lo + J / kIters) * kTile;
    const int r = J % kIters;
    const size_t off = kv_head + (size_t)k0 * kv_row;
    if (r < kP1) {
      load_async<kTile, kChunk>(st, kCStride, k + off + r * kChunk, kv_row,
                                s - k0);
      load_async<kTile, kChunk>(st + kTile * kCStride, kCStride,
                                v + off + r * kChunk, kv_row, s - k0);
    } else {
      const int r0 = (r - kP1) * kRows;
      const int valid = s - k0 - r0;  // <= 0: zeros, from the tile's row 0
      load_async<kRows, HD>(st, kStride<HD>,
                            k + off + (valid > 0 ? r0 * kv_row : 0), kv_row,
                            valid);
    }
  };
  load_async<kTile, HD>(qs, kStride<HD>, q + q_off, q_row, s - q0);
  load_async<kTile, HD>(dos, kStride<HD>, dout + q_off, q_row, s - q0);
  ChunkRing<decltype(issue)> ring{ring_base, (hi - lo + 1) * kIters, issue};
  ring.start();

  // Phase 1, two warpgroups: grp 0 forms S = Q K^T and P, grp 1 dP =
  // dO V^T and dS; rows (queries) qa + 8 i, columns (keys) ka + 16 j.
  // Phase 3, dQ += dS K: rows 8 qt + i, head-dim columns 128 m + 4 dt +
  // j. A warp is 4 x 8 of (qa, ka), or one qt and 32 dt.
  const int grp = threadIdx.x / 128;
  const int gw = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int qa = (gw % 2) * 4 + lane / 8, ka = (gw / 2) * 8 + lane % 8;
  const int qt = threadIdx.x / 32, dt = lane;
  const float* rows = grp ? dos : qs;      // phase 1's A operand
  const size_t stat = ((size_t)b * n_q + h) * s;
  float rs[8];  // lse (grp 0) or delta (grp 1) of the rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + qa + 8 * i;
    rs[i] = qp < s ? (grp ? delta : lse)[stat + qp] : 0.f;
  }
  float acc[8][4 * kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[i][j] = 0.f;

  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * kTile;
    float x[8][4];  // S (grp 0) or dP (grp 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kP1; ++c) {
      // grp 0 reads the K chunk, grp 1 the V chunk
      const float* cb = ring.next() + grp * kTile * kCStride;
      const float* ab = rows + c * kChunk;
#pragma unroll 4
      for (int d = 0; d < kChunk; d += 4) {
        float4 bk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bk[j] = ld4(cb + (ka + 16 * j) * kCStride + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(ab + (qa + 8 * i) * kStride<HD> + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float y = x[i][j];
            y = fmaf(a.x, bk[j].x, y);
            y = fmaf(a.y, bk[j].y, y);
            y = fmaf(a.z, bk[j].z, y);
            y = fmaf(a.w, bk[j].w, y);
            x[i][j] = y;
          }
        }
      }
    }
    if (grp == 0) {  // P, stored [key][query]
      const bool edge = edge_tile(q0, k0, s, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = expf(x[i][j] * scale - rs[i]);
          if (edge && !visible(q0 + qa + 8 * i, k0 + ka + 16 * j, s, causal,
                               window))
            p = 0.f;
          ps[(ka + 16 * j) * kPStride + qa + 8 * i] = p;
        }
    }
    __syncthreads();  // P is in shared memory
    if (grp == 1) {   // dS^T at the same places
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ka + 16 * j) * kPStride + qa + 8 * i;
          ds_s[at] = ps[at] * (x[i][j] - rs[i]);
        }
    }
    // Phase 3 (the next chunk's barrier publishes dS^T): dQ += dS K over
    // kRows keys a chunk
#pragma unroll 1
    for (int c = 0; c < kP3; ++c) {
      const float* kt = ring.next();
      const float* dsc = ds_s + c * kRows * kPStride + 8 * qt;
#pragma unroll 8
      for (int kk = 0; kk < kRows; ++kk) {
        const float4 d0 = ld4(dsc + kk * kPStride);
        const float4 d1 = ld4(dsc + kk * kPStride + 4);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const float4 k4 = ld4(kt + kk * kStride<HD> + 128 * m + 4 * dt);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * m] = fmaf(dv[i], k4.x, acc[i][4 * m]);
            acc[i][4 * m + 1] = fmaf(dv[i], k4.y, acc[i][4 * m + 1]);
            acc[i][4 * m + 2] = fmaf(dv[i], k4.z, acc[i][4 * m + 2]);
            acc[i][4 * m + 3] = fmaf(dv[i], k4.w, acc[i][4 * m + 3]);
          }
        }
      }
    }
  }
  kft_wgmma::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * qt + i;
    if (q0 + r >= s) continue;
    float* row = dq + q_off + r * q_row + 4 * dt;
#pragma unroll
    for (int m = 0; m < kCols; ++m)
      *reinterpret_cast<float4*>(row + 128 * m) = make_float4(
          acc[i][4 * m] * scale, acc[i][4 * m + 1] * scale,
          acc[i][4 * m + 2] * scale, acc[i][4 * m + 3] * scale);
  }
}

// -- bf16: tensor cores -----------------------------------------------------

constexpr int kStages = 2;  // K/V ring

// Shared memory at head dim HD: Q, dO, then kStages x (K, V), each an
// Operand<HD>; 1 KB of slack for the 1024-byte alignment. 97 KB at 128
// (two blocks an SM), 193 KB at 256 (one).
template <int HD>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)wg::Operand<HD>::kBytes * (2 + 2 * kStages);
}

template <int HD>
__global__ void __launch_bounds__(wg::kThreads, HD == 128 ? 2 : 1)
flash_dq_tc_kernel(const bf16* __restrict__ q,       // [b, s, n_q, hd]
                   const bf16* __restrict__ k,       // [b, s, n_kv, hd]
                   const bf16* __restrict__ v,
                   const bf16* __restrict__ dout,    // [b, s, n_q, hd]
                   const float* __restrict__ lse,    // [b, n_q, s]
                   const float* __restrict__ delta,  // [b, n_q, s]
                   bf16* __restrict__ dq,            // [b, s, n_q, hd]
                   int s, int n_q, int n_kv, int causal, int window,
                   float scale) {
  constexpr int kParts = wg::Operand<HD>::kParts;
  constexpr uint32_t kOpBytes = wg::Operand<HD>::kBytes;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t qs = wg::align_1k(tc_smem);
  const uint32_t dos = qs + kOpBytes;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.z) * kTile;  // heaviest tiles first
  const int hk = h / (n_q / n_kv);
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
  const size_t kv_head = (size_t)b * s * kv_row + (size_t)hk * HD;
  auto k_tile = [&](int st) { return qs + kOpBytes * (2 + 2 * st); };
  auto v_tile = [&](int st) { return k_tile(st) + kOpBytes; };
  auto load_kv = [&](int ki, int st) {
    const int k0 = ki * kTile;
    wg::load_operand_async<HD>(k_tile(st), k + kv_head + (size_t)k0 * kv_row,
                               kv_row, s - k0);
    wg::load_operand_async<HD>(v_tile(st), v + kv_head + (size_t)k0 * kv_row,
                               kv_row, s - k0);
  };
  int lo, hi;
  key_tiles(q0, nq, causal, window, &lo, &hi);
  wg::load_operand_async<HD>(qs, q + q_off, q_row, s - q0);
  wg::load_operand_async<HD>(dos, dout + q_off, q_row, s - q0);
  load_kv(lo, 0);
  wg::cp_async_commit();

  // this thread's two fragment rows: row0 and row0 + 8
  const int row0 = q0 + wg::frag_row(0);
  const size_t stat = ((size_t)b * n_q + h) * s;
  float lse2[2], dlt[2];  // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lse2[r] = qp < s ? lse[stat + qp] * wg::kLog2e : 0.f;
    dlt[r] = qp < s ? delta[stat + qp] : 0.f;
  }
  const float sl2 = scale * wg::kLog2e;  // logits in log2 units
  // dQ's parts: dq_acc[p] holds head-dim columns [128 p, 128 p + 128)
  float dq_acc[kParts][64];
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[p][i] = 0.f;
  for (int ki = lo; ki <= hi; ++ki) {
    const int st = (ki - lo) & 1;
    if (ki < hi) load_kv(ki + 1, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile (and Q, dO) landed
    wg::fence_async_smem();
    __syncthreads();

    float sc[32], dp[32];
    wg::mma_fence();
    wg::mma_hd<HD>(sc, qs, k_tile(st));
    wg::mma_commit();
    wg::mma_hd<HD>(dp, dos, v_tile(st));
    wg::mma_commit();

    // masking only where the tile meets the diagonal, the window's edge
    // or the sequence's end
    const int k0 = ki * kTile;
    const bool edge =
        q0 + kTile > s || k0 + kTile > s ||
        (causal && (k0 + kTile - 1 > q0 ||
                    (window > 0 && q0 + kTile - 1 - k0 >= window)));
    wg::mma_wait<1>();  // S is done, dP may still run
    wg::fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(sc[i] * sl2 - lse2[r]);
      if (edge && !visible(row0 + 8 * r, k0 + wg::frag_col(i), s, causal,
                           window))
        p = 0.f;
      sc[i] = p;  // P
    }
    wg::mma_wait<0>();
    wg::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]);  // dS
    uint32_t dsa[16];
    wg::to_a<4>(dp, dsa);  // bf16 A operand

    wg::fence_regs(dsa);
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(dq_acc[p]);
    wg::mma_fence();
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wg::mma_rs_n128(dq_acc[p], dsa + 4 * kk,
                        wg::desc_mn(k_tile(st) + wg::kTileBytes * p, kk));
    wg::mma_commit();
    wg::mma_wait<0>();
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(dq_acc[p]);
    __syncthreads();  // stage st is consumed before the next refill
  }

  // Q was read for the last time above: its tiles hold the output
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    wg::stage_acc(qs + wg::kTileBytes * p, dq_acc[p], scale, scale);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    wg::store_tile(dq + q_off + 128 * p, q_row, s - q0,
                   qs + wg::kTileBytes * p);
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int b, int s, int n_q, int n_kv, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = fp32_smem_bytes<HD>();
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
  flash_dq_kernel<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int b, int s, int n_q, int n_kv, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = tc_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
  flash_dq_tc_kernel<HD><<<grid, wg::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); hd 128
// or 256. window <= 0 means none. Returns cudaGetLastError() after the
// launch.
extern "C" int kft_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int s, int n_q,
                                      int n_kv, int hd, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || n_kv < 1 || n_q % n_kv) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 128)
    return launch_fp32<128>(q, k, v, dout, lse, delta, dq, b, s, n_q, n_kv,
                            causal, window, scale, st);
  if (dtype == 0 && hd == 256)
    return launch_fp32<256>(q, k, v, dout, lse, delta, dq, b, s, n_q, n_kv,
                            causal, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dq, b, s, n_q, n_kv,
                            causal, window, scale, st);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256>(q, k, v, dout, lse, delta, dq, b, s, n_q, n_kv,
                            causal, window, scale, st);
  return cudaErrorInvalidValue;
}
