// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/flash_attention.py::_fwd_kernel (wrapper `_fwd`):
// blockwise online-softmax attention with GQA, causal or not, optional
// sliding window; returns o in the input dtype and the row logsumexp in
// fp32 as [b, n_q, s] (the TPU kernel's 128-lane replication of lse is a
// Pallas tiling constraint, not part of the function).
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 34.4 GFLOP of QK and PV products over
// the visible pairs against 50.6 MB moved (q, k, v read once, o and lse
// written once; 15 us at 3.35 TB/s), so operations bound it: 34.8 us at
// the bf16 tensor rate (989 TFLOP/s).
//
// Both kernels: one CUDA block per (query head, batch row, query tile:
// 64 rows in bf16, 128 in fp32) walks the relevant 64-key tiles in a
// loop (the Pallas kernel's sequential grid axis), carrying the row max
// m, the row sum l and the [rows, hd] accumulator in registers. Tiles
// above the causal diagonal and wholly older than the window are never
// visited. Any s works: the tail tile's rows past s are zero-filled and
// masked. A masked logit is the reference's finite NEG_INF, so a row
// whose first visited tile is all masked is washed out by the next
// tile's alpha. The heaviest query tiles (the last, under causal
// masking) are launched first.
//
// bf16 (the training path), on the tensor cores: one warpgroup per block.
// Q sits in shared memory as a swizzled bf16 tile (flash_wgmma.cuh); K
// and V tiles stream through a 2-stage cp.async ring, the next tile's
// copy overlapping this tile's products. S = Q K^T is 8 wgmma k-steps
// (m64n64k16, both operands in shared memory); the online softmax runs on
// the fp32 accumulator fragment (row max and sum over the 4 lanes of a
// row, exp2 of logits in log2 units); P is rounded to bf16 in registers
// and is the A operand of O += P V (4 k-steps of m64n128k16, V read
// MN-major in its natural [keys, hd] layout). No P tile goes through
// shared memory. 80 KB of shared memory a block, so two blocks share an
// SM. o leaves through shared memory in 16-byte stores. What held the
// first kernel (the fp32 one before its redesign, below) back: fp32
// products on the CUDA cores (67 TFLOP/s peak against 989), P
// round-tripped through shared memory with a barrier on each side,
// synchronous K/V loads, and 118 KB of fp32 tiles (one block an SM).
//
// Head dim 256 (gemma-2b: b 2, s 2048, n_q 8, n_kv 1; n_q hd is 2048 as
// at llama3-1b, so the same 34.4 GFLOP and bound): the bf16 kernel is a
// template on the head dim. The [64, 128] swizzled tile stays the unit,
// so a row of Q, K or V is two tiles (flash_wgmma.cuh's Operand), S
// chains 16 k-steps into one accumulator, and O is two m64n128
// accumulators sharing one bf16 P fragment (128 + 32 fp32 registers a
// thread). Q 32 KB and a 2-stage K/V ring of 64 KB a stage: 161 KB, one
// block an SM; the grid stays (query head, batch row, 64-query tile).
//
// fp32 (the CUDA cores; TF32 would round the products the reference's
// fp32 kernels take in full fp32), a template on the head dim: 128 and
// 256. Bound at gemma-2b's causal shape in fp32 (and at llama3-1b's: the
// same n_q hd): the 34.4 GFLOP over the card's 67 TFLOP/s of fp32 FMAs,
// 0.513 ms. The first fp32 kernel (64 query rows a block) lost its time
// to synchronous K and V loads between two barriers, a third barrier a
// key tile for P, 4 x 4 score micro-tiles (2 FMAs a loaded float) and
// masking and two expf on every score. Design:
// - 128 query rows a block as two warpgroups of 64, each with its own
//   row max m, lane partial sums l and [64, HD] accumulator; Q stays
//   resident (two padded [64, HD] tiles) and both warpgroups share every
//   K and V chunk, which stream through flash_fp32_ring.cuh's cp.async
//   ring: K as two [64, 32] column chunks a stage for S = Q K^T (HD / 64
//   stages a key tile), then V as stages of whole rows (32 at 128, 16 at
//   256) for O += P V, so every thread's accumulator takes part in every
//   chunk; the V stages are in flight during the softmax. One barrier a
//   chunk, 2048 FMAs a thread between two;
// - a thread owns an 8 x 4 score micro-tile (rows 8 apart, columns 16
//   apart) and an 8 x 8 (128) or 8 x 16 (256) O micro-tile on the same
//   rows; the 16 threads of a row group sit in one half-warp, so row max
//   and sum are shuffles and P crosses a warpgroup's own shared tile
//   under __syncwarp, not a block barrier;
// - under causal masking the two warpgroups' last key tiles differ by
//   one (with a window, their first ones may too): each skips the tiles
//   outside its own range and masks only the tiles edge_tile marks;
// - exp2 (ex2.approx) of logits pre-scaled by scale log2(e), lse
//   converted back as the bf16 kernel does; o leaves through the freed Q
//   tiles in 16-byte stores.
// 154 KB of shared memory at head dim 128, 218 KB at 256, one block of 8
// warps an SM (at 256 the 128 x 256 fp32 accumulator alone takes half
// the register file); the grid is (query head, batch row, 128-query
// block), the heaviest blocks first. On an H100 80GB HBM3 at 700 W:
// 1.05-1.06 ms at gemma-2b's shape (48-49% of the bound; the first kernel
// 1.24 in the same run), 1.00 at llama3-1b's (51%; 1.30). Slower there
// and not kept: at 128, two blocks an SM (Q streamed beside K in
// 16-column chunks, 90 KB, 128 registers with spills: 1.35 ms); skipping
// the accumulator rescale when no row max of a warp moved (no faster).
#include "flash_fp32_ring.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace kft_flash;
namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

// -- fp32 -------------------------------------------------------------------

constexpr int kBlockRows = 2 * kTile;  // query rows of an fp32 block

// 2^x on the special-function unit (relative error about 2^-22; exp2f
// adds a denormal-safe scaling around the same instruction, and p and
// alpha below 2^-126 are nothing beside the row's largest p, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Q resident, the ring and a P tile a warpgroup: 154 KB at head dim 128,
// 218 KB at 256 (one block an SM).
template <int HD>
constexpr size_t fp32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kHdTileFloats<HD> + 2 * kPTileFloats +
                          kRingStages * kStageFloats);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q,  // [b, s, n_q, hd]
                 const float* __restrict__ k,  // [b, s, n_kv, hd]
                 const float* __restrict__ v,
                 float* __restrict__ o,        // [b, s, n_q, hd]
                 float* __restrict__ lse,      // [b, n_q, s]
                 int s, int n_q, int n_kv, int causal, int window,
                 float scale) {
  constexpr int kKs = HD / (2 * kChunk);  // K stages a key tile
  constexpr int kVRows = kStageRows<HD>;  // V rows a stage
  constexpr int kVs = kTile / kVRows;     // V stages a key tile
  constexpr int kIters = kKs + kVs;       // ring chunks a key tile
  constexpr int kCols = HD / 64;          // float4 columns of O a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [128, HD]: two [64, HD] tiles
  float* ring_base = qs + 2 * kHdTileFloats<HD>;
  // warpgroup grp: query rows 64 grp + [0, 64); thread t of it: rows
  // rg + 8 i, score columns cg + 16 j, O columns 64 c + 4 cg + [0, 4)
  const int grp = threadIdx.x / 128;
  const int rg = threadIdx.x % 128 / 16, cg = threadIdx.x % 16;
  const float* qw_s = qs + grp * kHdTileFloats<HD>;
  float* ps = ring_base + kRingStages * kStageFloats + grp * kPTileFloats;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nb = (s + kBlockRows - 1) / kBlockRows;
  const int q0 = (nb - 1 - blockIdx.z) * kBlockRows;  // heaviest first
  const int qw = q0 + grp * kTile;        // the warpgroup's first row
  const int nk = (s + kTile - 1) / kTile;
  const int hk = h / (n_q / n_kv);
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
  const size_t kv_head = (size_t)b * s * kv_row + (size_t)hk * HD;
  // the block walks the union of the warpgroups' key tiles: from the
  // first's lo to the last (with rows)'s hi; a warpgroup without rows
  // skips them all
  int lo, hi, wlo, whi, unused;
  key_tiles(q0, nk, causal, window, &lo, &hi);
  if (q0 + kTile < s) key_tiles(q0 + kTile, nk, causal, window, &unused, &hi);
  key_tiles(qw, nk, causal, window, &wlo, &whi);
  if (qw >= s) whi = -1;
  // chunk J: key tile lo + J / kIters; for r = J % kIters < kKs its K
  // columns [64 r, 64 r + 64), else its V rows [kVRows (r - kKs), +
  // kVRows)
  auto issue = [&](int J, float* st) {
    const int k0 = (lo + J / kIters) * kTile;
    const int r = J % kIters;
    const size_t off = kv_head + (size_t)k0 * kv_row;
    if (r < kKs) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        load_async<kTile, kChunk>(st + c * kTile * kCStride, kCStride,
                                  k + off + (2 * r + c) * kChunk, kv_row,
                                  s - k0);
    } else {
      const int r0 = (r - kKs) * kVRows;
      const int valid = s - k0 - r0;  // <= 0: zeros, from the tile's row 0
      load_async<kVRows, HD>(st, kStride<HD>,
                             v + off + (valid > 0 ? r0 * kv_row : 0), kv_row,
                             valid);
    }
  };
  load_async<kBlockRows, HD>(qs, kStride<HD>, q + q_off, q_row, s - q0);
  ChunkRing<decltype(issue)> ring{ring_base, (hi - lo + 1) * kIters, issue};
  ring.start();

  const float sl2 = scale * wg::kLog2e;  // logits in log2 units
  float m[8], l[8], acc[8][4 * kCols];   // l: this lane's partial sums
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * kTile;
    const bool on = ki >= wlo && ki <= whi;  // the same in a warpgroup
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
    // S = Q K^T, 64 head-dim columns a stage
#pragma unroll 1
    for (int c = 0; c < kKs; ++c) {
      const float* st = ring.next();
      if (!on) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* kb = st + half * kTile * kCStride;
        const float* qb = qw_s + (2 * c + half) * kChunk;
#pragma unroll
        for (int d = 0; d < kChunk; d += 4) {
          float4 bk[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bk[j] = ld4(kb + (cg + 16 * j) * kCStride + d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = ld4(qb + (rg + 8 * i) * kStride<HD> + d);
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
    }
    if (on) {  // online softmax; P into the warpgroup's tile
      const bool edge = edge_tile(qw, k0, s, causal, window);
      float alpha[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float y = x[i][j] * sl2;
          if (edge && !visible(qw + r, k0 + cg + 16 * j, s, causal, window))
            y = kNegInf;
          x[i][j] = y;
          mx = fmaxf(mx, y);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ex2(x[i][j] - m_new);
          sum += p;
          ps[r * kPStride + cg + 16 * j] = p;
        }
        l[i] = l[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha[i];
      __syncwarp();  // a row group's P is its own half-warp's
    }
    // O += P V, kVRows keys a stage
#pragma unroll 1
    for (int c = 0; c < kVs; ++c) {
      const float* vt = ring.next() + 4 * cg;
      if (!on) continue;
      const float* pc = ps + c * kVRows;
#pragma unroll 2
      for (int kk = 0; kk < kVRows; kk += 4) {
        float4 p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = ld4(pc + (rg + 8 * i) * kPStride + kk);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            const float4 v4 = ld4(vt + (kk + rr) * kStride<HD> + 64 * cc);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float pv = rr == 0 ? p[i].x : rr == 1 ? p[i].y
                             : rr == 2 ? p[i].z : p[i].w;
              const int a = 4 * cc;
              acc[i][a] = fmaf(pv, v4.x, acc[i][a]);
              acc[i][a + 1] = fmaf(pv, v4.y, acc[i][a + 1]);
              acc[i][a + 2] = fmaf(pv, v4.z, acc[i][a + 2]);
              acc[i][a + 3] = fmaf(pv, v4.w, acc[i][a + 3]);
            }
          }
        }
      }
    }
  }
  kft_wgmma::cp_async_wait<0>();

  const size_t stat = ((size_t)b * n_q + h) * s;
  // Q was last read before the last V stage's barrier: its tiles hold o
  float* ow = qs + grp * kHdTileFloats<HD> + 4 * cg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg + 8 * i;
    const float sum = row_sum(l[i]);
    const float safe_l = sum == 0.f ? 1.f : sum;
    const float inv = 1.f / safe_l;
    if (cg == 0 && qw + r < s)
      lse[stat + qw + r] = m[i] * wg::kLn2 + logf(safe_l);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      *reinterpret_cast<float4*>(ow + r * kStride<HD> + 64 * cc) =
          make_float4(acc[i][4 * cc] * inv, acc[i][4 * cc + 1] * inv,
                      acc[i][4 * cc + 2] * inv, acc[i][4 * cc + 3] * inv);
  }
  __syncthreads();
  constexpr int kPerRow = HD / 4;  // 16-byte stores a row
  for (int n = threadIdx.x; n < kBlockRows * kPerRow; n += kThreads) {
    const int r = n / kPerRow, e = (n % kPerRow) * 4;
    if (q0 + r < s)
      *reinterpret_cast<float4*>(o + q_off + r * q_row + e) =
          ld4(qs + r * kStride<HD> + e);
  }
}

// -- bf16: tensor cores -----------------------------------------------------

constexpr int kStages = 2;  // K/V ring

// Shared memory at head dim HD: Q, then kStages x (K, V), each an
// Operand<HD> (HD / 128 swizzled tiles); 1 KB of slack for the 1024-byte
// alignment. 81 KB at 128 (two blocks an SM), 161 KB at 256 (one).
template <int HD>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)wg::Operand<HD>::kBytes * (1 + 2 * kStages);
}

template <int HD>
__global__ void __launch_bounds__(wg::kThreads, HD == 128 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q,  // [b, s, n_q, hd]
                    const bf16* __restrict__ k,  // [b, s, n_kv, hd]
                    const bf16* __restrict__ v,
                    bf16* __restrict__ o,        // [b, s, n_q, hd]
                    float* __restrict__ lse,     // [b, n_q, s]
                    int s, int n_q, int n_kv, int causal, int window,
                    float scale) {
  constexpr int kParts = wg::Operand<HD>::kParts;
  constexpr uint32_t kOpBytes = wg::Operand<HD>::kBytes;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t qs = wg::align_1k(tc_smem);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.z) * kTile;  // heaviest tiles first
  const int hk = h / (n_q / n_kv);
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
  const size_t kv_head = (size_t)b * s * kv_row + (size_t)hk * HD;
  auto k_tile = [&](int st) { return qs + kOpBytes * (1 + 2 * st); };
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
  load_kv(lo, 0);
  wg::cp_async_commit();

  const float sl2 = scale * wg::kLog2e;  // logits in log2 units
  const int row0 = q0 + wg::frag_row(0);  // this thread's rows: +0, +8
  // O's parts: acc[p] holds head-dim columns [128 p, 128 p + 128)
  float acc[kParts][64];
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: lane partials
  for (int ki = lo; ki <= hi; ++ki) {
    const int st = (ki - lo) & 1;
    if (ki < hi) load_kv(ki + 1, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile (and Q) landed
    wg::fence_async_smem();
    __syncthreads();

    float sc[32];
    wg::mma_fence();
    wg::mma_hd<HD>(sc, qs, k_tile(st));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(sc);

    // masking only where the tile meets the diagonal, the window's edge
    // or the sequence's end
    const int k0 = ki * kTile;
    const bool edge =
        k0 + kTile > s ||
        (causal && (k0 + kTile - 1 > q0 ||
                    (window > 0 && q0 + kTile - 1 - k0 >= window)));
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * sl2;
      if (edge && !visible(row0 + 8 * r, k0 + wg::frag_col(i), s, causal,
                           window))
        x = kNegInf;
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
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

    // O += P V: one m64n128 product a part, sharing P
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(acc[p]);
    wg::fence_regs(pa);
    wg::mma_fence();
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wg::mma_rs_n128(acc[p], pa + 4 * kk,
                        wg::desc_mn(v_tile(st) + wg::kTileBytes * p, kk));
    wg::mma_commit();
    wg::mma_wait<0>();
#pragma unroll
    for (int p = 0; p < kParts; ++p) wg::fence_regs(acc[p]);
    __syncthreads();  // stage st is consumed before the next refill
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = wg::quad_sum(l[r]);
    const float safe_l = sum == 0.f ? 1.f : sum;
    inv[r] = 1.f / safe_l;
    const int qp = row0 + 8 * r;
    if ((threadIdx.x & 3) == 0 && qp < s)
      lse[((size_t)b * n_q + h) * s + qp] = m[r] * wg::kLn2 + logf(safe_l);
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p)  // Q's tiles are free now
    wg::stage_acc(qs + wg::kTileBytes * p, acc[p], inv[0], inv[1]);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    wg::store_tile(o + q_off + 128 * p, q_row, s - q0,
                   qs + wg::kTileBytes * p);
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int s, int n_q, int n_kv, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = fp32_smem_bytes<HD>();
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kBlockRows - 1) / kBlockRows);
  flash_fwd_kernel<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int s, int n_q, int n_kv, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = tc_smem_bytes<HD>();
  // once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
  flash_fwd_tc_kernel<HD><<<grid, wg::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); hd 128
// or 256. window <= 0 means none (and is ignored unless
// causal). Returns cudaGetLastError() after the launch.
extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int s, int n_q, int n_kv,
                                       int hd, int causal, int window,
                                       float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || n_kv < 1 || n_q % n_kv) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 128)
    return launch_fp32<128>(q, k, v, o, lse, b, s, n_q, n_kv, causal,
                            window, scale, st);
  if (dtype == 0 && hd == 256)
    return launch_fp32<256>(q, k, v, o, lse, b, s, n_q, n_kv, causal,
                            window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, lse, b, s, n_q, n_kv, causal,
                            window, scale, st);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256>(q, k, v, o, lse, b, s, n_q, n_kv, causal,
                            window, scale, st);
  return cudaErrorInvalidValue;
}
