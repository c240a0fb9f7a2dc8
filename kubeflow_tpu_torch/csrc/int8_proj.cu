// Weight-only int8 projection for Hopper (sm_90a), one to three weights
// that read the same activations in one launch:
//
//     y_g[M, N_g] = (h[M, K] @ q_g[K, N_g]) * scale_g[N_g],   g < G <= 3
//
// with bf16 activations h (row stride lda), int8 weights q_g in the
// reference's [in, out] layout (row-major, out contiguous), a bf16
// per-output-channel scale, fp32 accumulation and a bf16 result rounded
// once, after the scale. A layer's products go out as four launches:
// (wq, wk, wv) and (w_gate, w_up) grouped, wo and w_down alone.
//
// Replaces no Pallas kernel: it is the card's counterpart of
// kubeflow_tpu/serving/quant.py::qdot, where XLA fuses the int8 -> bf16
// convert into the dot's operand read so that device memory sees int8.
// PyTorch fuses nothing: `h @ q.to(bf16)` reads the int8 weight, writes a
// bf16 copy and reads it again, about 2.5x the bf16 product's bytes.
//
// Bound on this card: at decode (M = live rows, <= 8) and the spec verify
// (M = 40) the weight's K x N bytes, at 3.35 TB/s (2 M flops a weight byte
// against the ~295 at which the bf16 tensor cores would bind); a prefill
// (M in the hundreds and thousands) is bound by its 2 M N K flops at 989
// TFLOP/s.
//
// What held the first design back (one mma.sync kernel for every M): each
// 64-row M tile converted its whole int8 weight tile to bf16 again, inside
// the block that then multiplied it, serialised against the mma.sync loop
// by two __syncthreads; 87 KB of shared memory let two blocks share an SM;
// mma.sync m16n8k16 cannot reach wgmma's rate; and a split product was
// two launches (tile, then a combine), which held the small products (wk,
// wv: 4 MB) to 16.5% of their bound. At prefill sizes it ran at 10-17% of
// the bound, 4-7x slower than bf16 torch.matmul.
//
// Now the product is transposed on both paths, y^T = q^T h^T: the weights
// are the tensor cores' A operand, which both mma.sync and wgmma read from
// registers, so each thread converts the int8 bytes it multiplies
// (ldmatrix.trans of the bytes, an exact prmt-and-bf16x2 subtraction) and
// nothing converted goes through shared memory; h is the B operand.
// `plan` picks the path from the shape and the SM count alone (so CUDA
// graphs capture it):
//
// - M <= 16 (decode): mma.sync, a 16 x 128 tile (n8 tiles of h rows, the
//   second skipped below 9 rows) streaming its weight through a 6-stage
//   cp.async ring, 128 threads.
// - 17 <= M <= 512 (the spec verify, slices, prefill probes): wgmma
//   m64n64k16, a 64 x 128 tile: one producer warp keeps a 4-slot ring of
//   TMA copies in flight (cp.async.bulk.tensor on mbarriers; tensor maps
//   encoded per call through cudaGetDriverEntryPoint ->
//   cuTensorMapEncodeTiled), h [64][64] 128-byte swizzled K-major as the B
//   operand, the int8 tile [64][128] swizzled beside it; two consumer
//   warpgroups each own 64 weight columns and convert step i + 1's
//   weights while step i's RS products run. Two blocks an SM.
// - M > 512: the same kernel with 256-row tiles (m64n256k16), one an SM.
//
// Converting in the consumers keeps the converted weights out of shared
// memory: a producer warpgroup converting each stage into a swizzled bf16
// tile for SS products would add a 16 KB store and a 16 KB load a stage.
//
// Split-K on both paths is one launch: the S blocks that share an output
// tile are a thread-block cluster along K (up to 16, a non-portable
// cluster size), and each weight keeps the split it has alone (clusters
// sized by the group's largest split and packed with sub-groups), so a
// grouped product is bit-identical to the same product launched alone.
// The reduction sums the ranks' fp32 partials in rank order (K order),
// scales and rounds once; no workspace, no second launch, no float
// atomics, no counter for a graph replay to reset. On the mma.sync path
// each rank pushes its partial from registers into the owner's shared
// memory with st.async, completing bytes on the owner's mbarrier; on the
// wgmma paths, whose partials are four to sixteen times larger (st.async
// would complete thousands of float4 on the owner's one barrier), the
// owner pulls them through distributed shared memory between two cluster
// barriers.
#include <cuda.h>   // CUtensorMap (types only: the driver is reached through
                    // cudaGetDriverEntryPoint, nothing links against it)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // K of one pipeline stage (both paths)
constexpr int kBN = 128;         // output columns of a tile (both paths)
constexpr int kMaxGroup = 3;     // weights of one grouped call
constexpr int kMaxCluster = 16;  // split-K blocks of a cluster: past the
                                 // portable 8, by opt-in (H100 takes 16)
constexpr int kSmallMax = 16;    // rows the mma.sync path serves
constexpr int kN64Max = 512;     // rows the 64-row wgmma tile serves

// One call's weights. Weight g splits K over splits[g] blocks (its split
// alone) and owns the clusters [clusters[g], clusters[g + 1]) of the
// grid; a cluster holds the group's largest split.
struct Group {
  const int8_t* q[kMaxGroup];
  const bf16* scale[kMaxGroup];
  bf16* y[kMaxGroup];
  int n[kMaxGroup];
  int splits[kMaxGroup];
  int clusters[kMaxGroup + 1];
};

// element g of a kernel parameter's array, by selects (no local copy)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxGroup], int g) {
  return g == 2 ? a[2] : g == 1 ? a[1] : a[0];
}

__device__ __forceinline__ uint32_t cluster_dim() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// A block's work: the (BM x 128) output tile of its weight and the K
// steps of its split. Block x is rank r = x % SC of cluster c = x / SC
// (SC the cluster size); cluster c belongs to weight g, whose S splits
// cut the cluster into SC / S sub-groups of S blocks: sub-group j takes
// tile c' (SC / S) + j of the weight (c' its cluster index among the
// weight's; M tile fastest, so the M tiles of one weight tile run close
// in time), and its rank z the K steps [z per, (z + 1) per), per =
// ceil(steps / S), exactly as the weight alone would. A sub-group past
// the weight's last tile, and the blocks past the last whole sub-group,
// idle.
struct Work {
  const int8_t* q;
  const bf16* scale;
  bf16* y;
  int g, n, n0, m0, rows;   // rows: the tile's rows below M (0: idle)
  int S, z, base;           // the split, this rank in it, its first rank
  int kt0, n_iter;
  int Q;                    // float4 of the partial's valid rows
};

template <int BM>
__device__ __forceinline__ Work locate(const Group& grp, int M, int k_steps) {
  Work w;
  const int SC = (int)cluster_dim();
  const int cl = blockIdx.x / SC, r = blockIdx.x % SC;
  w.g = cl >= grp.clusters[2] ? 2 : cl >= grp.clusters[1] ? 1 : 0;
  w.q = pick(grp.q, w.g);
  w.scale = pick(grp.scale, w.g);
  w.y = pick(grp.y, w.g);
  w.n = pick(grp.n, w.g);
  w.S = pick(grp.splits, w.g);
  const int m_tiles = (M + BM - 1) / BM;
  const int first = w.g == 2 ? grp.clusters[2] : w.g == 1 ? grp.clusters[1] : 0;
  const int tile = (cl - first) * (SC / w.S) + r / w.S;
  w.z = r % w.S;
  w.base = r - w.z;
  const bool active = tile < m_tiles * (w.n / kBN) && r < SC / w.S * w.S;
  w.m0 = (tile % m_tiles) * BM;
  w.n0 = (tile / m_tiles) * kBN;
  const int per = (k_steps + w.S - 1) / w.S;
  w.kt0 = w.z * per;
  w.n_iter = active ? min(per, k_steps - w.kt0) : 0;
  w.rows = active ? min(BM, M - w.m0) : 0;
  w.Q = w.rows * (kBN / 4);
  return w;
}

// -- weights as an mma operand, converted in registers ----------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two int8 (bytes `sel` picks from w) -> one bf16x2, exact: with l the
// low 7 bits and s the sign bit of a byte x, 128 + l has the bf16 bits
// 0x4300 | l and 128 + 128 s the bits 0x4300 | (x & 0x80), and their
// difference, l - 128 s, is x (bf16 holds every integer of [-128, 128]).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w,
                                                     uint32_t sel) {
  const uint32_t b = __byte_perm(w, 0, sel);   // 0x00yy00xx
  const uint32_t v = (b & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (b & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(c));
  return r;
}

// A warp's A fragments (4 k-steps of 16 x 4 registers, the layout of
// mma.sync m16n8k16 and of one warp's rows of a wgmma m64 product) for
// the 16 weight columns of chunk `chunk` of a 64-row int8 stage at `raw`
// ([64][128] bytes, row k's 16-byte chunks permuted as c ^ (k % 8): the
// 128-byte swizzle, which TMA writes and under which the 8 rows an
// ldmatrix reads meet every bank once). ldmatrix.trans of the bytes as
// b16 gives lane (g = lane / 4, c = lane % 4) the bytes q[2c][2g],
// q[2c][2g + 1], q[2c + 1][2g], q[2c + 1][2g + 1] of each 8-row group, so
// the fragment's row g holds column 2g and row g + 8 column 2g + 1: D's
// rows come out in that order, which the epilogues undo.
__device__ __forceinline__ void load_a(uint32_t (&a)[16], uint32_t raw,
                                       int chunk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {   // K rows 32 half .. + 31
    const int k = 32 * half + lane;
    uint32_t r[4];
    ldsm_x4_trans(r, raw + k * kBN + ((chunk ^ (k & 7)) << 4));
#pragma unroll
    for (int m = 0; m < 4; ++m) {   // K rows 8 m .. 8 m + 7 of the half
      const int kk = 2 * half + (m >> 1), hi = m & 1;
      a[4 * kk + 2 * hi] = int8x2_to_bf16x2(r[m], 0x4240);      // row g
      a[4 * kk + 2 * hi + 1] = int8x2_to_bf16x2(r[m], 0x4341);  // g + 8
    }
  }
}

// -- the split-K exchange ---------------------------------------------------
//
// The S blocks that split a tile's K are ranks of one thread-block
// cluster. The Q float4 of the tile's valid rows are dealt to them in S
// contiguous slices, slice o = [ceil(o Q / S), ceil((o + 1) Q / S)); rank
// o adds slice o of the S partials in rank order 0..S-1 (K order), scales
// and rounds once. The push form (mma.sync): each rank sends its fp32
// partial of slice o from registers into rank o's receive buffer, row z
// (its own rank), with st.async, whose bytes complete on rank o's receive
// barrier. The pull form (wgmma): `pull_slice`.

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Every thread of the cluster arrives (release), then waits (acquire).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}
// The address of the same shared-memory offset in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// One arrival that also expects `bytes` of transactions on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// A float4 into another block's shared memory, completing its 16 bytes
// on that block's barrier `bar` (no fence: the barrier's phase carries
// the data).
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
               ".v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
                  "r"(bar) : "memory");
}
// Wait (acquire at cluster scope) for phase 0 of a barrier that other
// blocks of the cluster complete.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                 "p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar) : "memory");
  } while (!done);
}

// Float4 of a slice, at most; the first of slice o.
__device__ __forceinline__ int slice_cap(const Work& w) {
  return (w.Q + w.S - 1) / w.S;
}
__device__ __forceinline__ int slice_lo(const Work& w, int o) {
  return (o * w.Q + w.S - 1) / w.S;
}

// (no "memory" clobber: the loads of a reduction issue back to back; the
// cluster barriers around it order them)
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// The pull form of the exchange, where a rank's partial is too large for
// one barrier to count its float4 (the wgmma tiles): every rank of the
// sub-group leaves its fp32 partial tile [rows][128] (row stride PS
// floats) at shared address `part`, the same offset in every block; after
// a cluster barrier, rank z reads slice z of all S partials through
// distributed shared memory in rank order, sums, scales, rounds once and
// stores; a second barrier keeps every partial until all are read.
// Threads tid of nthreads; S <= MAXS.
template <int PS, int MAXS>
__device__ __forceinline__ void pull_slice(uint32_t part, const Work& w,
                                           int tid, int nthreads) {
  const int lo = slice_lo(w, w.z), hi = slice_lo(w, w.z + 1);
  for (int qi = lo + tid; qi < hi; qi += nthreads) {
    const int rr = qi / (kBN / 4), col = 4 * (qi % (kBN / 4));
    const uint32_t off = part + (uint32_t)(rr * PS + col) * 4u;
    float4 v[MAXS];   // every load in flight before the first add
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < w.S) v[i] = ld_cluster4(map_rank(off, (uint32_t)(w.base + i)));
    float4 s4 = v[0];
#pragma unroll
    for (int i = 1; i < MAXS; ++i) {
      if (i >= w.S) break;
      s4.x += v[i].x;
      s4.y += v[i].y;
      s4.z += v[i].z;
      s4.w += v[i].w;
    }
    const int n = w.n0 + col;
    const __nv_bfloat162 o0 = __floats2bfloat162_rn(
        s4.x * __bfloat162float(w.scale[n]),
        s4.y * __bfloat162float(w.scale[n + 1]));
    const __nv_bfloat162 o1 = __floats2bfloat162_rn(
        s4.z * __bfloat162float(w.scale[n + 2]),
        s4.w * __bfloat162float(w.scale[n + 3]));
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&o0);
    o.y = *reinterpret_cast<const uint32_t*>(&o1);
    *reinterpret_cast<uint2*>(w.y + (size_t)(w.m0 + rr) * w.n + n) = o;
  }
}

// Before the main loop, by one thread: the receive barrier expects this
// rank's slice from each of the S ranks. The cluster barrier that
// follows (arrive now, wait before sending) makes it ready before any
// rank sends.
__device__ __forceinline__ void split_init(uint32_t bar, const Work& w) {
  wg::mbar_init(bar, 1);
  wg::fence_mbar_init();
  mbar_expect_tx(bar, (uint32_t)(w.S * (slice_lo(w, w.z + 1) -
                                        slice_lo(w, w.z)) * 16));
}

// An accumulator fragment of mma m16n8 or of one warp's n8 columns of a
// wgmma m64 (d[e]: row row0 + e % 2, weight column col + e / 2 of the
// tile; row0 = 8 nt + 2 (lane % 4), col even), sent as float4: lanes g and
// g ^ 1 swap halves, so an even g holds row row0's columns col .. col +
// 3 and an odd g row row0 + 1's col - 2 .. col + 1. Every lane of the
// warp calls it (the shuffles).
__device__ __forceinline__ void send_frag(uint32_t recv, uint32_t bar,
                                          const Work& w, const float* d,
                                          int row0, int col) {
  const int lane = threadIdx.x & 31;
  const bool odd = (lane >> 2) & 1;
  const float sx = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[1], 4);
  const float sy = __shfl_xor_sync(0xffffffffu, odd ? d[2] : d[3], 4);
  const int rr = row0 + (odd ? 1 : 0);
  if (rr >= w.rows) return;
  const float4 f = odd ? make_float4(sx, sy, d[1], d[3])
                       : make_float4(d[0], d[2], sx, sy);
  const int qi = rr * (kBN / 4) + (col - (odd ? 2 : 0)) / 4;
  const int o = qi * w.S / w.Q;
  const uint32_t rank = (uint32_t)(w.base + o);
  st_async4(map_rank(recv + (uint32_t)(w.z * slice_cap(w) + qi -
                                       slice_lo(w, o)) * 16u, rank),
            f, map_rank(bar, rank));
}

// This rank's slice, once its receive barrier completes: the S rows
// summed in rank order (every load in flight before the first add),
// scaled, rounded once, stored. Threads tid of nthreads.
__device__ __forceinline__ void reduce_slice(const float4* in, uint32_t bar,
                                             const Work& w, int tid,
                                             int nthreads) {
  const int lo = slice_lo(w, w.z), hi = slice_lo(w, w.z + 1);
  const int cap = slice_cap(w);
  auto scales = [&](int qi, float (&sc)[4]) {
    const int n = w.n0 + 4 * (qi % (kBN / 4));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[e] = qi < hi ? __bfloat162float(w.scale[n + e]) : 0.f;
  };
  float sc[4];
  scales(lo + tid, sc);   // the first scales before the wait
  mbar_wait_cluster(bar);
  for (int qi = lo + tid; qi < hi; qi += nthreads) {
    float4 v[kMaxCluster];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < w.S) v[i] = in[i * cap + qi - lo];
    float nsc[4];
    scales(qi + nthreads, nsc);
    float4 s4 = v[0];
#pragma unroll
    for (int i = 1; i < kMaxCluster; ++i) {
      if (i >= w.S) break;
      s4.x += v[i].x;
      s4.y += v[i].y;
      s4.z += v[i].z;
      s4.w += v[i].w;
    }
    const int rr = qi / (kBN / 4), n = w.n0 + 4 * (qi % (kBN / 4));
    const __nv_bfloat162 o0 = __floats2bfloat162_rn(s4.x * sc[0], s4.y * sc[1]);
    const __nv_bfloat162 o1 = __floats2bfloat162_rn(s4.z * sc[2], s4.w * sc[3]);
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&o0);
    o.y = *reinterpret_cast<const uint32_t*>(&o1);
    *reinterpret_cast<uint2*>(w.y + (size_t)(w.m0 + rr) * w.n + n) = o;
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = nsc[e];
  }
}

// An unsplit tile's fragment (send_frag's layout), scaled and stored.
__device__ __forceinline__ void store_frag(const Work& w, const float* d,
                                           int row0, int col, float s0,
                                           float s1) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (row0 + e < w.rows)
      *reinterpret_cast<__nv_bfloat162*>(
          w.y + (size_t)(w.m0 + row0 + e) * w.n + w.n0 + col) =
          __floats2bfloat162_rn(d[e] * s0, d[2 + e] * s1);
}

// -- small M: mma.sync ------------------------------------------------------
//
// The product transposed, as on the wgmma path: y^T = q^T h^T, the
// weights mma.sync's A operand (m16: 16 weight columns, converted in
// registers) and h its B operand (n8: 8 rows). A block of 4 warps owns a
// 16 x 128 tile: warp w the weight columns 32 w .. 32 w + 31 (two m16
// tiles) by the 16 rows (two n8 tiles, the second skipped below 9 rows).

constexpr int kThreads = 128;
constexpr int kSM = 16;                            // rows of a tile
constexpr int kSStages = 6;                        // cp.async ring
constexpr int kSAStride = kBK + 8;                 // bf16 a row of h
constexpr int kSAStage = kSM * kSAStride * 2;      // bytes
constexpr int kSQStage = kBK * kBN;                // bytes, swizzled
constexpr int kSRing = kSStages * (kSAStage + kSQStage);
// the partials a block receives: S slices of ceil(Q / S) float4
constexpr int kSRecv = (kSM * kBN / 4 + kMaxCluster) * 16;
constexpr int kSSmem = kSRing + kSRecv + 8;        // + its barrier

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (16 x 128) output tile over one K split (`locate`), streaming its
// weight through a 6-stage cp.async ring; the receive buffer lies past
// the ring, so a rank may send while another is still in its loop.
__global__ void __launch_bounds__(kThreads)
int8_proj_mma_kernel(const bf16* __restrict__ h, int lda, Group grp, int M,
                     int k_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t a_st = wg::smem_u32(smem);                 // kSStages x h
  const uint32_t q_st = a_st + kSStages * kSAStage;         // kSStages x q
  const uint32_t recv = a_st + kSRing;                      // S x slice
  const uint32_t recv_bar = recv + kSRecv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Work w = locate<kSM>(grp, M, k_steps);
  const bool clustered = cluster_dim() > 1;

  if (clustered) {
    if (tid == 0 && w.S > 1) split_init(recv_bar, w);
    cluster_arrive_relaxed();
  }
  // the scales of an unsplit tile's columns, ahead of the loop
  float sc[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sc[j][e] = w.S == 1 && w.rows > 0
                     ? __bfloat162float(
                           w.scale[w.n0 + 32 * warp + 16 * j +
                                   2 * (lane >> 2) + e])
                     : 0.f;

  auto load_stage = [&](int stage, int kt) {
    // h: 16 rows x 8 chunks of 16 bytes (zeros past M)
    const uint32_t a_dst = a_st + stage * kSAStage;
    {
      const int rr = tid >> 3, cc = tid & 7;
      const int m = w.m0 + rr;
      const bf16* src = h + (size_t)(m < M ? m : 0) * lda + kt * kBK + cc * 8;
      wg::cp_async16(a_dst + (rr * kSAStride + cc * 8) * 2, src,
                     m < M ? 16 : 0);
    }
    // q: 64 rows x 8 chunks of 16 int8, swizzled
    const uint32_t q_dst = q_st + stage * kSQStage;
#pragma unroll
    for (int c = tid; c < kBK * 8; c += kThreads) {
      const int rr = c >> 3, cc = c & 7;
      const int8_t* src = w.q + (size_t)(kt * kBK + rr) * w.n + w.n0 + cc * 16;
      wg::cp_async16(q_dst + rr * kBN + ((cc ^ (rr & 7)) << 4), src, 16);
    }
  };

  float acc[2][2][4];   // [m16 tile j][n8 tile nt][fragment]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kSStages - 1; ++st) {
    if (st < w.n_iter) load_stage(st, w.kt0 + st);
    wg::cp_async_commit();
  }
  for (int it = 0; it < w.n_iter; ++it) {
    const int stage = it % kSStages;
    wg::cp_async_wait<kSStages - 2>();
    // stage `it` has landed for every thread, and every thread is done
    // with the stage refilled below
    __syncthreads();
    if (it + kSStages - 1 < w.n_iter)
      load_stage((it + kSStages - 1) % kSStages, w.kt0 + it + kSStages - 1);
    wg::cp_async_commit();

    const uint32_t q_src = q_st + stage * kSQStage;
    const uint32_t a_src = a_st + stage * kSAStage;
    uint32_t a[2][16];
    load_a(a[0], q_src, 2 * warp);
    load_a(a[1], q_src, 2 * warp + 1);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (8 * nt >= w.rows) break;   // an n8 tile past M: nothing to add
#pragma unroll
      for (int p = 0; p < 2; ++p) {   // k-steps 2p, 2p + 1
        // rows 8 nt + lane % 8, K columns 32 p + 8 (lane / 8) ..
        uint32_t b[4];
        ldsm_x4(b, a_src + ((8 * nt + (lane & 7)) * kSAStride + 32 * p +
                            8 * (lane >> 3)) * 2);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[j][nt], a[j] + 8 * p, b[0], b[1]);
          mma_bf16(acc[j][nt], a[j] + 8 * p + 4, b[2], b[3]);
        }
      }
    }
  }
  wg::cp_async_wait<0>();

  // acc[j][nt][e]: row 8 nt + 2 (lane % 4) (+ 1 for e odd), weight column
  // 32 warp + 16 j + 2 (lane / 4) (+ 1 for e >= 2)
  if (w.S == 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        store_frag(w, acc[j][nt], 8 * nt + 2 * (lane & 3),
                   32 * warp + 16 * j + 2 * (lane >> 2), sc[j][0], sc[j][1]);
    if (clustered) cluster_wait();
    return;
  }
  cluster_wait();   // every receive barrier of the cluster is ready
  if (w.rows == 0) return;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      send_frag(recv, recv_bar, w, acc[j][nt], 8 * nt + 2 * (lane & 3),
                32 * warp + 16 * j + 2 * (lane >> 2));
  reduce_slice(reinterpret_cast<const float4*>(smem + kSRing), recv_bar, w,
               tid, kThreads);
}

// -- wgmma: weights converted in registers ----------------------------------
//
// The product transposed: y^T [N, M] = q^T [N, K] h^T [K, M]. A block
// owns 128 output columns (two consumer warpgroups of 64, the wgmma M)
// by BMH rows (the wgmma N: 256, or 64 for tens of rows): the weights are
// wgmma's A operand, converted in registers, and h is its B operand,
// K-major in shared memory as TMA lands it.
constexpr int kLCopies = 4;  // ring of copied stages (h, int8)
constexpr int kLThreads = 2 * wg::kThreads + 32;   // 2 consumers + a
                                                  // producer warp
constexpr uint32_t kLRaw = kBK * kBN;        // int8 tile [64][128], swizzled
template <int BMH>
struct Large {
  static constexpr uint32_t kH = BMH * kBK * 2;     // h tile, K-major
  static constexpr uint32_t kRawOff = kLCopies * kH;
  static constexpr uint32_t kBars = kRawOff + kLCopies * kLRaw;
  // free and landed of each copy slot
  static constexpr int kSmem = kBars + 2 * kLCopies * 8 + 1024;
  static constexpr int kPartStride = kBN + 8;       // floats
  static_assert(BMH * kPartStride * 4 <= (int)kBars,
                "the partial tile fits over the ring");
  // a 256-row tile splits at most 8 ways (its plan), a 64-row one 16
  static constexpr int kMaxS = BMH == 256 ? 8 : kMaxCluster;
};

// The tensor maps of a call: h [M, K] bf16 in boxes of [BMH][64] and each
// weight [K, N_g] int8 in boxes of [64][128], both 128-byte swizzled.
struct Maps {
  CUtensorMap h;
  CUtensorMap q[kMaxGroup];
};

// One TMA copy of the box at (c0 inner, c1 outer) into shared `dst`,
// completing its bytes on barrier `bar`'s transaction (zeros past the
// edge).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// One (BMH rows x 128 columns) output tile over one K split (`locate`).
// One producer warp copies step i's h and int8 tiles into copy slot i %
// 4 (TMA, up to four steps ahead). Each consumer warpgroup converts its
// half of step i + 1's weights into registers while its products of step
// i run. The 64-row kernel is held to two blocks an SM (96 registers).
template <int BMH>
__global__ void __launch_bounds__(kLThreads, BMH == 64 ? 2 : 1)
int8_proj_wgmma_kernel(const bf16* __restrict__ h, int lda, Group grp,
                       int M, int k_steps,
                       const __grid_constant__ Maps maps) {
  using L = Large<BMH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = wg::align_1k(smem);
  const uint32_t copy_free = base + L::kBars;         // copy slot free
  const uint32_t landed = copy_free + 8 * kLCopies;  // copy slot filled
  const Work w = locate<BMH>(grp, M, k_steps);
  const bool clustered = cluster_dim() > 1;
  const CUtensorMap* qmap = &maps.q[w.g];
  constexpr int kConsumers = 2 * wg::kThreads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kLCopies; ++s) {
      wg::mbar_init(copy_free + 8 * s, kConsumers);
      wg::mbar_init(landed + 8 * s, 1);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 copies every step, up to kLCopies ahead
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < w.n_iter; ++i) {
        const int s = i % kLCopies;
        wg::mbar_wait(copy_free + 8 * s, ((i / kLCopies) & 1) ^ 1);
        const uint32_t bar = landed + 8 * s;
        const int k = (w.kt0 + i) * kBK;
        mbar_expect_tx(bar, L::kH + kLRaw);
        tma_load(base + s * L::kH, &maps.h, k, w.m0, bar);
        tma_load(base + L::kRawOff + s * kLRaw, qmap, w.n0, k, bar);
      }
    }
    __syncwarp();
    if (clustered) {   // the consumers' cluster barriers
      cluster_sync_all();
      cluster_sync_all();
    }
    return;
  }

  const int cw = threadIdx.x / wg::kThreads;   // weight columns 64 cw ..
  const int wq = (threadIdx.x >> 5) & 3;
  auto fetch = [&](int i, uint32_t (&a)[16]) {
    wg::mbar_wait(landed + 8 * (i % kLCopies), (i / kLCopies) & 1);
    load_a(a, base + L::kRawOff + (i % kLCopies) * kLRaw, 4 * cw + wq);
  };
  // The register fences keep the compiler off the accumulators while
  // products are in flight (ptxas then serializes the products: its
  // C7515 note).
  float acc[BMH / 2];
#pragma unroll
  for (int i = 0; i < BMH / 2; ++i) acc[i] = 0.f;
  // step i's products from `cur`; then, once step i - 1's are done, step
  // i + 1's weights into `nxt` (which step i - 1 read) while these run
  auto step = [&](int i, uint32_t (&cur)[16], uint32_t (&nxt)[16]) {
    const uint32_t hs = base + (i % kLCopies) * L::kH;
    wg::fence_regs(acc);
    wg::fence_regs(cur);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wg::mma_rs_k(acc, cur + 4 * kk, wg::desc(hs + kk * 32, 16, 1024),
                   i > 0 || kk > 0);
    wg::mma_commit();
    wg::mma_wait<1>();
    wg::fence_regs(acc);
    wg::fence_regs(nxt);
    if (i > 0) wg::mbar_arrive(copy_free + 8 * ((i - 1) % kLCopies));
    if (i + 1 < w.n_iter) fetch(i + 1, nxt);
  };
  uint32_t a0[16], a1[16];
  if (w.n_iter > 0) fetch(0, a0);
  for (int it = 0; it < w.n_iter; it += 2) {
    step(it, a0, a1);
    if (it + 1 < w.n_iter) step(it + 1, a1, a0);
  }
  wg::mma_wait<0>();
  wg::fence_regs(acc);

  // accumulator 4 nt + e: D row 16 wq + g (+ 8 for e >= 2), the weight
  // column ncol (+ 1); D column 8 nt + 2 (lane % 4) (+ 1 for e odd), the
  // output row
  const int lane = threadIdx.x & 31;
  const int ncol = 64 * cw + 16 * wq + 2 * (lane >> 2);   // even
  if (w.S == 1) {
    const float s0 = w.rows > 0 ? __bfloat162float(w.scale[w.n0 + ncol]) : 0.f;
    const float s1 =
        w.rows > 0 ? __bfloat162float(w.scale[w.n0 + ncol + 1]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < BMH / 8; ++nt)
      store_frag(w, acc + 4 * nt, 8 * nt + 2 * (lane & 3), ncol, s0, s1);
    if (clustered) {
      cluster_sync_all();
      cluster_sync_all();
    }
    return;
  }
  // split-K: the partial tile [BMH rows][128 columns] over the ring (both
  // consumers are done with it: every copy landed before its step ran)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* part = reinterpret_cast<float*>(smem + (base - wg::smem_u32(smem)));
#pragma unroll
  for (int nt = 0; nt < BMH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * nt + 2 * (lane & 3) + e;
      *reinterpret_cast<float2*>(part + r * L::kPartStride + ncol) =
          make_float2(acc[4 * nt + e], acc[4 * nt + 2 + e]);
    }
  cluster_sync_all();
  pull_slice<L::kPartStride, L::kMaxS>(base, w, threadIdx.x, kConsumers);
  cluster_sync_all();   // no block leaves while another reads its partial
}

// -- host ---------------------------------------------------------------------

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// The cluster size for `want` splits of k_steps: each split at least 4
// steps, at most `cap` splits, none empty.
int clamp_splits(long want, int k_steps, int cap) {
  long s = want < k_steps / 4 ? want : k_steps / 4;
  if (s > cap) s = cap;
  if (s < 1) s = 1;
  return ceil_div(k_steps, ceil_div(k_steps, s));
}

// The plan of one weight's product at M rows, alone or in a group: its
// path (0: mma.sync, 16-row tiles, up to kSmallMax rows; 1: wgmma, 64-row
// tiles up to kN64Max rows and 256-row tiles above) and the blocks that
// split its K. A function of (M, N, K) and the SM count alone, so CUDA
// graphs capture it, and of one weight's shape alone, so a weight sums
// alone as it does in a group. The splits follow timings on an H100:
// mma.sync splits until about two blocks an SM have work; the 64-row
// wgmma tile until about 0.7 blocks an SM do for each 256 rows of h
// (below it, clusters of 6 at 16 tiles timed faster than of 8 or 9; past
// it, the ragged tiles of a few hundred rows wanted twice the blocks);
// the 256-row tile by M and K alone (a 2048-column product about fills
// the SMs, no block runs more than 128 K steps), at most 8. `force` 0 / 1
// picks the path.
struct Plan {
  int large, bm, splits;
};
Plan plan(int M, int N, int K, int force) {
  const bool large = force < 0 ? M > kSmallMax : force == 1;
  const int bm = !large ? kSM : M <= kN64Max ? 64 : 256;
  const int k_steps = K / kBK;
  if (bm == 256) {
    const int fill = sm_count() / (16 * ceil_div(M, 256));
    const int span = ceil_div(k_steps, 128);
    return {1, 256, clamp_splits(fill > span ? fill : span, k_steps, 8)};
  }
  const long tiles = (long)ceil_div(M, bm) * (N / kBN);
  const long want =
      large ? 7L * sm_count() / 10 * ceil_div(M, 256) : 2L * sm_count();
  return {large ? 1 : 0, bm,
          clamp_splits(ceil_div(want, tiles), k_steps, kMaxCluster)};
}

cudaLaunchAttribute cluster_attr(int S) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = S;   // the split-K blocks of a tile
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// One launch of `kernel` over `blocks` blocks in clusters of SC; `Tag`
// keeps each kernel's one-time attributes apart.
template <int Tag, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem_bytes, int blocks, int threads,
                   int SC, cudaStream_t stream, const Args&... args) {
  static const cudaError_t err = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr = cluster_attr(SC);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no link against
// the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    cudaGetLastError();
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 2-D tensor map over rows of `inner` elements `row_bytes` apart, boxes
// of [box_outer][box_inner] (box_inner x the element size = 128 bytes),
// 128-byte swizzled; zeros past the edges.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            uint64_t inner, uint64_t outer, uint64_t row_bytes,
            uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan of one weight's (M, N, K) product, alone or in a group: path *
// 256 + the blocks that split its K; 0 for a shape the kernels do not
// take.
extern "C" int kft_int8_proj_plan(int M, int N, int K) {
  if (M < 1 || N < kBN || N % kBN || K < kBK || K % kBK) return 0;
  const Plan p = plan(M, N, K, -1);
  return p.large * 256 + p.splits;
}

// h: bf16 [M, K] with row stride lda (elements, a multiple of 8); weight
// g < 3 with n_g > 0: q_g int8 [K, n_g] row-major, s_g bf16 [n_g], y_g
// bf16 [M, n_g] (n_g a multiple of 128; the weights after the first with
// n_g 0 are absent). K a multiple of 64. `force`: -1 the switch, 0 the
// mma.sync path, 1 the wgmma path. One launch; returns
// cudaGetLastError() after it.
extern "C" int kft_int8_proj(const void* h, int M, int K, int lda,
                             const void* q0, const void* s0, void* y0, int n0,
                             const void* q1, const void* s1, void* y1, int n1,
                             const void* q2, const void* s2, void* y2, int n2,
                             int force, void* stream) {
  const void* qs[kMaxGroup] = {q0, q1, q2};
  const void* ss[kMaxGroup] = {s0, s1, s2};
  void* ys[kMaxGroup] = {y0, y1, y2};
  const int ns[kMaxGroup] = {n0, n1, n2};
  if (M < 1 || K < kBK || K % kBK || lda < K || lda % 8 || n0 < kBN ||
      force < -1 || force > 1)
    return cudaErrorInvalidValue;
  int G = 0;
  for (; G < kMaxGroup && ns[G] > 0; ++G)
    if (ns[G] % kBN) return cudaErrorInvalidValue;
  // each weight its own split, the cluster the largest; a weight's
  // clusters hold cluster / split (rounded down) of its tiles
  Plan p[kMaxGroup];
  int cluster = 1;
  for (int g = 0; g < G; ++g) {
    p[g] = plan(M, ns[g], K, force);
    cluster = p[g].splits > cluster ? p[g].splits : cluster;
  }
  const int bm = p[0].bm;
  const int m_tiles = ceil_div(M, bm);
  Group grp = {};
  for (int g = 0; g < kMaxGroup; ++g) {
    const bool on = g < G;
    grp.q[g] = static_cast<const int8_t*>(on ? qs[g] : qs[0]);
    grp.scale[g] = static_cast<const bf16*>(on ? ss[g] : ss[0]);
    grp.y[g] = static_cast<bf16*>(on ? ys[g] : ys[0]);
    grp.n[g] = on ? ns[g] : ns[0];
    grp.splits[g] = on ? p[g].splits : 1;
    grp.clusters[g + 1] =
        grp.clusters[g] +
        (on ? ceil_div((long)m_tiles * (ns[g] / kBN), cluster / grp.splits[g])
            : 0);
  }
  const int blocks = cluster * grp.clusters[G];
  const bf16* hb = static_cast<const bf16*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_steps = K / kBK;
  if (!p[0].large)
    return launch<0>(int8_proj_mma_kernel, kSSmem, blocks, kThreads, cluster,
                     st, hb, lda, grp, M, k_steps);
  Maps maps;
  if (!map_2d(&maps.h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, K, M,
              (uint64_t)lda * 2, kBK, bm))
    return cudaErrorInvalidValue;
  for (int g = 0; g < kMaxGroup; ++g)
    if (!map_2d(&maps.q[g], CU_TENSOR_MAP_DATA_TYPE_UINT8, grp.q[g],
                grp.n[g], K, grp.n[g], kBN, kBK))
      return cudaErrorInvalidValue;
  if (bm == 256)
    return launch<2>(int8_proj_wgmma_kernel<256>, Large<256>::kSmem, blocks,
                     kLThreads, cluster, st, hb, lda, grp, M, k_steps, maps);
  return launch<1>(int8_proj_wgmma_kernel<64>, Large<64>::kSmem, blocks,
                   kLThreads, cluster, st, hb, lda, grp, M, k_steps, maps);
}
