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
// Both kernels: one CUDA block per (query head, batch row, 64-query tile)
// walks the relevant 64-key tiles in a loop (the Pallas kernel's
// sequential grid axis), carrying the row max m, the row sum l and the
// [64, hd] accumulator in registers. Tiles above the causal diagonal and
// wholly older than the window are never visited. Any s works: the tail
// tile's rows past s are zero-filled and masked. A masked logit is the
// reference's finite NEG_INF, so a row whose first visited tile is all
// masked is washed out by the next tile's alpha. The heaviest query
// tiles (the last, under causal masking) are launched first.
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
// first kernel (below) back: fp32 products on the CUDA cores (67 TFLOP/s
// peak against 989), P round-tripped through shared memory with a barrier
// on each side, synchronous K/V loads, and 118 KB of fp32 tiles (one
// block an SM).
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
// fp32: that first kernel, kept for fp32 inputs (fp32 tiles in shared
// memory, products on the CUDA cores; flash_tile.cuh), a template on the
// head dim: 128 (118 KB of shared memory) and 256 (gemma-2b: Q, K, V and
// the score tile are 217 KB, opted in past the 48 KB default; one block
// an SM). fp32 stays off the tensor cores: TF32 would round the products
// the reference's fp32 kernels take in full fp32. Bound at gemma-2b's
// shape in fp32: the 34.4 GFLOP over the card's 67 TFLOP/s of fp32 on
// the CUDA cores, 0.51 ms.
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace kft_flash;
namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

// -- fp32 -------------------------------------------------------------------

// Q, K, V and a score tile: 118 KB at head dim 128, 217 KB at 256.
template <int HD>
constexpr size_t fp32_smem_bytes() {
  return sizeof(float) * (3 * (size_t)kHdTileFloats<HD> + kPTileFloats);
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
  constexpr int kCols = HD / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kHdTileFloats<HD>;
  float* vs = ks + kHdTileFloats<HD>;
  float* ps = vs + kHdTileFloats<HD>;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (s + kTile - 1) / kTile;
  const int qi = nq - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qi * kTile;
  const int hk = h / (n_q / n_kv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_row = (size_t)n_q * HD;
  const size_t kv_row = (size_t)n_kv * HD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * HD;
  load_tile<HD>(qs, q + q_off, q_row, s - q0);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  key_tiles(q0, nq, causal, window, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * kTile;
    const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * HD;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<HD>(ks, k + kv_off, kv_row, s - k0);
    load_tile<HD>(vs, v + kv_off, kv_row, s - k0);
    __syncthreads();
    float sc[4][4];
    dot_tile<HD>(qs, ks, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        sc[i][j] = visible(qp, kp, s, causal, window) ? sc[i][j] * scale
                                                      : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    store_scores(ps, ty, tx, sc);
    __syncthreads();
    pv_tile<HD>(ps, vs, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / safe_l;
    const int qp = q0 + ty + 16 * i;
    if (tx == 0 && qp < s)
      lse[((size_t)b * n_q + h) * s + qp] = m[i] + logf(safe_l);
  }
  store_acc<HD>(o + q_off, q_row, s - q0, ty, tx, acc, inv);
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
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
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

// dtype: 0 = float32 (CUDA cores, hd 128 only), 1 = bfloat16 (tensor
// cores, hd 128 or 256). window <= 0 means none (and is ignored unless
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
