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
// fp32: that first kernel, kept for fp32 inputs (fp32 tiles in shared
// memory, products on the CUDA cores; flash_tile.cuh).
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace kft_flash;
namespace wg = kft_wgmma;
using bf16 = __nv_bfloat16;

// -- fp32 -------------------------------------------------------------------

constexpr size_t kSmemBytes =
    sizeof(float) * (4 * (size_t)kHdTileFloats + kPTileFloats + 2 * kTile);

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const float* __restrict__ q,      // [b, s, n_q, hd]
                 const float* __restrict__ k,      // [b, s, n_kv, hd]
                 const float* __restrict__ v,
                 const float* __restrict__ dout,   // [b, s, n_q, hd]
                 const float* __restrict__ lse,    // [b, n_q, s]
                 const float* __restrict__ delta,  // [b, n_q, s]
                 float* __restrict__ dk,           // [b, s, n_kv, hd]
                 float* __restrict__ dv,
                 int s, int n_q, int n_kv, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kHdTileFloats;
  float* qs = vs + kHdTileFloats;
  float* dos = qs + kHdTileFloats;
  float* ps = dos + kHdTileFloats;
  float* lse_s = ps + kPTileFloats;
  float* delta_s = lse_s + kTile;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int ki = blockIdx.z;  // heaviest (earliest) key tiles first
  const int k0 = ki * kTile;
  const int nq = (s + kTile - 1) / kTile;
  const int group = n_q / n_kv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_row = (size_t)n_q * kHD;
  const size_t kv_row = (size_t)n_kv * kHD;
  const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * kHD;
  load_tile(ks, k + kv_off, kv_row, s - k0);
  load_tile(vs, v + kv_off, kv_row, s - k0);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int lo, hi;
  query_tiles(k0, nq, causal, window, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t stat = ((size_t)b * n_q + h) * s;
    for (int qi = lo; qi <= hi; ++qi) {
      const int q0 = qi * kTile;
      const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * kHD;
      __syncthreads();  // the previous tile's Q, dO and dS are consumed
      load_tile(qs, q + q_off, q_row, s - q0);
      load_tile(dos, dout + q_off, q_row, s - q0);
      load_rows(lse_s, lse + stat + q0, s - q0);
      load_rows(delta_s, delta + stat + q0, s - q0);
      __syncthreads();
      float sc[4][4], dp[4][4];
      dot_tile(ks, qs, ty, tx, sc);   // [key][query] logits / scale
      dot_tile(vs, dos, ty, tx, dp);  // [key][query] of dO V^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + c, kp, s, causal, window)
                              ? expf(sc[i][j] * scale - lse_s[c])
                              : 0.f;
          sc[i][j] = p;
          dp[i][j] = p * (dp[i][j] - delta_s[c]);
        }
      }
      store_scores(ps, ty, tx, sc);
      __syncthreads();
      pv_tile(ps, dos, ty, tx, dv_acc);  // dV += P^T dO
      __syncthreads();
      store_scores(ps, ty, tx, dp);
      __syncthreads();
      pv_tile(ps, qs, ty, tx, dk_acc);   // dK += dS^T Q
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_acc(dv + kv_off, kv_row, s - k0, ty, tx, dv_acc, one);
  store_acc(dk + kv_off, kv_row, s - k0, ty, tx, dk_acc, mul);
}

// -- bf16: tensor cores -----------------------------------------------------

constexpr int kStages = 2;  // Q / dO / lse / delta ring
constexpr uint32_t kStatBytes = 2 * kTile * sizeof(float);  // lse, delta
// K, V, kStages x (Q, dO), kStages x (lse, delta); 1 KB of slack for the
// 1024-byte alignment
constexpr size_t kTcSmemBytes =
    1024 + wg::kTileBytes * (2 + 2 * kStages) + kStatBytes * kStages;

__global__ void __launch_bounds__(wg::kThreads, 2)
flash_dkv_tc_kernel(const bf16* __restrict__ q,       // [b, s, n_q, hd]
                    const bf16* __restrict__ k,       // [b, s, n_kv, hd]
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,    // [b, s, n_q, hd]
                    const float* __restrict__ lse,    // [b, n_q, s]
                    const float* __restrict__ delta,  // [b, n_q, s]
                    bf16* __restrict__ dk,            // [b, s, n_kv, hd]
                    bf16* __restrict__ dv,
                    int s, int n_q, int n_kv, int causal, int window,
                    float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t ks = wg::align_1k(tc_smem);
  const uint32_t vs = ks + wg::kTileBytes;
  auto q_tile = [&](int st) { return ks + wg::kTileBytes * (2 + 2 * st); };
  auto do_tile = [&](int st) { return q_tile(st) + wg::kTileBytes; };
  auto stats = [&](int st) {  // lse [64] then delta [64]
    return ks + wg::kTileBytes * (2 + 2 * kStages) + kStatBytes * st;
  };
  const float* stats_ptr = reinterpret_cast<const float*>(
      tc_smem + (stats(0) - wg::smem_u32(tc_smem)));
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // heaviest (earliest) tiles first
  const int nq = (s + kTile - 1) / kTile;
  const int group = n_q / n_kv;
  const size_t q_row = (size_t)n_q * kHD;
  const size_t kv_row = (size_t)n_kv * kHD;
  const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * kHD;
  int lo, hi;
  query_tiles(k0, nq, causal, window, &lo, &hi);
  const int per_head = hi - lo + 1;
  const int steps = group * per_head;  // (query head, query tile) pairs
  const int tid = threadIdx.x;
  auto load_q = [&](int it, int st) {
    const int h = hk * group + it / per_head;
    const int q0 = (lo + it % per_head) * kTile;
    const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * kHD;
    wg::load_tile_async(q_tile(st), q + q_off, q_row, s - q0);
    wg::load_tile_async(do_tile(st), dout + q_off, q_row, s - q0);
    const size_t stat = ((size_t)b * n_q + h) * s + q0;
    wg::load_row_async(stats(st) + (tid < kTile ? 0 : kTile * 4),
                       (tid < kTile ? lse : delta) + stat, tid % kTile,
                       s - q0);
  };
  wg::load_tile_async(ks, k + kv_off, kv_row, s - k0);
  wg::load_tile_async(vs, v + kv_off, kv_row, s - k0);
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
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk)
      wg::mma_ss_n64(sT, wg::desc_k(ks, kk), wg::desc_k(q_tile(st), kk),
                     kk > 0);
    wg::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk)
      wg::mma_ss_n64(dpT, wg::desc_k(vs, kk), wg::desc_k(do_tile(st), kk),
                     kk > 0);
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
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::mma_rs_n128(dv_acc, pa + 4 * kk, wg::desc_mn(do_tile(st), kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::mma_rs_n128(dk_acc, dsa + 4 * kk, wg::desc_mn(q_tile(st), kk));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    __syncthreads();  // stage st is consumed before the next refill
  }

  // K and V were read for the last time above: their tiles hold the output
  wg::stage_acc(vs, dv_acc, 1.f, 1.f);
  wg::stage_acc(ks, dk_acc, scale, scale);
  __syncthreads();
  wg::store_tile(dv + kv_off, kv_row, s - k0, vs);
  wg::store_tile(dk + kv_off, kv_row, s - k0, ks);
}

int launch_fp32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int s, int n_q, int n_kv,
                int causal, int window, float scale, cudaStream_t stream) {
  // once per kernel, so launches inside a CUDA-graph capture make no
  // attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_kv, b, (s + kTile - 1) / kTile);
  flash_dkv_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s, n_q, n_kv,
      causal, window, scale);
  return cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int s, int n_q, int n_kv,
                int causal, int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_kv, b, (s + kTile - 1) / kTile);
  flash_dkv_tc_kernel<<<grid, wg::kThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, n_q, n_kv, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). hd must
// be 128. window <= 0 means none. Returns cudaGetLastError() after the
// launch.
extern "C" int kft_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int s,
                                       int n_q, int n_kv, int hd, int causal,
                                       int window, float scale, int dtype,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != kHD || s < 1 || n_kv < 1 || n_q % n_kv) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fp32(q, k, v, dout, lse, delta, dk, dv, b, s, n_q, n_kv,
                       causal, window, scale, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, dout, lse, delta, dk, dv, b, s, n_q, n_kv,
                       causal, window, scale, st);
  return cudaErrorInvalidValue;
}
