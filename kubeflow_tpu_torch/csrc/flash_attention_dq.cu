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
// One CUDA block per (query head, batch row, 64-query tile), holding its
// Q and dO tiles and their lse and delta; it walks the same key tiles as
// the forward (causal and window skipping, masked tail) with K and V in
// shared memory, and keeps the [64, hd] dQ accumulator in registers.
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 51.6 GFLOP (QK, dO V^T and dS K over the
// visible pairs) against 67.6 MB moved, so operations bound it: 52 us at
// the bf16 tensor rate. The products run on the CUDA cores in fp32 here.
#include "flash_tile.cuh"

namespace {

using namespace kft_flash;

constexpr size_t kSmemBytes =
    sizeof(float) * (4 * (size_t)kHdTileFloats + kPTileFloats);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q,      // [b, s, n_q, hd]
                const T* __restrict__ k,      // [b, s, n_kv, hd]
                const T* __restrict__ v,
                const T* __restrict__ dout,   // [b, s, n_q, hd]
                const float* __restrict__ lse,    // [b, n_q, s]
                const float* __restrict__ delta,  // [b, n_q, s]
                T* __restrict__ dq,           // [b, s, n_q, hd]
                int s, int n_q, int n_kv, int causal, int window,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kHdTileFloats;
  float* ks = dos + kHdTileFloats;
  float* vs = ks + kHdTileFloats;
  float* ds_s = vs + kHdTileFloats;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (s + kTile - 1) / kTile;
  const int qi = nq - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qi * kTile;
  const int hk = h / (n_q / n_kv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_row = (size_t)n_q * kHD;
  const size_t kv_row = (size_t)n_kv * kHD;
  const size_t q_off = ((size_t)b * s + q0) * q_row + (size_t)h * kHD;
  load_tile(qs, q + q_off, q_row, s - q0);
  load_tile(dos, dout + q_off, q_row, s - q0);
  float row_lse[4], row_delta[4], acc[4][8];
  const size_t stat = ((size_t)b * n_q + h) * s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    row_lse[i] = qp < s ? lse[stat + qp] : 0.f;
    row_delta[i] = qp < s ? delta[stat + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_tiles(q0, nq, causal, window, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * kTile;
    const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * kHD;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile(ks, k + kv_off, kv_row, s - k0);
    load_tile(vs, v + kv_off, kv_row, s - k0);
    __syncthreads();
    float sc[4][4], dp[4][4];
    dot_tile(qs, ks, ty, tx, sc);
    dot_tile(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = visible(qp, kp, s, causal, window)
                            ? expf(sc[i][j] * scale - row_lse[i])
                            : 0.f;
        dp[i][j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    store_scores(ds_s, ty, tx, dp);
    __syncthreads();
    pv_tile(ds_s, ks, ty, tx, acc);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_acc(dq + q_off, q_row, s - q0, ty, tx, acc, mul);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int s,
           int n_q, int n_kv, int causal, int window, float scale,
           cudaStream_t stream) {
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
  flash_dq_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128. window <= 0 means
// none. Returns cudaGetLastError() after the launch.
extern "C" int kft_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int s, int n_q,
                                      int n_kv, int hd, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != kHD || s < 1 || n_kv < 1 || n_q % n_kv) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, dout, lse, delta, dq, b, s, n_q, n_kv,
                         causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, s, n_q,
                                 n_kv, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
