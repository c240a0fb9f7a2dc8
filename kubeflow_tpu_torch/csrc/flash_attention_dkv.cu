// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/flash_attention.py::_dkv_kernel (called from
// `_bwd`): with P = exp(logits - lse) and dS = P * (dO V^T - delta),
// dV = P^T dO and dK = dS^T Q * scale.
//
// One CUDA block per (KV head, batch row, 64-key tile), holding its K and
// V tiles in shared memory. It loops over the group's query heads and,
// for each, over the query tiles that see its keys (causal: from the
// diagonal on; with a window, only up to the band's end), and accumulates
// dK and dV for all of them in fp32 registers. So GQA's group sum happens
// inside the kernel: the reference writes per-query-head [b, n_q, s, hd]
// outputs and sums the group outside (flash_attention.py:337-349); here
// dK and dV are written once, at KV-head resolution, with no atomics.
// Scores are computed key-major (rows = keys, columns = queries), so P^T
// and dS^T land in shared memory in the layout the two accumulations
// read. The heaviest key tiles (the first, under causal masking) are
// launched first.
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 68.7 GFLOP (QK, P^T dO, dO V^T and
// dS^T Q over the visible pairs) against 67.6 MB moved, so operations
// bound it: 69 us at the bf16 tensor rate. The products run on the CUDA
// cores in fp32 here.
#include "flash_tile.cuh"

namespace {

using namespace kft_flash;

constexpr size_t kSmemBytes =
    sizeof(float) * (4 * (size_t)kHdTileFloats + kPTileFloats + 2 * kTile);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q,      // [b, s, n_q, hd]
                 const T* __restrict__ k,      // [b, s, n_kv, hd]
                 const T* __restrict__ v,
                 const T* __restrict__ dout,   // [b, s, n_q, hd]
                 const float* __restrict__ lse,    // [b, n_q, s]
                 const float* __restrict__ delta,  // [b, n_q, s]
                 T* __restrict__ dk,           // [b, s, n_kv, hd]
                 T* __restrict__ dv,
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int s, int n_q, int n_kv, int causal, int window, float scale,
           cudaStream_t stream) {
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_kv, b, (s + kTile - 1) / kTile);
  flash_dkv_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s, n_q, n_kv, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128. window <= 0 means
// none. Returns cudaGetLastError() after the launch.
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
    return launch<float>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q, n_kv,
                         causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b, s, n_q,
                                 n_kv, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
