// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubeflow_tpu/ops/pallas/flash_attention.py::_fwd_kernel (wrapper `_fwd`):
// blockwise online-softmax attention with GQA, causal or not, optional
// sliding window; returns o in the input dtype and the row logsumexp in
// fp32 as [b, n_q, s] (the TPU kernel's 128-lane replication of lse is a
// Pallas tiling constraint, not part of the function).
//
// One CUDA block per (query head, batch row, 64-query tile); it keeps its
// Q tile in shared memory and walks the relevant 64-key tiles in a loop
// (the Pallas kernel's sequential grid axis), carrying m, l and the
// [64, hd] accumulator in registers. Tiles above the causal diagonal and
// wholly older than the window are never visited. Any s works: the tail
// tile's rows past s are zero-filled and masked. The heaviest query tiles
// (the last, under causal masking) are launched first.
//
// Bound on this card at llama3-1b's training shape (b 2, s 2048, n_q 16,
// n_kv 8, hd 128, bf16, causal): 34.4 GFLOP of QK and PV products over
// the visible pairs against 50.6 MB moved (q, k, v read once, o and lse
// written once; 15 us at 3.35 TB/s), so operations bound it: 34.8 us at
// the bf16 tensor rate (989 TFLOP/s). This kernel runs those products
// on the CUDA cores in fp32 (67 TFLOP/s peak), so it cannot come near that
// bound; tensor-core (wgmma) tiles fed by TMA are the later step.
#include "flash_tile.cuh"

namespace {

using namespace kft_flash;

constexpr size_t kSmemBytes =
    sizeof(float) * (3 * (size_t)kHdTileFloats + kPTileFloats);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q,  // [b, s, n_q, hd]
                 const T* __restrict__ k,  // [b, s, n_kv, hd]
                 const T* __restrict__ v,
                 T* __restrict__ o,        // [b, s, n_q, hd]
                 float* __restrict__ lse,  // [b, n_q, s]
                 int s, int n_q, int n_kv, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kHdTileFloats;
  float* vs = ks + kHdTileFloats;
  float* ps = vs + kHdTileFloats;
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

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  key_tiles(q0, nq, causal, window, &lo, &hi);
  for (int ki = lo; ki <= hi; ++ki) {
    const int k0 = ki * kTile;
    const size_t kv_off = ((size_t)b * s + k0) * kv_row + (size_t)hk * kHD;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(ks, k + kv_off, kv_row, s - k0);
    load_tile(vs, v + kv_off, kv_row, s - k0);
    __syncthreads();
    float sc[4][4];
    dot_tile(qs, ks, ty, tx, sc);
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
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    store_scores(ps, ty, tx, sc);
    __syncthreads();
    pv_tile(ps, vs, ty, tx, acc);
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
  store_acc(o + q_off, q_row, s - q0, ty, tx, acc, inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int s, int n_q, int n_kv, int causal, int window,
           float scale, cudaStream_t stream) {
  // once per instantiation, so launches inside a CUDA-graph capture make
  // no attribute calls
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n_q, b, (s + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, n_q, n_kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be 128 (llama3-1b; other head
// dims come with a model that needs them). window <= 0 means none (and is
// ignored unless causal). Returns cudaGetLastError() after the launch.
extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int s, int n_q, int n_kv,
                                       int hd, int causal, int window,
                                       float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != kHD || s < 1 || n_kv < 1 || n_q % n_kv) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, b, s, n_q, n_kv, causal, window,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, s, n_q, n_kv, causal,
                                 window, scale, st);
  return cudaErrorInvalidValue;
}
