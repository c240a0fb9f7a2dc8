// Weight-only int8 projection for Hopper (sm_90a):
//
//     y[M, N] = (h[M, K] @ q[K, N]) * scale[N]
//
// with bf16 activations h (row stride lda), int8 weights q in the
// reference's [in, out] layout (row-major, out contiguous), a bf16
// per-output-channel scale, fp32 accumulation and a bf16 result.
//
// Replaces no Pallas kernel: it is the card's counterpart of
// kubeflow_tpu/serving/quant.py::qdot, where XLA fuses the int8 -> bf16
// convert into the dot's operand read so that device memory sees int8.
// PyTorch fuses nothing: `h @ q.to(bf16)` reads the int8 weight, writes a
// bf16 copy and reads it again, about 2.5x the bf16 product's bytes.
//
// Bound on this card: at decode (M = live rows, <= 8) and the spec verify
// (M = 40) the weight's K x N bytes, at 3.35 TB/s (2 M flops a weight byte
// against the ~295 at which the bf16 tensor cores would bind); a long
// prefill (M in the thousands) is bound by its 2 M N K flops at 989
// TFLOP/s.
//
// Design (simple and right first; `wgmma` and TMA are a later redesign):
// - one CUDA block per (BM x 128 output tile, K range); 128 threads, four
//   warps. BM is 16 for M <= 16 (decode: the tensor cores idle on the
//   padded rows, the weight read binds) and 64 above (verify, slices,
//   prefill). Rows past M are zero-filled on load and never stored;
// - a ring of kStages shared-memory stages filled by 16-byte `cp.async`
//   copies: the A tile [BM][64] bf16 and the weight tile [64][128] int8
//   (each thread's copies are 16 int8 along N, coalesced). Per K step
//   every thread converts 64 weights of the landed stage to bf16 in
//   registers (bias to unsigned, `prmt` into the mantissa of 2^23,
//   subtract: exact for [-127, 127]) into one [64][128 + 8] bf16 tile,
//   from which `ldmatrix.trans` feeds `mma.sync.m16n8k16` bf16 products
//   with fp32 accumulators; A comes through `ldmatrix`. The 16-byte row
//   pad keeps both `ldmatrix` reads free of bank conflicts;
// - split-K for grids that would leave the 132 SMs idle (decode's one M
//   tile): block z takes a contiguous range of K steps and writes its
//   fp32 partial tile to a workspace [splits][M][N]; a combine launch sums
//   the splits in z order, applies the scale and rounds once to bf16. No
//   float atomics, so a result does not depend on the order blocks ran in
//   (the serving checks compare repeated prompts token for token). With
//   one split the scale is applied in the tile's epilogue.
// - the split count is a function of (M, N, K) and the SM count alone
//   (`kft_int8_proj_splits`), so the launches can be captured in a CUDA
//   graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;     // output columns of a tile
constexpr int kBK = 64;      // K of one pipeline stage
constexpr int kStages = 4;   // cp.async ring depth
constexpr int kThreads = 128;

template <int BM, int WM, int WN>
struct Cfg {
  static_assert(WM * WN * 32 == kThreads, "four warps");
  static constexpr int kWarpM = BM / WM;       // rows of a warp's tile
  static constexpr int kWarpN = kBN / WN;      // columns of a warp's tile
  static constexpr int kMT = kWarpM / 16;      // m16 tiles a warp
  static constexpr int kNT = kWarpN / 8;       // n8 tiles a warp
  static_assert(kMT >= 1 && kNT % 2 == 0, "warp tile");
  static constexpr int kAStride = kBK + 8;     // bf16 a row of the A tile
  static constexpr int kBStride = kBN + 8;     // bf16 a row of the B tile
  static constexpr int kAStage = BM * kAStride * 2;   // bytes
  static constexpr int kQStage = kBK * kBN;           // bytes
  static constexpr int kSmem =
      kStages * (kAStage + kQStage) + kBK * kBStride * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one 32-bit word, byte 0 first) -> two bf16x2 words, exact:
// each byte biased to unsigned is placed in the low mantissa byte of
// 2^23, so the float is 2^23 + x + 128; subtracting 2^23 + 128 leaves x,
// an integer in [-128, 127] that bf16 holds exactly.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                                 uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float kBias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
  // the high halves of the exact floats are the exact bf16 values
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One (BM x 128) output tile over K steps [kt0, kt1) of 64. `part` null:
// y gets the scaled bf16 tile; else the fp32 partial tile goes to
// part[z][M][N].
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
int8_proj_kernel(const __nv_bfloat16* __restrict__ h, int lda,
                 const int8_t* __restrict__ q,
                 const __nv_bfloat16* __restrict__ scale,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 int M, int N, int k_steps, int per_split) {
  using C = Cfg<BM, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_st = smem;                               // kStages x A
  unsigned char* q_st = smem + kStages * C::kAStage;        // kStages x Q
  __nv_bfloat16* b_tile = reinterpret_cast<__nv_bfloat16*>(
      q_st + kStages * C::kQStage);                         // [64][136]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const int kt0 = z * per_split;
  const int kt1 = min(kt0 + per_split, k_steps);
  const int n_iter = kt1 - kt0;

  auto load_stage = [&](int stage, int kt) {
    // A: BM rows x 8 chunks of 16 bytes
    unsigned char* a_dst = a_st + stage * C::kAStage;
    for (int c = tid; c < BM * 8; c += kThreads) {
      const int r = c >> 3, cc = c & 7;
      const int m = m0 + r;
      const __nv_bfloat16* src =
          h + (size_t)(m < M ? m : 0) * lda + kt * kBK + cc * 8;
      cp_async16(a_dst + (r * C::kAStride + cc * 8) * 2, src,
                 m < M ? 16 : 0);
    }
    // Q: 64 rows x 8 chunks of 16 int8
    unsigned char* q_dst = q_st + stage * C::kQStage;
    for (int c = tid; c < kBK * 8; c += kThreads) {
      const int r = c >> 3, cc = c & 7;
      const int8_t* src = q + (size_t)(kt * kBK + r) * N + n0 + cc * 16;
      cp_async16(q_dst + r * kBN + cc * 16, src, 16);
    }
  };

  float acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % kStages;
    cp_async_wait<kStages - 2>();
    // stage `it` has landed for every thread, and every thread is done
    // with the previous step's B tile and with the stage refilled below
    __syncthreads();
    if (it + kStages - 1 < n_iter)
      load_stage((it + kStages - 1) % kStages, kt0 + it + kStages - 1);
    cp_async_commit();

    // int8 [64][128] -> bf16 [64][136]: 4 chunks of 16 weights a thread
    const unsigned char* q_src = q_st + stage * C::kQStage;
#pragma unroll
    for (int i = 0; i < (kBK * kBN / 16) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, cc = c & 7;
      const uint4 w =
          *reinterpret_cast<const uint4*>(q_src + r * kBN + cc * 16);
      uint4 o0, o1;
      int8x4_to_bf16x4(w.x, o0.x, o0.y);
      int8x4_to_bf16x4(w.y, o0.z, o0.w);
      int8x4_to_bf16x4(w.z, o1.x, o1.y);
      int8x4_to_bf16x4(w.w, o1.z, o1.w);
      uint4* dst =
          reinterpret_cast<uint4*>(b_tile + r * C::kBStride + cc * 16);
      dst[0] = o0;
      dst[1] = o1;
    }
    __syncthreads();

    const __nv_bfloat16* a_tile =
        reinterpret_cast<const __nv_bfloat16*>(a_st + stage * C::kAStage);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[C::kMT][4];
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        const int row = wm * C::kWarpM + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt],
                    a_tile + row * C::kAStride + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < C::kNT / 2; ++np) {
        uint32_t b[4];
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn * C::kWarpN + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, b_tile + krow * C::kBStride + col);
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mt, nt, e): row lane/4 (+8 for e >= 2), columns
  // 2 (lane % 4) and the next
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * C::kWarpM + mt * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        const int n = n0 + wn * C::kWarpN + nt * 8 + (lane & 3) * 2;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (part == nullptr) {
          const float s0 = __bfloat162float(scale[n]);
          const float s1 = __bfloat162float(scale[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
              __floats2bfloat162_rn(v0 * s0, v1 * s1);
        } else {
          *reinterpret_cast<float2*>(part + ((size_t)z * M + m) * N + n) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// y[m, n] = bf16(scale[n] * sum_z part[z, m, n]), z in order; a thread
// per pair of columns.
__global__ void int8_proj_combine_kernel(const float* __restrict__ part,
                                         const __nv_bfloat16* __restrict__ scale,
                                         __nv_bfloat16* __restrict__ y, int M,
                                         int N, int splits) {
  const size_t pairs = (size_t)M * N / 2;
  const size_t stride = (size_t)M * N;
  for (size_t p = blockIdx.x * (size_t)blockDim.x + threadIdx.x; p < pairs;
       p += (size_t)gridDim.x * blockDim.x) {
    const size_t i = 2 * p;
    const int n = (int)(i % N);
    float s0 = 0.f, s1 = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(part + z * stride + i);
      s0 += v.x;
      s1 += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(
        s0 * __bfloat162float(scale[n]), s1 * __bfloat162float(scale[n + 1]));
  }
}

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

int block_rows(int M) { return M <= 16 ? 16 : 64; }

template <int BM, int WM, int WN>
cudaError_t set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      int8_proj_kernel<BM, WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BM, WM, WN>::kSmem);
  return err;
}

template <int BM, int WM, int WN>
int launch(const void* h, int lda, const void* q, const void* scale, void* y,
           void* ws, int M, int N, int K, int splits, cudaStream_t stream) {
  cudaError_t err = set_smem_once<BM, WM, WN>();
  if (err != cudaSuccess) return err;
  const int k_steps = K / kBK;
  const int per = (k_steps + splits - 1) / splits;
  const dim3 grid((M + BM - 1) / BM, N / kBN, splits);
  int8_proj_kernel<BM, WM, WN><<<grid, kThreads, Cfg<BM, WM, WN>::kSmem,
                                 stream>>>(
      static_cast<const __nv_bfloat16*>(h), lda,
      static_cast<const int8_t*>(q),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, k_steps, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t pairs = (size_t)M * N / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256
                                                      : 4096);
  int8_proj_combine_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Split-K count for an (M, N, K) product: enough blocks for two per SM
// where the output tiles alone leave SMs idle, each split at least 4 K
// steps of 64 (the ring's depth), no split empty. 0 for a shape the
// kernel does not take.
extern "C" int kft_int8_proj_splits(int M, int N, int K) {
  if (M < 1 || N < kBN || N % kBN || K < kBK || K % kBK) return 0;
  const int bm = block_rows(M);
  const long tiles = (long)((M + bm - 1) / bm) * (N / kBN);
  const int k_steps = K / kBK;
  const long want = (2L * sm_count() + tiles - 1) / tiles;
  int splits = (int)(want < k_steps / 4 ? want : k_steps / 4);
  if (splits < 1) splits = 1;
  const int per = (k_steps + splits - 1) / splits;
  return (k_steps + per - 1) / per;
}

// h: bf16 [M, K] with row stride lda (elements, a multiple of 8); q: int8
// [K, N] row-major; scale: bf16 [N]; y: bf16 [M, N]; ws: fp32 room for
// splits x M x N values when splits > 1 (else unused). N a multiple of
// 128, K of 64; splits from kft_int8_proj_splits. Returns
// cudaGetLastError() after the launches.
extern "C" int kft_int8_proj(const void* h, const void* q, const void* scale,
                             void* y, void* ws, int M, int N, int K, int lda,
                             int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N % kBN || K % kBK || N < kBN || K < kBK || lda < K ||
      lda % 8 || splits < 1 || splits > K / kBK)
    return cudaErrorInvalidValue;
  if (block_rows(M) == 16)
    return launch<16, 1, 4>(h, lda, q, scale, y, ws, M, N, K, splits, s);
  return launch<64, 2, 2>(h, lda, q, scale, y, ws, M, N, K, splits, s);
}
