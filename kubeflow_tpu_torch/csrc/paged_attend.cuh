// Block-level paged attention shared by the decode and prefill-append
// kernels: R query rows (one KV head's GQA group, or a tile of several
// tokens x the group) attend one sequence's cells through its block
// table, with an fp32 online softmax.
//
// Design, for Hopper (sm_90a), simple-and-correct first:
// - the Pallas kernels' sequential block axis (carrying m/l/acc in VMEM
//   scratch from grid step to grid step) becomes a loop inside one CUDA
//   block over chunks of kChunk cells; m/l/acc live in shared memory;
// - chunks are staged in shared memory with cp.async 16-byte copies,
//   double-buffered: the next chunk's K/V rows are in flight while the
//   current one is computed (a cell row of hd=128 bf16 is 256 contiguous
//   bytes in the [num_blocks, bs, n_kv, hd] pool; each cell finds its
//   physical block through the table, so a chunk may span blocks);
// - the loop covers only the live range: from the first cell the window
//   can see (chunk-aligned) to the last cell any row can see, so device
//   memory traffic tracks the cache fill, never blocks_per_slot * bs,
//   and the table's trash tail is never read;
// - scores: one thread per (row, cell) dot product; K tile rows are
//   padded by 16 bytes so the 16-byte reads of 8 neighbouring lanes hit
//   all 32 banks once. Softmax update: one warp per row. P.V: one thread
//   per (row, pair of hd elements), looping over the chunk's cells.
//   No tensor cores (mma/wgmma) and no split of the cell range across
//   blocks yet: that is later work.
//
// Masked cells hold -inf in the score tile, so exp() gives exactly 0 and
// a chunk with no visible cell leaves m unchanged. This is the same
// result as the Pallas kernels' NEG_INF + explicit zeroing. A row that
// sees no cell at all keeps l == 0 and is written as 0 (the Pallas
// kernels' convention); the plain path gives mean(V) there instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kft {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;  // rows per CUDA block, at most
constexpr float kNegInf = -1073741824.0f;  // -2**30, the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Two consecutive elements as floats.
__device__ __forceinline__ float2 to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 bf2_bits_to_f2(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Dot product of 16 bytes of K (`raw`, 8 bf16 or 4 fp32) with the fp32 q
// values at `q` (16-byte aligned).
__device__ __forceinline__ float dot16(const float* q, uint4 raw,
                                       __nv_bfloat16) {
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 a = bf2_bits_to_f2(raw.x), b = bf2_bits_to_f2(raw.y);
  const float2 c = bf2_bits_to_f2(raw.z), d = bf2_bits_to_f2(raw.w);
  return q0.x * a.x + q0.y * a.y + q0.z * b.x + q0.w * b.y + q1.x * c.x +
         q1.y * c.y + q1.z * d.x + q1.w * d.y;
}
__device__ __forceinline__ float dot16(const float* q, uint4 raw, float) {
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  return q0.x * __uint_as_float(raw.x) + q0.y * __uint_as_float(raw.y) +
         q0.z * __uint_as_float(raw.z) + q0.w * __uint_as_float(raw.w);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Tile geometry for element type T and head dim HD: cells per chunk (fewer
// for wide rows, to bound shared memory) and the padded K/V row stride.
template <typename T, int HD>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kChunk = HD * sizeof(T) > 256 ? 32 : 64;
  static constexpr int kStride = HD + kVec;    // row + 16 bytes of pad
  static constexpr int kBuf = kChunk * kStride;  // one K (or V) tile
};

// Shared-memory carve-up for R rows: fp32 q, acc, scores, m, l, alpha,
// the rows' query positions, then two K and two V tiles (16-byte
// aligned; double buffer).
template <typename T, int HD>
struct Smem {
  using G = Tile<T, HD>;
  float* q;
  float* acc;
  float* sc;
  float* m;
  float* l;
  float* alpha;
  int* qpos;
  T* tiles;  // K0, V0, K1, V1

  __device__ T* kt(int buf) const { return tiles + 2 * buf * G::kBuf; }
  __device__ T* vt(int buf) const { return tiles + (2 * buf + 1) * G::kBuf; }

  static __host__ __device__ size_t head_bytes(int R) {
    size_t b = sizeof(float) * ((size_t)R * HD * 2 + (size_t)R * G::kChunk +
                                3 * (size_t)R) +
               sizeof(int) * (size_t)R;
    return (b + 15) / 16 * 16;
  }
  static __host__ __device__ size_t bytes(int R) {
    return head_bytes(R) + 4 * sizeof(T) * (size_t)G::kBuf;
  }
  __device__ Smem(unsigned char* base, int R) {
    q = reinterpret_cast<float*>(base);
    acc = q + R * HD;
    sc = acc + R * HD;
    m = sc + R * G::kChunk;
    l = m + R;
    alpha = l + R;
    qpos = reinterpret_cast<int*>(alpha + R);
    tiles = reinterpret_cast<T*>(base + head_bytes(R));
  }
};

// Issue the cp.async copies of cells [c0, c0 + n_cells) of KV head h into
// tile buffer `buf`, then commit them as one group.
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(
    Smem<T, HD>& sm, int buf, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table_row, int c0,
    int n_cells, int bs, int n_kv, int h) {
  using G = Tile<T, HD>;
  constexpr int kPerRow = HD / G::kVec;
  for (int i = threadIdx.x; i < n_cells * kPerRow; i += kThreads) {
    const int c = i / kPerRow;
    const int e = i % kPerRow;
    const int cell = c0 + c;
    const size_t phys = (size_t)table_row[cell / bs];
    const size_t src = ((phys * bs + cell % bs) * n_kv + h) * HD +
                       (size_t)e * G::kVec;
    cp_async16(sm.kt(buf) + c * G::kStride + e * G::kVec, k_pool + src);
    cp_async16(sm.vt(buf) + c * G::kStride + e * G::kVec, v_pool + src);
  }
  cp_async_commit();
}

// Rows' q (fp32, in sm.q) and positions (sm.qpos) must be in place and
// synchronised before the call. On return sm.acc / sm.l hold the
// unnormalised output and the softmax denominators.
//   table_row: the sequence's block table [nb]
//   mask_row:  its per-cell validity [nb * bs] (nullptr = all valid)
//   q_min/q_max: the smallest / largest query position among the rows
template <typename T, int HD>
__device__ void paged_attend(Smem<T, HD>& sm, int R,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ table_row,
                             const unsigned char* __restrict__ mask_row,
                             int nb, int bs, int n_kv, int h, int window,
                             float scale, int q_min, int q_max) {
  using G = Tile<T, HD>;
  constexpr int kChunk = G::kChunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < R * HD; i += kThreads) sm.acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  const int hi_cell = min(q_max, nb * bs - 1);
  int lo_cell = window > 0 ? max(q_min - window + 1, 0) : 0;
  lo_cell = lo_cell / kChunk * kChunk;
  if (lo_cell <= hi_cell)
    load_chunk(sm, 0, k_pool, v_pool, table_row, lo_cell,
               min(kChunk, hi_cell - lo_cell + 1), bs, n_kv, h);
  __syncthreads();  // m/l visible to every thread even if nothing loads

  for (int c0 = lo_cell, buf = 0; c0 <= hi_cell; c0 += kChunk, buf ^= 1) {
    const int n_cells = min(kChunk, hi_cell - c0 + 1);
    const int next = c0 + kChunk;
    if (next <= hi_cell)  // prefetch the next chunk into the other buffer
      load_chunk(sm, buf ^ 1, k_pool, v_pool, table_row, next,
                 min(kChunk, hi_cell - next + 1), bs, n_kv, h);
    else
      cp_async_commit();  // empty group keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const T* kt = sm.kt(buf);
    const T* vt = sm.vt(buf);

    // scores: one thread per (row, cell); neighbouring lanes take
    // neighbouring cells of one row, so the q reads broadcast
    for (int i = tid; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i % kChunk;
      if (c >= n_cells) continue;
      const float* qr = sm.q + r * HD;
      const T* kr = kt + c * G::kStride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += G::kVec)
        dot += dot16(qr + d, *reinterpret_cast<const uint4*>(kr + d), T());
      const int idx = c0 + c;
      const int qp = sm.qpos[r];
      const bool vis = idx <= qp && (mask_row == nullptr || mask_row[idx]) &&
                       (window <= 0 || qp - idx < window);
      sm.sc[r * kChunk + c] = vis ? dot * scale : -INFINITY;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float bmax = -INFINITY;
      for (int c = lane; c < n_cells; c += 32)
        bmax = fmaxf(bmax, sm.sc[r * kChunk + c]);
      bmax = warp_max(bmax);
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, bmax);
      float psum = 0.f;
      for (int c = lane; c < n_cells; c += 32) {
        const float p = expf(sm.sc[r * kChunk + c] - m_new);
        sm.sc[r * kChunk + c] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sm.alpha[r] = a;
        sm.l[r] = sm.l[r] * a + psum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: one thread per (row, pair of hd elements)
    for (int i = tid; i < R * HD / 2; i += kThreads) {
      const int r = i / (HD / 2);
      const int d = 2 * (i % (HD / 2));
      const float* p = sm.sc + r * kChunk;
      const float a = sm.alpha[r];
      float a0 = sm.acc[r * HD + d] * a;
      float a1 = sm.acc[r * HD + d + 1] * a;
#pragma unroll 8
      for (int c = 0; c < n_cells; ++c) {
        const float2 v2 = to_f2(vt + c * G::kStride + d);
        a0 += p[c] * v2.x;
        a1 += p[c] * v2.y;
      }
      sm.acc[r * HD + d] = a0;
      sm.acc[r * HD + d + 1] = a1;
    }
    __syncthreads();  // the buffer is refilled by the next iteration
  }
}

// Raises a kernel's dynamic shared-memory cap to what kMaxRows rows need
// when that is over the default 48 KB. Called once per kernel (a function-
// local static), so launches inside a CUDA graph capture make no
// attribute calls.
template <typename T, int HD, typename Kernel>
cudaError_t set_smem_once(Kernel kernel) {
  static const cudaError_t err = [&] {
    const size_t bytes = Smem<T, HD>::bytes(kMaxRows);
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }();
  return err;
}

}  // namespace kft

extern "C" const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
