// Hopper tensor-core pieces of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_dq.cu, flash_attention_dkv.cu)
// and of the bf16 paged prefill-append kernel (paged_prefill_append.cu):
// the swizzled shared-memory tile and its wgmma descriptors, the cp.async
// copy of a tile (rows a stride apart, or each row where a functor says),
// the SS and RS warpgroup MMAs with their fence / commit / wait, the
// accumulator fragment map, and the fp32 -> bf16x2 packing of a fragment
// into an A operand. The int8 projection's wgmma kernel (int8_proj.cu)
// also takes the m64n256 and m64n64 RS products over a K-major B and the
// mbarrier waits of a warp-specialized block.
//
// A tile is 64 rows of one head ([64, 128] bf16, 16 KB) in the layout a
// wgmma descriptor reads with 128-byte swizzling: two 8 KB panels, panel
// p holding head-dim columns [64p, 64p + 64); row r of a panel is the 128
// bytes at r * 128, and its eight 16-byte chunks are permuted as
// chunk ^ (r % 8), so the 8 rows of a core matrix meet every bank once.
// The hardware applies the swizzle to address bits, so a tile starts on
// a 1024-byte boundary. The same bytes serve as
// - a K-major operand (rows are M or N, head dim is K: Q and K in
//   S = Q K^T): k-step kk (16 head-dim columns) starts in panel kk / 4,
//   32 bytes further per kk % 4; 8-row groups lie 1024 bytes apart (SBO);
// - an MN-major operand (rows are K, head dim is N: V in O += P V, K in
//   dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q): k-step kk (16
//   rows) starts 2048 bytes further; 8-row groups lie 1024 bytes apart
//   (SBO) and the two 64-column panels 8192 bytes apart (LBO).
//
// A 64-row operand at head dim HD (128 or 256) is HD / 128 such tiles
// side by side, part p holding head-dim columns [128p, 128p + 128)
// (`Operand<HD>`): a product over the head dim chains the parts' k-steps
// into one accumulator, and a product whose N is the head dim keeps one
// m64n128 accumulator a part.
//
// All of it runs in one warpgroup (128 threads, warps 4i .. 4i + 3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft_wgmma {

constexpr int kRows = 64;        // rows of a tile and of a warpgroup MMA
constexpr int kThreads = 128;    // one warpgroup
constexpr uint32_t kPanelBytes = kRows * 128;
constexpr uint32_t kTileBytes = 2 * kPanelBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after `p` (dynamic shared memory
// is only 16-byte aligned; the kernels reserve 1 KB of slack).
__device__ __forceinline__ uint32_t align_1k(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// Byte offset, inside a tile, of row r's 16-byte chunk c (head-dim
// columns 8c .. 8c + 7, c < 16).
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * kPanelBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// -- asynchronous copies: cp.async, zero-filled past `bytes` -------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Makes this thread's completed copies visible to wgmma (the async
// proxy); then a barrier publishes them to the warpgroup.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start copying 64 rows of one head into the tile at `dst`, row r from
// `row_src(r)` (256 contiguous bytes; called only for r < rows_valid);
// rows at or past `rows_valid` (>= 1) are zero-filled. Eight 16-byte
// copies a thread; the 16 lanes of a row read its 256 contiguous bytes.
// For rows that lie no fixed stride apart: a paged K/V chunk, whose cells
// are found through a block table, or a tile of (token, group member)
// query rows.
template <typename RowSrc>
__device__ __forceinline__ void load_rows_async(uint32_t dst,
                                                const RowSrc& row_src,
                                                int rows_valid) {
  const int tid = threadIdx.x % kThreads;
#pragma unroll
  for (int j = 0; j < kRows * 16 / kThreads; ++j) {
    const int i = tid + j * kThreads, r = i >> 4, c = i & 15;
    const bool ok = r < rows_valid;
    const __nv_bfloat16* src = row_src(ok ? r : 0);
    cp_async16(dst + chunk_offset(r, c), src + c * 8, ok ? 16 : 0);
  }
}

// The same for rows `row_stride` elements apart from `src`.
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, size_t row_stride,
    int rows_valid) {
  load_rows_async(
      dst, [&](int r) { return src + (size_t)r * row_stride; }, rows_valid);
}

// Start copying fp32 row statistic r (< 64) from `src` to `dst` + 4 r;
// zero at or past `rows_valid` (4-byte copies: a row of lse or delta
// starts at any multiple of s).
__device__ __forceinline__ void load_row_async(uint32_t dst,
                                               const float* __restrict__ src,
                                               int r, int rows_valid) {
  const bool ok = r < rows_valid;
  cp_async4(dst + 4 * r, src + (ok ? r : 0), ok ? 4 : 0);
}

// -- operands at head dim HD ---------------------------------------------

template <int HD>
struct Operand {
  static_assert(HD == 128 || HD == 256, "head dim 128 or 256");
  static constexpr int kParts = HD / 128;
  static constexpr uint32_t kBytes = kTileBytes * kParts;
};

// Start copying 64 rows of HD columns, `row_stride` elements apart, into
// the operand at `dst` (load_tile_async per part).
template <int HD>
__device__ __forceinline__ void load_operand_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, size_t row_stride,
    int rows_valid) {
#pragma unroll
  for (int p = 0; p < Operand<HD>::kParts; ++p)
    load_tile_async(dst + kTileBytes * p, src + 128 * p, row_stride,
                    rows_valid);
}

// -- descriptors -----------------------------------------------------------

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;  // 62: 128-byte swizzle
}
// K-major operand, k-step kk of 16 head-dim columns (LBO unused)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}
// MN-major operand, k-step kk of 16 rows
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kPanelBytes, 1024);
}

// -- warpgroup MMA ---------------------------------------------------------

// Orders register writes before the next wgmma that reads them.
__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins registers at this point of the (volatile) asm order, so the
// compiler moves no access to an accumulator or A operand across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d = A B (scale_d 0) or d += A B (scale_d 1): A [64, 16] and B^T
// [64, 16], both K-major in shared memory; fp32 accumulation.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A B^T over the head dim, A and B [64, HD] K-major operands at `a`
// and `b` (S = Q K^T, dP = dO V^T, and their transposes): HD / 16
// k-steps chained into one accumulator. The caller commits.
template <int HD>
__device__ __forceinline__ void mma_hd(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int p = 0; p < Operand<HD>::kParts; ++p)
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk)
      mma_ss_n64(d, desc_k(a + kTileBytes * p, kk),
                 desc_k(b + kTileBytes * p, kk), p > 0 || kk > 0);
}

// d += A B: A [64, 16] bf16 in registers (a[0..3], the layout `to_a`
// packs), B [16, 128] MN-major in shared memory; fp32 accumulation.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = A B (scale_d 0) or d += A B: A [64, 16] bf16 in registers (a[0..3],
// the layout `to_a` packs) and B [16, 256] K-major in shared memory (256
// rows of 16 K, `desc_k`'s layout); fp32 accumulation.
__device__ __forceinline__ void mma_rs_n256_k(float (&d)[128],
                                              const uint32_t* a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same product with B [16, 64] (64 rows of 16 K).
__device__ __forceinline__ void mma_rs_n64_k(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
// m64nN over a K-major B of N rows, N = 2 x the accumulators (256 or 64).
template <int NA>
__device__ __forceinline__ void mma_rs_k(float (&d)[NA], const uint32_t* a,
                                         uint64_t b, int scale_d) {
  if constexpr (NA == 128)
    mma_rs_n256_k(d, a, b, scale_d);
  else
    mma_rs_n64_k(d, a, b, scale_d);
}

// -- mbarriers (warp-specialized kernels) --------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// Makes initialized barriers visible before any thread uses them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival (release: this thread's earlier writes are visible to the
// threads that wait on the phase it completes).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}
// Wait (acquire) until the phase of parity `parity` has completed. A
// fresh barrier is in phase 0, and the phase before it (parity 1) counts
// as completed, so a producer's first wait for an empty stage passes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// -- fragments -------------------------------------------------------------

// Where element i of a thread's fp32 accumulator fragment of an m64nN
// wgmma sits in the [64, N] result: warp w of the warpgroup, lane t hold
// rows 16 w + t / 4 and 16 w + t / 4 + 8, columns 8 j + 2 (t % 4) + {0, 1}
// for j = i / 4.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x % kThreads;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator fragment d of a [64, 16 NK] result, rounded to bf16,
// as the A operand of NK k-steps (a[4 kk .. 4 kk + 3] for k-step kk): the
// two layouts coincide, so no value leaves its thread.
template <int NK>
__device__ __forceinline__ void to_a(const float (&d)[8 * NK],
                                     uint32_t (&a)[4 * NK]) {
#pragma unroll
  for (int i = 0; i < 4 * NK; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// max / sum over the 4 lanes that share a fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- output ----------------------------------------------------------------

// Write an m64n128 accumulator fragment as bf16 into the tile at `dst`,
// the fragment's first row times mul0 and its second times mul1 (4-byte
// stores; the 32 lanes of a store meet 32 banks).
__device__ __forceinline__ void stage_acc(uint32_t dst, const float (&d)[64],
                                          float mul0, float mul1) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = frag_row(i), c = frag_col(i);
    const float m = (i >> 1) & 1 ? mul1 : mul0;
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(dst + chunk_offset(r, c >> 3) + (c & 7) * 2),
                    "r"(pack_bf16(d[i] * m, d[i + 1] * m))
                 : "memory");
  }
}

// Write an m64n128 accumulator fragment times `mul` in fp32 to 64 rows
// of 128 columns, row r from `row_dst(r)`, rows below `rows_valid` only
// (8-byte stores straight from the fragment).
template <typename RowDst>
__device__ __forceinline__ void store_acc_f32(const RowDst& row_dst,
                                              int rows_valid,
                                              const float (&d)[64],
                                              float mul) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = frag_row(i);
    if (r < rows_valid)
      *reinterpret_cast<float2*>(row_dst(r) + frag_col(i)) =
          make_float2(d[i] * mul, d[i + 1] * mul);
  }
}

// Copy the tile at `src` to 64 rows of one head, row r to `row_dst(r)`,
// rows below `rows_valid` only, in 16-byte stores.
template <typename RowDst>
__device__ __forceinline__ void store_rows(const RowDst& row_dst,
                                           int rows_valid, uint32_t src) {
  const int tid = threadIdx.x % kThreads;
#pragma unroll
  for (int j = 0; j < kRows * 16 / kThreads; ++j) {
    const int i = tid + j * kThreads, r = i >> 4, c = i & 15;
    if (r >= rows_valid) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(src + chunk_offset(r, c))
                 : "memory");
    *reinterpret_cast<uint4*>(row_dst(r) + c * 8) = v;
  }
}

// The same for rows `row_stride` elements apart from `dst`.
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ dst,
                                           size_t row_stride, int rows_valid,
                                           uint32_t src) {
  store_rows([&](int r) { return dst + (size_t)r * row_stride; }, rows_valid,
             src);
}

}  // namespace kft_wgmma
