// Tensor-core building blocks for sm_80+ (used on sm_90a): asynchronous
// global -> shared copies, swizzled bf16 tiles in shared memory, ldmatrix
// and the warp-level mma.sync m16n8k16 bf16 product with fp32 sums.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g in [0, 8), t in
// [0, 4)); every 32-bit register holds two bf16, the lower column in the
// low half:
//   A 16x16 (row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                        a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B 16x8  (k x n)      b0 (k 2t..2t+1, n g)   b1 (k 2t+8.., n g)
//   C 16x8  fp32         c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// So the C tiles of two neighbouring n8 columns, rounded to bf16 and
// packed pairwise, are the A fragment of the 16x16 product that follows
// (pack_a): a product's result feeds the next one from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rtt {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1), zero-filled when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Close the current group of copies (an empty group is allowed).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives (row lane / 4, columns 2 (lane % 4), +1) of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: register i receives (rows 2 (lane % 4),
// +1; column lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of a 16x16 product from the fp32 C tiles of columns
// 0..7 (c0) and 8..15 (c1), each value rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A tile of bf16 rows, D values each, in shared memory as 16-byte chunks.
// Chunk c of row r is stored at chunk c ^ swizzle(r): the 8 rows that one
// ldmatrix matrix reads at one logical chunk then fall in 8 different
// 16-byte bank groups, so neither ldmatrix nor .trans conflicts.
template <int D>
struct Tile {
  static constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
  static constexpr int ROW_BYTES = D * 2;
  static_assert(CHUNKS == 2 || CHUNKS >= 8, "head_dim 16, or 64 and up");
  __device__ static __forceinline__ int swizzle(int row) {
    // 8 rows span 8 bank groups only when rows are 128 bytes or more; at
    // 32-byte rows, rows r and r + 4 would collide, so flip on bit 2.
    return CHUNKS >= 8 ? (row & 7) : ((row >> 2) & 1);
  }
  __device__ static __forceinline__ uint32_t addr(uint32_t base, int row,
                                                  int chunk) {
    return base + row * ROW_BYTES + ((chunk ^ swizzle(row)) << 4);
  }
};

// Rows [0, rows) of a tile from global rows src + r * row_stride (in
// elements), `threads` threads cooperating; rows at or past `valid` are
// zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int valid, int tid) {
  constexpr int CH = Tile<D>::CHUNKS;
  static_assert((ROWS * CH) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int idx = i * THREADS + tid;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < valid;
    const __nv_bfloat16* g = src + (ok ? r * row_stride + c * 8 : 0);
    cp_async_16(Tile<D>::addr(dst, r, c), g, ok);
  }
}

}  // namespace tc
}  // namespace rtt
