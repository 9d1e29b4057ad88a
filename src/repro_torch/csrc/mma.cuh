// Tensor-core building blocks of the bfloat16 flash kernels: warp-level
// mma.sync products on 16 x 16 x 8 tiles, ldmatrix fragment loads from
// XOR-swizzled shared-memory tiles, and a cp.async ring that fills them.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane l of a warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments
// for mma.m16n8k16"):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B (16 x 8, k x n), 2 registers:  b0 (2t..2t+1, g)  b1 (8+2t.., g)
//   C, D (16 x 8 float32):  c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The lower-indexed element of each pair sits in the low 16 bits.  So
// the accumulators of two neighbouring n-blocks (16 columns) are, once
// rounded to bf16, the A fragment of one k-block: a product's result
// feeds the next product from registers (acc_to_a), as FlashAttention-2
// keeps its probabilities out of shared memory.
//
// Shared-memory tiles hold rows of head_dim bf16 (128 or 256 bytes) as
// 16-byte chunks, chunk c of row r stored at chunk c ^ (r % 8): the eight
// rows one ldmatrix matrix reads then sit in eight different bank groups.
// A 64-byte row (head_dim 32, 4 chunks) fills half of the 128 bytes the
// 32 banks span, so two rows share them: chunk c of row r is stored at
// c ^ ((r / 2) % 4), and row r's bank group is 4 (r % 2) + that, eight
// distinct groups over any eight consecutive rows.  Likewise a 32-byte row
// (2 chunks: a head_dim slice of 16 bf16 or 8 float32 elements) stores
// chunk c at c ^ ((r / 4) % 2), and a 16-byte row is not swizzled: eight
// consecutive rows fill the 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, around L1.  With `valid` false the 16 bytes
// are zero-filled and nothing is read (src-size 0); `src` must still be
// a mapped address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 8 bytes, for rows of 4 bf16 elements (a head_dim slice of a cut 16 ways)
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// 4 bytes, for float32 rows whose start need not be 16-byte aligned
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of chunk c of row r in a swizzled tile of CPR chunks a row
template <int CPR>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(CPR % 8 == 0 || CPR == 4 || CPR == 2 || CPR == 1,
                "rows of 1, 2, 4 or 8k chunks");
  const int x = CPR == 1   ? 0
                : CPR == 2 ? (r >> 2) & 1
                : CPR == 4 ? (r >> 1) & 3
                           : r & 7;
  return static_cast<uint32_t>((r * CPR + (c ^ x)) * 16);
}

// rows r0 .. r0 + ROWS - 1 of a (sequence, HD) bf16 view (row stride
// `stride` elements) into the swizzled tile at `tile`, zeros for rows at
// or past n; the block's NT threads each issue ROWS * HD / 8 / NT copies
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* base,
                                          int64_t stride, int r0, int n) {
  constexpr int CPR = HD / 8;
  static_assert((ROWS * CPR) % NT == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int idx = i * NT + static_cast<int>(threadIdx.x);
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < n;
    const __nv_bfloat16* src =
        ok ? base + static_cast<int64_t>(r0 + r) * stride + c * 8 : base;
    cp_async16(tile + swz<CPR>(r, c), src, ok);
  }
}

// the lane's address for an x4 ldmatrix of the 16 x 16 block at rows
// r0 .. r0 + 15, chunks c0, c0 + 1: read plainly it is the A fragment of
// that block (rows = m, columns = k); read with .trans it is the B
// fragments of two n-blocks, when tile rows are k and columns n
template <int CPR>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0,
                                           int lane) {
  return tile + swz<CPR>(r0 + (lane & 15), c0 + (lane >> 4));
}

// the lane's address for an x4 ldmatrix giving the B fragments (b0, b1)
// of the n-blocks n0 .. n0 + 7 and n0 + 8 .. n0 + 15 at chunks c0, c0 + 1,
// when tile rows are n and columns k (K against Q, Q against K)
template <int CPR>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int c0,
                                           int lane) {
  return tile + swz<CPR>(n0 + (lane & 7) + ((lane >> 4) << 3),
                         c0 + ((lane >> 3) & 1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on one 16 x 8 x 16 tile, bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the float32 accumulators of n-blocks 2j and 2j + 1, rounded to bf16,
// as the A fragment of k-block j
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// max and sum over the four lanes (t = 0..3) that share accumulator rows
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a warp's 16 accumulator rows of HD columns, rounded to bf16, into rows
// r0 .. r0 + 15 of a swizzled tile (4-byte stores, one chunk per n-block:
// the eight rows of a store sit in eight bank groups)
template <int HD>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, int r0,
                                            const float (&acc)[HD / 8][4],
                                            float scale0, float scale1,
                                            int lane) {
  constexpr int CPR = HD / 8;
  const int r = r0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    *reinterpret_cast<uint32_t*>(tile + swz<CPR>(r, nb) + 4 * t) =
        pack_bf16(acc[nb][0] * scale0, acc[nb][1] * scale0);
    *reinterpret_cast<uint32_t*>(tile + swz<CPR>(r + 8, nb) + 4 * t) =
        pack_bf16(acc[nb][2] * scale1, acc[nb][3] * scale1);
  }
}

// rows r0 .. r0 + 15 of a swizzled tile to rows p0 + (0..15) of a
// (sequence, HD) bf16 view, 16-byte stores, rows at or past n skipped;
// one warp, each lane a chunk in turn (neighbouring lanes, neighbouring
// chunks of a row)
template <int HD>
__device__ __forceinline__ void tile_to_global(const unsigned char* tile,
                                               int r0, __nv_bfloat16* base,
                                               int64_t stride, int p0, int n,
                                               int lane) {
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = idx / CPR, c = idx % CPR;
    if (p0 + r < n)
      *reinterpret_cast<uint4*>(base + static_cast<int64_t>(p0 + r) * stride
                                + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<CPR>(r0 + r, c));
  }
}

}  // namespace mma
