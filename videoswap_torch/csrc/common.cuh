// Shared device helpers for the port's hand-written Hopper kernels.
//
// Tensor-core products use the warp-level `mma.sync.m16n8k16` bf16 -> fp32
// instruction. Its fragment layouts are fixed by PTX, which lets the
// kernels keep accumulators in registers and still know which row and
// column each value belongs to (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                         a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16x8, col-major):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit A/B register holds two bf16 values, the lower index in the
// low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace vs {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ uint32_t pack_u16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 32-bit load of two adjacent bf16 (shared or global memory, 4-byte aligned)
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// read-only-cache 32-bit load from global memory
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Rows [r0, r0 + ROWS) of a (rows, d) bf16 matrix with row stride
// `row_stride` (elements) -> shared (ROWS, DP) with leading dimension DP + 8,
// zero-filled past `rows` and past d. d is a multiple of 8 and rows start
// 16-byte aligned, so each thread moves 16 bytes at a time.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int d) {
  constexpr int LD = DP + 8;
  constexpr int V = DP / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int r = i / V;
    const int col = (i - r * V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows && col < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// A fragment (16x16) of rows [r, r + 16), columns [c, c + 16) of a
// row-major shared tile with leading dimension LD
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* tile,
                                       int LD, int r, int c) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (r + (lane >> 2)) * LD + c + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (16x8) with B[k][n] = tile[n0 + n][k0 + k]: the tile holds B
// transposed (keys against head dim for Q.K^T)
__device__ __forceinline__ void frag_bt(uint32_t b[2], const bf16* tile,
                                        int LD, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16x8) with B[k][n] = tile[k0 + k][n0 + n]: the tile holds B
// as it is (keys against head dim for P.V)
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* tile,
                                       int LD, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  b[0] = pack_u16(p[0], p[LD]);
  b[1] = pack_u16(p[8 * LD], p[9 * LD]);
}

// A fragment (16x16) from two fp32 C fragments (16x8 each, columns
// [0, 8) and [8, 16)): the C and A layouts line up, so a product's result
// feeds the next product without a shared-memory round trip
__device__ __forceinline__ void frag_a_from_c(uint32_t a[4],
                                              const float c0[4],
                                              const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace vs
