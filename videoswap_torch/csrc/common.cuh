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

}  // namespace vs
