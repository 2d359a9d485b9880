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

// The SMs of the current device and how many blocks of `kernel` (threads a
// block, dynamic shared memory) an SM holds at once, for persistent and
// cooperative grids; cached per (device, kernel, threads, smem), since the
// queries cost more host time than a small kernel takes on the card
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, int* sms, int* per_sm) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int sms, per_sm;
  };
  static Entry cache[32];
  static int filled = 0, next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < filled; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == kernel && e.dev == dev && e.threads == threads &&
        e.smem == smem) {
      *sms = e.sms;
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  cache[next] = Entry{kernel, dev, threads, smem, *sms, *per_sm};
  next = (next + 1) % 32;
  filled = filled < 32 ? filled + 1 : 32;
  return cudaSuccess;
}

}  // namespace vs
