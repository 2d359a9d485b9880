// Frame-axis (temporal) multi-head self-attention for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/temporal_attention.py, `_forward` / `_kernel`
// (the Pallas TPU kernel behind `temporal_attention`).
//
// q, k, v, out: (L*F, C) bf16, rows ordered (location, frame); each of the
// L locations attends over its own F <= 32 frames, per head (d = C / heads).
// Softmax is the usual max-subtracted one in fp32, which is what the JAX
// package's `_xla_reference` computes; the TPU kernel's max-free exp with
// logits clipped at 60 was a VPU trick and is not carried over.
//
// What bounds it on the H100: each location does 4*F*F*C flops on 8*F*C
// bytes of q, k, v and out, F/2 = 8 flops a byte at F = 16, far below the
// card's balance point, so it is bound by device-memory traffic (about 168
// MB a call at the level-0 shape L = 8192, C = 320). Tensor cores would not
// help a 16x16xd product.
//
// Design: one block per (location, head). It stages the F x d slices of q,
// k and v in shared memory as fp32 (row stride d + 1 to keep the dot
// products free of bank conflicts), computes the F x F logits on CUDA cores
// with one thread per (query, key) pair, takes the softmax with one warp per
// query row (warp shuffles, F <= 32), and writes P.V straight back to the
// (location, frame) rows in bf16. q, k and v are read once and out written
// once; nothing else touches device memory.

#include <math.h>

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
temporal_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int f, int c, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = f + 1;
  float* qs = smem;
  float* ks = qs + f * ld;
  float* vsm = ks + f * ld;
  float* ps = vsm + f * ld;  // (f, f) logits, then probabilities

  const size_t base = (size_t)blockIdx.x * f * c + (size_t)blockIdx.y * d;
  for (int i = threadIdx.x; i < f * d; i += kThreads) {
    const int r = i / d;
    const int e = i - r * d;
    const size_t off = base + (size_t)r * c + e;
    qs[r * ld + e] = __bfloat162float(q[off]);
    ks[r * ld + e] = __bfloat162float(k[off]);
    vsm[r * ld + e] = __bfloat162float(v[off]);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < f * f; p += kThreads) {
    const int i = p / f;
    const int j = p - i * f;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float s = 0.0f;
    for (int e = 0; e < d; ++e) s = fmaf(qi[e], kj[e], s);
    ps[i * pld + j] = s * scale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < f; i += kThreads / 32) {
    const float s = lane < f ? ps[i * pld + lane] : -INFINITY;
    const float m = warp_max(s);
    const float e = lane < f ? expf(s - m) : 0.0f;
    const float sum = warp_sum(e);
    if (lane < f) ps[i * pld + lane] = e / sum;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < f * d; o += kThreads) {
    const int i = o / d;
    const int e = o - i * d;
    const float* pi = ps + i * pld;
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) acc = fmaf(pi[j], vsm[j * ld + e], acc);
    out[base + (size_t)i * c + e] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_temporal_attention(const void* q, const void* k,
                                     const void* v, void* out, int locations,
                                     int f, int c, int heads, void* stream) {
  if (locations <= 0 || f <= 0 || f > 32 || heads <= 0 || c % heads != 0)
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t smem = (size_t)(3 * f * (d + 1) + f * (f + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(locations, heads);
  temporal_attention_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), f, c, d,
      1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}
