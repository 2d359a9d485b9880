// Fused GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/geglu_ffn.py, `_forward` / `_kernel` (the
// Pallas TPU kernel behind `geglu_ffn`).
//
// Computes out = (a * gelu_fast(gate)) @ W2^T + b2 with
// [a | gate] = x @ W1^T + b1, for x (N, C) bf16, W1 (8C, C), W2 (C, 4C) in
// the torch Linear layout, all bf16. The 4C-wide intermediate never reaches
// device memory.
//
// What bounds it on the H100: the unfused version writes and re-reads the
// (N, 8C) projection and the (N, 4C) gated product, 24*C bytes per row in
// bf16 against 24*C*C multiply-adds, so at C = 320 it is memory-bound. Fused,
// the only device-memory traffic is x, out and the weights; the weights
// (24*C*C bytes) are re-read from L2 by every row block, so the kernel is
// bounded by tensor-core issue and L2 latency, with BM multiply-adds per
// weight byte: BM = 64 at C = 320 and 640, 32 at C = 1280.
//
// Design: one block of W warps (8, or 16 when C is a multiple of 128) owns
// BM rows and the whole (BM, C) fp32 output accumulator, in registers: each
// warp owns C/W output columns. The intermediate is walked in chunks of 8W
// columns of a and the matching 8W of gate: warp w computes columns
// 8w..8w+7 of both with mma.sync (A from the x tile in shared memory, B
// straight from the L2-resident weights), applies bias and gelu_fast in
// registers, and writes the bf16 product to a (BM, 8W) shared tile that
// all warps then multiply into their output columns. The TPU's
// MAX_KERNEL_WIDTH = 640 was a VMEM limit; here the limit is the register
// accumulator, BM*C/(32W) <= 80 floats a thread, which the choice of W and
// BM meets up to C = 1280 (C a multiple of 128, or of 64 up to 320).
//
// GELU: gelu_fast, the same Horner erf polynomial as the JAX package
// (|gelu_fast - gelu| <= 4.7e-5), evaluated in fp32. The gated product is
// rounded to bf16 before the second product, as in the Pallas kernel.

#include "common.cuh"

namespace {

using vs::bf16;

__device__ __forceinline__ float erf_fast(float u) {
  // erf(u) ~ u * q(u^2 / 9) on |u| <= 3, sign(u) beyond (clip)
  const float s = fminf(u * u * (1.0f / 9.0f), 1.0f);
  float q = 1.4207271411f;
  q = q * s - 8.8140112788f;
  q = q * s + 24.913610011f;
  q = q * s - 43.054002726f;
  q = q * s + 51.767980495f;
  q = q * s - 46.861629272f;
  q = q * s + 33.590318391f;
  q = q * s - 19.508373138f;
  q = q * s + 9.1353631098f;
  q = q * s - 3.3850338503f;
  q = q * s + 1.1283787715f;
  return fminf(fmaxf(u * q, -1.0f), 1.0f);
}

__device__ __forceinline__ float gelu_fast(float x) {
  return 0.5f * x * (1.0f + erf_fast(x * 0.70710678118654752f));
}

template <int WARPS, int RT, int NTMAX>
__global__ void __launch_bounds__(WARPS * 32)
geglu_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out, int n,
                 int c) {
  constexpr int BM = RT * 16;
  constexpr int kThreads = WARPS * 32;
  constexpr int kChunk = 8 * WARPS;   // intermediate columns per step
  constexpr int kGLd = kChunk + 8;    // shared row stride of the gated tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xld = c + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // (BM, c) x tile
  bf16* gs = xs + BM * xld;                      // (BM, kChunk) gated tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int inner = 4 * c;
  const int nt = c / (8 * WARPS);         // output n8-tiles of each warp
  const int ocol0 = warp * (c / WARPS);   // first output column of the warp

  // x tile -> shared, rows past n are zero
  const int vpr = c / 8;
  for (int i = threadIdx.x; i < BM * vpr; i += kThreads) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * c + v * 8);
    *reinterpret_cast<uint4*>(xs + r * xld + v * 8) = val;
  }
  __syncthreads();

  float acc[RT][NTMAX][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < NTMAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;

  for (int j0 = 0; j0 < inner; j0 += kChunk) {
    // ---- first product: a and gate columns j0 + 8*warp .. +7
    float ha[RT][4], hg[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) ha[r][e] = hg[r][e] = 0.0f;
    const bf16* wa = w1 + (size_t)(j0 + 8 * warp + g) * c + 2 * t;
    const bf16* wg = w1 + (size_t)(inner + j0 + 8 * warp + g) * c + 2 * t;
#pragma unroll 4
    for (int k0 = 0; k0 < c; k0 += 16) {
      const uint32_t ba[2] = {vs::ldg32(wa + k0), vs::ldg32(wa + k0 + 8)};
      const uint32_t bg[2] = {vs::ldg32(wg + k0), vs::ldg32(wg + k0 + 8)};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bf16* xr = xs + (r * 16 + g) * xld + k0 + 2 * t;
        const uint32_t a[4] = {vs::ld32(xr), vs::ld32(xr + 8 * xld),
                               vs::ld32(xr + 8), vs::ld32(xr + 8 * xld + 8)};
        vs::mma_16816(ha[r], a, ba);
        vs::mma_16816(hg[r], a, bg);
      }
    }
    // ---- bias + gate in registers -> bf16 gated tile
    const int jc = 8 * warp + 2 * t;
    const float ba0 = __bfloat162float(b1[j0 + jc]);
    const float ba1 = __bfloat162float(b1[j0 + jc + 1]);
    const float bg0 = __bfloat162float(b1[inner + j0 + jc]);
    const float bg1 = __bfloat162float(b1[inner + j0 + jc + 1]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int rr = r * 16 + g;
      *reinterpret_cast<uint32_t*>(gs + rr * kGLd + jc) = vs::pack_bf16(
          (ha[r][0] + ba0) * gelu_fast(hg[r][0] + bg0),
          (ha[r][1] + ba1) * gelu_fast(hg[r][1] + bg1));
      *reinterpret_cast<uint32_t*>(gs + (rr + 8) * kGLd + jc) = vs::pack_bf16(
          (ha[r][2] + ba0) * gelu_fast(hg[r][2] + bg0),
          (ha[r][3] + ba1) * gelu_fast(hg[r][3] + bg1));
    }
    __syncthreads();

    // ---- second product: out[:, ocol0 ..] += G (BM, kChunk) . W2[:, j0 ..]^T
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bf16* gr = gs + (r * 16 + g) * kGLd + kk + 2 * t;
        a[r][0] = vs::ld32(gr);
        a[r][1] = vs::ld32(gr + 8 * kGLd);
        a[r][2] = vs::ld32(gr + 8);
        a[r][3] = vs::ld32(gr + 8 * kGLd + 8);
      }
#pragma unroll
      for (int j = 0; j < NTMAX; ++j) {
        if (j < nt) {
          const bf16* wr =
              w2 + (size_t)(ocol0 + 8 * j + g) * inner + j0 + kk + 2 * t;
          const uint32_t b[2] = {vs::ldg32(wr), vs::ldg32(wr + 8)};
#pragma unroll
          for (int r = 0; r < RT; ++r) vs::mma_16816(acc[r][j], a[r], b);
        }
      }
    }
    __syncthreads();  // the gated tile is rewritten by the next chunk
  }

  // ---- epilogue: + b2, round once to bf16
#pragma unroll
  for (int j = 0; j < NTMAX; ++j) {
    if (j < nt) {
      const int col = ocol0 + 8 * j + 2 * t;
      const float c0 = __bfloat162float(b2[col]);
      const float c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = row0 + r * 16 + g;
        if (row < n)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * c + col) =
              vs::pack_bf16(acc[r][j][0] + c0, acc[r][j][1] + c1);
        if (row + 8 < n)
          *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * c + col) =
              vs::pack_bf16(acc[r][j][2] + c0, acc[r][j][3] + c1);
      }
    }
  }
}

template <int WARPS, int RT, int NTMAX>
cudaError_t launch(const bf16* x, const bf16* w1, const bf16* b1,
                   const bf16* w2, const bf16* b2, bf16* out, int n, int c,
                   cudaStream_t stream) {
  constexpr int BM = RT * 16;
  const size_t smem =
      (size_t)(BM * (c + 8) + BM * (8 * WARPS + 8)) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ffn_kernel<WARPS, RT, NTMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM);
  geglu_ffn_kernel<WARPS, RT, NTMAX>
      <<<grid, WARPS * 32, smem, stream>>>(x, w1, b1, w2, b2, out, n, c);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_geglu_ffn(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int n,
                            int c, void* stream) {
  if (n <= 0 || c <= 0 || c % 64 != 0) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* b1b = static_cast<const bf16*>(b1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* b2b = static_cast<const bf16*>(b2);
  auto* ob = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // output n8-tiles per warp: c / (8 * warps) <= NTMAX, RT * NTMAX <= 20
  if (c % 128 == 0 && c <= 640)
    return (int)launch<16, 4, 5>(xb, w1b, b1b, w2b, b2b, ob, n, c, s);
  if (c % 128 == 0 && c <= 1280)
    return (int)launch<16, 2, 10>(xb, w1b, b1b, w2b, b2b, ob, n, c, s);
  if (c <= 320)
    return (int)launch<8, 4, 5>(xb, w1b, b1b, w2b, b2b, ob, n, c, s);
  return (int)cudaErrorInvalidValue;
}
