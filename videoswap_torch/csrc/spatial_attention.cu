// Spatial self-attention with merged heads for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/spatial_attention.py, `_forward` / `_kernel`
// (the Pallas TPU kernel behind `spatial_self_attention`, never routed in
// the JAX package: ops/attention.py keeps its >= 32^2-token sites on XLA).
//
// q, k, v, out: (B, S, C) bf16 with the heads merged in C (d = C / heads, a
// multiple of 8, at most 128), read and written through (batch, row) strides
// with unit channel stride. Computes, per (batch, head, query row),
//   out = sum_j e_j v_j / sum_j e_j,   e_j = exp(min(q.k_j * d^-1/2, 60))
// over every key: no running max and no rescaling of the accumulator, and
// e rounded to bf16 for the product, as the TPU kernel does. The TPU
// kernel's key loop drops the keys past the last whole 2048-key block; this
// one walks all of them in tiles of 64 and masks the tail. Where the scaled
// logits are <= 60 the result is the softmax attention.
//
// What bounds it on the H100: 4*S*S*d flops per (batch, head) on 8*S*d
// bytes of q, k, v and out: at the SD level-0 shape (S = 4096, d = 40) some
// 2000 flops a byte, far above the card's balance point, so tensor-core
// issue and the exp of every logit (2.5 products per exp at d = 40) bound it.
//
// Design: one block of 4 warps per (batch, head, 64 query rows), 16 rows a
// warp, Q's A fragments held in registers for the whole key loop. K and V
// tiles of 64 keys are staged in shared memory with the head's d columns
// read by stride from the merged layout. S = Q.K^T runs on mma.sync
// (m16n8k16, bf16 -> fp32) with the head dim zero-padded to a multiple of
// 16; e is packed from the S accumulator registers straight into the A
// operand of E.V. The softmax denominator rides that product: the V tile
// carries a ones column at index d (zero past it), so column d of the
// accumulator is the row sum of the bf16 e's - at d = 40 inside the 48
// columns the n8 tiles cover anyway, at d = 80 one more n8 tile. Keys past
// S are zero rows of K and V, ones column included, and add nothing. The
// division comes once, after the last key tile.

#include <math.h>

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip = 60.0f;  // the TPU kernel's CLIP

struct Strides {
  long long b, s;  // batch and row strides, in elements
};

// Shared-memory row lengths (elements). Q and K rows hold the head dim
// padded to a multiple of 16, plus 8; V rows hold d + 8 columns (the ones
// column and zeros) plus 8 or 16, so that a row is 8 or 24 words past a
// multiple of 32: the B-fragment reads of rows 2t (t = 0..3) then fall in
// four different groups of banks.
template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int DV = D + 8;
  static constexpr int LDQ = DP + 8;
  static constexpr int LDV = DV + (DV % 16 == 0 ? 8 : 16);
  static constexpr int SMEM = ((kBQ + kBK) * LDQ + kBK * LDV) * 2;  // bytes
};

// Rows [k0, k0 + 64) of one head's V (d columns) -> shared (64, D + 8) with
// leading dimension LD: column D holds 1 for keys below sk, every other
// column past d and every row past sk is zero.
template <int D, int LD>
__device__ __forceinline__ void load_v_ones(bf16* dst, const bf16* src,
                                            long long row_stride, int k0,
                                            int sk) {
  constexpr int VC = (D + 8) / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBK * VC; i += kThreads) {
    const int r = i / VC;
    const int col = (i - r * VC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < sk) {
      if (col < D)
        val = *reinterpret_cast<const uint4*>(src + (long long)(k0 + r) * row_stride + col);
      else
        val.x = 0x3F80u;  // bf16 1.0 in the low half: column D
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
spatial_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int heads, int sq, int sk, Strides qs_, Strides ks_,
                         Strides vs_, Strides os_, float scale_log2) {
  constexpr int DP = Tile<D>::DP;  // Q.K^T contraction, padded
  constexpr int DV = Tile<D>::DV;  // V columns with the ones column
  constexpr int LDQ = Tile<D>::LDQ;
  constexpr int LDV = Tile<D>::LDV;
  constexpr int NS = kBK / 8;  // n8-tiles of S
  constexpr int NV = DV / 8;   // n8-tiles of the accumulator
  constexpr int KQ = DP / 16;  // k16-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* ksm = qsm + kBQ * LDQ;
  bf16* vsm = ksm + kBK * LDQ;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + b * qs_.b + h * D;
  const bf16* kb = k + b * ks_.b + h * D;
  const bf16* vb = v + b * vs_.b + h * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const float clip_log2 = kClip * kLog2e;

  vs::load_rows<DP, kBQ, kThreads>(qsm, qb, qs_.s, q0, sq, D);
  __syncthreads();
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) vs::frag_a(qa[kk], qsm, LDQ, wr, kk * 16);

  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // previous K/V tile fully consumed
    vs::load_rows<DP, kBK, kThreads>(ksm, kb, ks_.s, k0, sk, D);
    load_v_ones<D, LDV>(vsm, vb, vs_.s, k0, sk);
    __syncthreads();

    // ---- S = Q K^T (16 rows x 64 keys per warp)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bb[2];
        vs::frag_bt(bb, ksm, LDQ, n * 8, kk * 16);
        vs::mma_16816(s[n], qa[kk], bb);
      }

    // ---- e = exp(min(s d^-1/2, 60)): one pass, no max
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = exp2f(fminf(s[n][e] * scale_log2, clip_log2));

    // ---- [O | rowsum] += E [V | 1], E taken from the S registers
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      vs::frag_a_from_c(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        uint32_t bb[2];
        vs::frag_b(bb, vsm, LDV, kc * 16, n * 8);
        vs::mma_16816(o[n], a, bb);
      }
    }
  }

  // ---- normalise by the ones column (column D: tile D / 8, held by the
  // quad's t = 0 lane) and write the head's d columns
  const int src = lane & ~3;
  const float inv0 = 1.0f / __shfl_sync(0xffffffffu, o[D / 8][0], src);
  const float inv1 = 1.0f / __shfl_sync(0xffffffffu, o[D / 8][2], src);
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  bf16* ob = out + b * os_.b + h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os_.s + col) =
          vs::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os_.s + col) =
          vs::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int batch, int heads, int sq, int sk, Strides qs_,
                   Strides ks_, Strides vs_, Strides os_,
                   cudaStream_t stream) {
  const size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      spatial_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  spatial_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, heads, sq, sk, qs_, ks_, vs_, os_, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// strides: 8 values, the (batch, row) element strides of q, k, v, out.
// sk may be below sq (a test or a planted fault drops keys); the head dim d
// is a multiple of 8 up to 128. Returns a cudaError_t code: 0 when the
// launch was accepted.
extern "C" int vs_spatial_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int heads, int sq, int sk, int d,
                                    const long long* strides, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs_{strides[0], strides[1]};
  const Strides ks_{strides[2], strides[3]};
  const Strides vs_{strides[4], strides[5]};
  const Strides os_{strides[6], strides[7]};
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define VS_SPATIAL_CASE(D)                                                 \
  case D:                                                                  \
    return (int)launch<D>(qb, kb, vb, ob, batch, heads, sq, sk, qs_, ks_,  \
                          vs_, os_, s);
  switch (d) {
    VS_SPATIAL_CASE(8)
    VS_SPATIAL_CASE(16)
    VS_SPATIAL_CASE(24)
    VS_SPATIAL_CASE(32)
    VS_SPATIAL_CASE(40)
    VS_SPATIAL_CASE(48)
    VS_SPATIAL_CASE(56)
    VS_SPATIAL_CASE(64)
    VS_SPATIAL_CASE(72)
    VS_SPATIAL_CASE(80)
    VS_SPATIAL_CASE(88)
    VS_SPATIAL_CASE(96)
    VS_SPATIAL_CASE(104)
    VS_SPATIAL_CASE(112)
    VS_SPATIAL_CASE(120)
    VS_SPATIAL_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_SPATIAL_CASE
}
