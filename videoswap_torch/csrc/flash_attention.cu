// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/flash_attention.py, `_fwd_core` / `_fwd_kernel`
// (the forward Pallas TPU kernel behind `flash_attention`).
//
// Non-causal attention for q (B, Sq, H, D) and k, v (B, Sk, H, D) in bf16,
// read in that layout through their strides (no heads-to-batch transpose).
// Writes out (B, Sq, H, D) bf16 and the fp32 row logsumexp (B*H, Sq) that a
// backward pass needs. Keys at or beyond Sk (cross-attention Sk = 77) and
// query rows at or beyond Sq are masked inside the kernel.
//
// What bounds it on the H100: at the SD level-0 self-attention sites
// (S = 4096, d = 40) the plain version materialises S*S fp32 logits per
// (batch, head) - 64 MB each, 16 GB at B*H = 256 - so it is bound by
// device-memory traffic. Tiled with an online softmax, the logits never
// leave the SM and the work is 4*Sq*Sk*d flops on (2*Sq + 2*Sk)*d*2 bytes,
// which at d = 40 is bound by tensor-core issue and the exp/max work of the
// softmax (d = 40 gives only 2.5 products per exp).
//
// Design: a block of 4 warps owns 64 query rows of one (batch, head); each
// warp owns 16 rows. The block walks the keys in tiles of 64: K and V tiles
// are staged in shared memory (head dim zero-padded to DP, a multiple of
// 16: 40 -> 48, 80 and 160 unchanged), S = Q.K^T runs on mma.sync with the
// accumulator in registers, the running max and sum are kept per row with
// quad shuffles, P is re-packed from the S accumulator registers straight
// into the A operand of P.V (no shared-memory round trip), and the fp32
// output accumulator is rescaled in registers. The exponentials use exp2
// with the scale folded into log2(e) * d^-0.5.

#include <math.h>

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;

template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int d) {
  vs::load_rows<DP, 64, kThreads>(dst, src, row_stride, r0, rows, d);
}

struct Strides {
  long long b, s, h;  // in elements
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int heads, int sq, int sk, int d,
                 Strides qs_, Strides ks_, Strides vs_, Strides os_,
                 float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int NS = kBK / 8;   // n8-tiles of S
  constexpr int NO = DP / 8;    // n8-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* ksm = qsm + kBQ * LD;
  bf16* vsm = ksm + kBK * LD;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  load_tile<DP>(qsm, qb, qs_.s, q0, sq, d);

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // previous K/V tile fully consumed
    load_tile<DP>(ksm, kb, ks_.s, k0, sk, d);
    load_tile<DP>(vsm, vb, vs_.s, k0, sk, d);
    __syncthreads();

    // ---- S = Q K^T (16 rows x 64 keys per warp)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const bf16* qr = qsm + (wr + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {vs::ld32(qr), vs::ld32(qr + 8 * LD),
                             vs::ld32(qr + 8), vs::ld32(qr + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kr = ksm + (n * 8 + g) * LD + kk + 2 * t;
        const uint32_t bb[2] = {vs::ld32(kr), vs::ld32(kr + 8)};
        vs::mma_16816(s[n], a, bb);
      }
    }

    // ---- scale, mask keys >= sk, online softmax (rows g and g + 8)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float val = col < sk ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the first tile always holds key 0, so mx is finite here
      alpha[r] = exp2f(m_i[r] - mx[r]);
      m_i[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_i[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // ---- O += P V, P taken from the S registers as the A operand
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {
          vs::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          vs::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          vs::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          vs::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vr = vsm + (kc * 16 + 2 * t) * LD + n * 8 + g;
        const uint32_t bb[2] = {vs::pack_u16(vr[0], vr[LD]),
                                vs::pack_u16(vr[8 * LD], vr[9 * LD])};
        vs::mma_16816(o[n], a, bb);
      }
    }
  }

  // ---- finalize: full row sums across the quad, normalise, write
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const float inv0 = 1.0f / l_i[0];
  const float inv1 = 1.0f / l_i[1];
  bf16* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < d) {
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os_.s + col) =
            vs::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os_.s + col) =
            vs::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  if (t == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    if (r0 < sq) lse[(long long)bh * sq + r0] = (m_i[0] + log2f(l_i[0])) * kLn2;
    if (r1 < sq) lse[(long long)bh * sq + r1] = (m_i[1] + log2f(l_i[1])) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, int batch, int heads, int sq, int sk, int d,
                   Strides qs_, Strides ks_, Strides vs_, Strides os_,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 2 * kBK) * (DP + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, heads, sq, sk, d, qs_, ks_, vs_, os_, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 values, (batch, seq, head) element strides of q, k, v, out.
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int heads, int sq, int sk,
                                      int d, const long long* strides,
                                      void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs_{strides[0], strides[1], strides[2]};
  const Strides ks_{strides[3], strides[4], strides[5]};
  const Strides vs_{strides[6], strides[7], strides[8]};
  const Strides os_{strides[9], strides[10], strides[11]};
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  auto* lb = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
#define VS_FLASH_CASE(DP)                                                   \
  case DP:                                                                  \
    return (int)launch<DP>(qb, kb, vb, ob, lb, batch, heads, sq, sk, d, qs_, \
                           ks_, vs_, os_, s);
  switch (dp) {
    VS_FLASH_CASE(16)
    VS_FLASH_CASE(32)
    VS_FLASH_CASE(48)
    VS_FLASH_CASE(64)
    VS_FLASH_CASE(80)
    VS_FLASH_CASE(96)
    VS_FLASH_CASE(128)
    VS_FLASH_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_FLASH_CASE
}
