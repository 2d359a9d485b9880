// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/flash_attention.py:91, `_fwd_core` /
// `_fwd_kernel` (the forward Pallas TPU kernel behind `flash_attention`).
//
// Non-causal attention for q (B, Sq, H, D) and k, v (B, Sk, H, D) in bf16,
// read in that layout through their strides (no heads-to-batch transpose,
// any batch slice or qkv.chunk view whose strides are multiples of 8).
// Writes out (B, Sq, H, D) bf16 and the fp32 natural-log row logsumexp
// (B*H, Sq) that the backward kernels (csrc/flash_attention_bwd.cu) read.
// Keys at or beyond Sk (cross-attention Sk = 77) and query rows at or beyond
// Sq are masked inside the kernel.
//
// What bounds it on the H100: 4*Sq*Sk*D operations on (2*Sq + 2*Sk)*D*2
// bytes per (batch, head). At the SD level-0 self-attention sites (B*H =
// 256, S = 4096, D = 40) the operations bound is 0.695 ms at 989 TFLOP/s,
// but the 4.3e9 exponentials at the special-function units' 16 a clock an
// SM take 1.03 ms (the exp floor); at level 1 (S = 1024, D = 80) 0.087 ms
// of products, 0.064 ms of exps. The plain version materialises S*S fp32
// logits per (batch, head) and is bound by device-memory traffic.
//
// Design: an instantiation of csrc/attention_sm90.cuh with the online
// softmax (running row max in raw logits, P = exp2(s*c - m*c) with one FFMA
// a logit, the accumulator rescaled by exp2((m_old - m_new)*c) before each
// P.V, c = log2(e)/sqrt(D)): TMA loads into an mbarrier ring, 128-row query
// blocks split over two consumer warpgroups that ping-pong, wgmma for
// Q.K^T (shared x shared) and P.V (registers x shared), one instantiation
// per head dim D the wrapper takes: a multiple of 8 whose multiple of 16 is
// one of the backward kernels' padded dims (16-96, 128, 160).

#include "attention_sm90.cuh"

// strides: 12 values, (batch, seq, head) element strides of q, k, v, out.
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int heads, int sq, int sk,
                                      int d, const long long* strides,
                                      void* stream) {
  using namespace vs::sm90;
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Operand qo{q, strides[0], strides[1], strides[2]};
  const Operand ko{k, strides[3], strides[4], strides[5]};
  const Operand vo{v, strides[6], strides[7], strides[8]};
  const OutArgs oa{static_cast<bf16*>(out), static_cast<float*>(lse),
                   strides[9], strides[10], strides[11]};
  auto s = static_cast<cudaStream_t>(stream);
#define VS_FLASH_CASE(D)                                                     \
  case D:                                                                    \
    return (int)launch<D, OnlineSoftmax>(qo, ko, vo, oa, batch, heads, sq,   \
                                         sk, s);
  switch (d) {
    VS_FLASH_CASE(8)
    VS_FLASH_CASE(16)
    VS_FLASH_CASE(24)
    VS_FLASH_CASE(32)
    VS_FLASH_CASE(40)
    VS_FLASH_CASE(48)
    VS_FLASH_CASE(56)
    VS_FLASH_CASE(64)
    VS_FLASH_CASE(72)
    VS_FLASH_CASE(80)
    VS_FLASH_CASE(88)
    VS_FLASH_CASE(96)
    VS_FLASH_CASE(112)
    VS_FLASH_CASE(120)
    VS_FLASH_CASE(128)
    VS_FLASH_CASE(152)
    VS_FLASH_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_FLASH_CASE
}
