// Spatial self-attention with merged heads for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/spatial_attention.py:108, `_forward` /
// `_kernel` (the Pallas TPU kernel behind `spatial_self_attention`, never
// routed in the JAX package: ops/attention.py keeps its >= 32^2-token sites
// on XLA).
//
// q, k, v, out: (B, S, C) bf16 with the heads merged in C (d = C / heads, a
// multiple of 8, at most 128), read and written through (batch, row) strides
// with unit channel stride. Computes, per (batch, head, query row),
//   out = sum_j e_j v_j / sum_j e_j,   e_j = exp(min(q.k_j * d^-1/2, 60))
// over every key: no running max and no rescaling of the accumulator, and
// e rounded to bf16 for the product, as the TPU kernel does. The TPU
// kernel's key loop drops the keys past the last whole 2048-key block; this
// one walks all of them and masks the tail. Where the scaled logits are
// <= 60 the result is the softmax attention.
//
// What bounds it on the H100: 4*S*S*d operations on 8*S*d bytes per
// (batch, head). At the SD level-0 shape (B*H = 256, S = 4096, d = 40) the
// operations bound is 0.695 ms at 989 TFLOP/s and the exp floor, 4.3e9
// exponentials at the special-function units' 16 a clock an SM, 1.03 ms;
// at level 1 (S = 1024, d = 80) 0.087 ms and 0.064 ms.
//
// Design: an instantiation of csrc/attention_sm90.cuh with the clipped
// exponential, e = exp2(min(s*c, 60*log2(e))) with c = log2(e)/sqrt(d), and
// the denominator a row sum of the fp32 e in registers. The TPU kernel sums
// the bf16-rounded e through a ones column of V; the two differ by ~1e-5 of
// the sum. A ones column as its own product (P times a constant ones tile,
// one m64n8k16 wgmma a k-step) measured no faster at either U-Net level on
// the H100, so the register sum stays: no extra tile, barrier or proxy
// fence. The merged layout is read through the same wide tensor maps as
// the flash kernel's (B, S, H, D) views: heads side by side with stride d,
// row stride C (or 3C for a fused qkv projection).

#include "attention_sm90.cuh"

// strides: 8 values, the (batch, row) element strides of q, k, v, out.
// sk may be below sq (a test or a planted fault drops keys); the head dim d
// is a multiple of 8 up to 128. Returns a cudaError_t code: 0 when the
// launch was accepted.
extern "C" int vs_spatial_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int heads, int sq, int sk, int d,
                                    const long long* strides, void* stream) {
  using namespace vs::sm90;
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const Operand qo{q, strides[0], strides[1], d};
  const Operand ko{k, strides[2], strides[3], d};
  const Operand vo{v, strides[4], strides[5], d};
  const OutArgs oa{static_cast<bf16*>(out), nullptr, strides[6], strides[7],
                   d};
  auto s = static_cast<cudaStream_t>(stream);
#define VS_SPATIAL_CASE(D)                                                 \
  case D:                                                                  \
    return (int)launch<D, ClippedExp>(qo, ko, vo, oa, batch, heads, sq,    \
                                      sk, s);
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
