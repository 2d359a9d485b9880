// Fused AnimateDiff temporal transformer for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/fused_temporal.py, `_forward` (rows ordered
// (location, frame)) and `_forward_4d` (the frame-major (B, F, HW, C)
// layout): the Pallas TPU kernel `_kernel` behind
// `fused_temporal_transformer` and `fused_temporal_transformer_bfhw`.
//
// Computes everything TemporalTransformer3DModel does after its per-frame
// GroupNorm (which stays outside: its statistics span the locations of a
// frame), for one transformer block:
//   h = g @ Win^T + b_in                                    (fp32)
//   2 x [ a = bf16(LayerNorm(h) + pe[frame])
//         q = bf16(a Wq^T / sqrt(d)), k = bf16(a Wk^T), v = bf16(a Wv^T)
//         per location and head: o = bf16(softmax(q k^T)) v over F frames
//         h += bf16(o) Wo^T + bo ]
//   include_ffn: h += bf16(gelu_fast-GEGLU(bf16(LayerNorm(h)))) W2^T + b2
//                out = bf16(x + bf16(h) Wout^T + b_out)
//   otherwise:   out = bf16(h)   (ffn_tail finishes outside, C = 640)
// Matrices are bf16 in the torch Linear layout ([out, in]); LayerNorm
// scales and biases and every bias are fp32; the hidden state h stays fp32
// in registers for the whole module.
//
// What bounds it on the H100: about 44 C^2 + 8 F C flops a row with the FFN
// (18 C^2 + 8 F C without) against 6 C bytes of g, x and out a row, so at
// C = 320 it is bound by the tensor cores (0.60 ms for the level-0 call's
// 131072 rows at 989 TFLOP/s, against 0.075 ms of device-memory traffic).
// The weights (44 C^2 bytes with the FFN, 4.5 MB at C = 320) do not fit in
// shared memory; they stay in L2 and every block reads them once, so a
// block of R rows costs 44 C^2 bytes of L2 traffic: RT * 16 = 64 rows per
// block at C <= 320, 32 at C = 640.
//
// Design: one block of 8 warps owns up to 64 rows (P whole locations of F
// frames) and keeps h for them in mma.sync accumulator registers, each
// warp owning C/8 columns. Every product is mma.sync m16n8k16 (bf16 in,
// fp32 accumulate) with A from shared memory and B loaded as fragments
// straight from the L2-resident weights, with no shared staging. LayerNorm
// statistics are warp shuffles plus a cross-warp sum in shared memory.
// q, k and v go to shared memory as bf16 tiles; the frame attention of one
// (16-query tile, head) pair is one warp's work: S = q k^T over the keys of
// the tile's locations (a 16 x <= 64 product, keys of other locations
// masked), a max-subtracted softmax in registers (the TPU kernel's max-free
// exp with logits clipped at 60 was a VPU device; the F <= 32 logits of a
// row are in registers here), P reused as the A operand of P.V without leaving registers, and the
// output written over q. The GEGLU intermediate (4C) is walked in 64-column
// chunks through a small shared tile, never reaching device memory; the TPU
// kernel's 128-row tiles, block-diagonal bias, ones-vector row sums and
// shared logit scratch are not carried over. The frame-major layout changes
// only the rows a block reads and writes (strided by HW), not the compute.

#include <math.h>

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax8 = 10;       // head dim <= 80
constexpr int kGLd = 8 * kWarps + 8;  // shared row stride of the GEGLU tile

struct AttnW {
  const float* ln_g;
  const float* ln_b;
  const bf16* wq;
  const bf16* wk;
  const bf16* wv;
  const bf16* wo;
  const float* bo;
};

struct Params {
  const bf16* g;
  const bf16* x;
  bf16* out;
  const bf16* pe;  // (F, C)
  const bf16* w_in;
  const float* b_in;
  AttnW att[2];
  const float* ff_g;
  const float* ff_b;
  const bf16* w1;  // (8C, C)
  const float* b1;
  const bf16* w2;  // (C, 4C)
  const float* b2;
  const bf16* w_out;
  const float* b_out;
  int c, heads, f, locs, include_ffn, layout;
  long long n_loc;  // layout 0: locations L; layout 1: HW
  float scale;
};

// global row of tile row r, or -1 past the data (layout 0: (L*F, C) rows
// ordered (location, frame); layout 1: (B, F, HW, C), batch blockIdx.y)
__device__ __forceinline__ long long row_of(const Params& p, int r) {
  if (r >= p.locs * p.f) return -1;
  const int loc = r / p.f;
  const int fr = r - loc * p.f;
  const long long l = (long long)blockIdx.x * p.locs + loc;
  if (l >= p.n_loc) return -1;
  if (p.layout == 0) return l * p.f + fr;
  return ((long long)blockIdx.y * p.f + fr) * p.n_loc + l;
}

__device__ __forceinline__ float erf_fast(float u) {
  // erf(u) ~ u * q(u^2 / 9) on |u| <= 3, sign(u) beyond (clip): the Horner
  // form of videoswap_tpu/ops/geglu_ffn.py's fit, as in geglu_ffn.cu
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

template <int RT, int NT>
__device__ __forceinline__ void zero(float (&acc)[RT][NT][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
}

// acc[r][j] += A[r*16 .., 0:K] . W[col0 + 8j .., 0:K]^T: A a shared tile
// (leading dimension lda), W row-major [out][in] with row stride K in
// global memory, nt <= NT n8-tiles of output columns from col0
template <int RT, int NT>
__device__ __forceinline__ void gemm(float (&acc)[RT][NT][4], const bf16* a,
                                     int lda, const bf16* __restrict__ w,
                                     int col0, int nt, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) vs::frag_a(af[r], a, lda, r * 16, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const bf16* wr = w + (size_t)(col0 + 8 * j + g) * K + k0 + 2 * t;
        const uint32_t b[2] = {vs::ldg32(wr), vs::ldg32(wr + 8)};
#pragma unroll
        for (int r = 0; r < RT; ++r) vs::mma_16816(acc[r][j], af[r], b);
      }
    }
  }
}

template <int RT, int NT>
__device__ __forceinline__ void add_bias(float (&acc)[RT][NT][4],
                                         const float* __restrict__ b,
                                         int col0, int nt) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int col = col0 + 8 * j + 2 * t;
      const float b0 = b[col], b1 = b[col + 1];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r][j][0] += b0;
        acc[r][j][1] += b1;
        acc[r][j][2] += b0;
        acc[r][j][3] += b1;
      }
    }
  }
}

// bf16(acc * mul) -> shared tile (row r*16 + g (+8), columns col0 + 8j + 2t)
template <int RT, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[RT][NT][4],
                                           bf16* dst, int ld, int col0,
                                           int nt, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int col = col0 + 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = r * 16 + g;
        *reinterpret_cast<uint32_t*>(dst + row * ld + col) =
            vs::pack_bf16(acc[r][j][0] * mul, acc[r][j][1] * mul);
        *reinterpret_cast<uint32_t*>(dst + (row + 8) * ld + col) =
            vs::pack_bf16(acc[r][j][2] * mul, acc[r][j][3] * mul);
      }
    }
  }
}

// bf16(LayerNorm(h) * gamma + beta (+ pe[frame])) -> shared tile. Row
// statistics: each warp sums its columns (quad shuffles), the 8 partial sums
// of a row meet in `red` (two buffers: mean, then the centred variance).
// Starts with a barrier-free reduction and writes dst only after two
// __syncthreads, so every earlier read of dst has finished.
template <int RT, int NT>
__device__ void layernorm_to_smem(const float (&h)[RT][NT][4],
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  const bf16* __restrict__ pe, const Params& p,
                                  int col0, int nt, float* red, bf16* dst,
                                  int ld) {
  constexpr int R = RT * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float inv_c = 1.0f / (float)p.c;
  float mean[RT][2], rstd[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) s += h[r][j][2 * hf] + h[r][j][2 * hf + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[warp * R + r * 16 + g + 8 * hf] = s;
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * R + r * 16 + g + 8 * hf];
      mean[r][hf] = s * inv_c;
    }
  float* red2 = red + kWarps * R;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          const float z0 = h[r][j][2 * hf] - mean[r][hf];
          const float z1 = h[r][j][2 * hf + 1] - mean[r][hf];
          s += z0 * z0 + z1 * z1;
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red2[warp * R + r * 16 + g + 8 * hf] = s;
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red2[w * R + r * 16 + g + 8 * hf];
      rstd[r][hf] = rsqrtf(s * inv_c + 1e-6f);
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int col = col0 + 8 * j + 2 * t;
      const float g0 = gamma[col], g1 = gamma[col + 1];
      const float b0 = beta[col], b1 = beta[col + 1];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r * 16 + g + 8 * hf;
          float v0 = (h[r][j][2 * hf] - mean[r][hf]) * rstd[r][hf] * g0 + b0;
          float v1 =
              (h[r][j][2 * hf + 1] - mean[r][hf]) * rstd[r][hf] * g1 + b1;
          if (pe != nullptr) {
            const bf16* pr = pe + (size_t)(row % p.f) * p.c + col;
            v0 += __bfloat162float(pr[0]);
            v1 += __bfloat162float(pr[1]);
          }
          *reinterpret_cast<uint32_t*>(dst + row * ld + col) =
              vs::pack_bf16(v0, v1);
        }
    }
  }
}

// Frame attention of the tile: one warp per (16-query tile, head) pair.
// q (scaled), k, v are bf16 tiles with rows ordered (location, frame); the
// output o of each pair overwrites that pair's q block.
template <int RT>
__device__ void frame_attention(const Params& p, bf16* qs, const bf16* ks,
                                const bf16* vsm, int ld) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d = p.c / p.heads;
  const int d8 = d / 8;
  const int rows = p.locs * p.f;
  const int npairs = RT * p.heads;
  for (int pi = warp; pi < npairs; pi += kWarps) {
    const int qt = pi / p.heads;
    const int hd = pi - qt * p.heads;
    const int r0 = qt * 16;
    if (r0 >= rows) continue;
    const int loc_lo = r0 / p.f;
    const int loc_hi = min(r0 + 15, rows - 1) / p.f;
    const int k_lo = (loc_lo * p.f) & ~15;
    const int k_hi = min(((loc_hi + 1) * p.f + 15) & ~15, RT * 16);
    const int nk = (k_hi - k_lo) / 8;  // key n8-tiles, even
    const int c0 = hd * d;

    float s[2 * RT][4];
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t a[4];
      vs::frag_a(a, qs, ld, r0, c0 + k0);
      const bool half = k0 + 8 >= d;  // head dims k0+8.. belong to the next head
      if (half) a[2] = a[3] = 0u;
#pragma unroll
      for (int j = 0; j < 2 * RT; ++j) {
        if (j < nk) {
          uint32_t b[2];
          vs::frag_bt(b, ks, ld, k_lo + 8 * j, c0 + k0);
          if (half) b[1] = 0u;
          vs::mma_16816(s[j], a, b);
        }
      }
    }

    // softmax over the keys of the query's own location
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
      const int lq = row / p.f;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * RT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k_lo + 8 * j + 2 * t + e;
          const bool ok = j < nk && key < rows && key / p.f == lq;
          const float v = ok ? s[j][2 * hf + e] : -INFINITY;
          s[j][2 * hf + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * RT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = s[j][2 * hf + e];
          const float ex = (v == -INFINITY) ? 0.0f : __expf(v - mx);
          s[j][2 * hf + e] = ex;
          sum += ex;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;  // rows past the data
#pragma unroll
      for (int j = 0; j < 2 * RT; ++j) {
        s[j][2 * hf] *= inv;
        s[j][2 * hf + 1] *= inv;
      }
    }

    // o = bf16(P) . v, P straight from the logit registers
    float o[kDMax8][4];
#pragma unroll
    for (int j = 0; j < kDMax8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < RT; ++kk) {
      if (2 * kk < nk) {
        uint32_t a[4];
        vs::frag_a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < kDMax8; ++j) {
          if (j < d8) {
            uint32_t b[2];
            vs::frag_b(b, vsm, ld, k_lo + 16 * kk, c0 + 8 * j);
            vs::mma_16816(o[j], a, b);
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kDMax8; ++j) {
      if (j < d8) {
        const int col = c0 + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(qs + (r0 + g) * ld + col) =
            vs::pack_bf16(o[j][0], o[j][1]);
        *reinterpret_cast<uint32_t*>(qs + (r0 + g + 8) * ld + col) =
            vs::pack_bf16(o[j][2], o[j][3]);
      }
    }
  }
}

template <int RT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_temporal_kernel(const Params p) {
  constexpr int R = RT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = p.c;
  const int ld = c + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // LayerNorm output / g / bf16(h)
  bf16* qs = as + R * ld;                        // q, then the attention output
  bf16* ks = qs + R * ld;                        // k, then the GEGLU tile
  bf16* vsm = ks + R * ld;
  float* red = reinterpret_cast<float*>(vsm + R * ld);  // 2 x (warps, R)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt = c / (8 * kWarps);   // output n8-tiles of each warp
  const int col0 = warp * (c / kWarps);

  // g tile -> shared, rows past the data zero
  const int vpr = c / 8;
  for (int i = threadIdx.x; i < R * vpr; i += kThreads) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    const long long gr = row_of(p, r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0)
      val = *reinterpret_cast<const uint4*>(p.g + gr * c + v * 8);
    *reinterpret_cast<uint4*>(as + r * ld + v * 8) = val;
  }
  __syncthreads();

  // proj_in
  float h[RT][NT][4];
  zero(h);
  gemm(h, as, ld, p.w_in, col0, nt, c);
  add_bias(h, p.b_in, col0, nt);

#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const AttnW& aw = p.att[blk];
    layernorm_to_smem(h, aw.ln_g, aw.ln_b, p.pe, p, col0, nt, red, as, ld);
    __syncthreads();
    {
      float acc[RT][NT][4];
      zero(acc);
      gemm(acc, as, ld, aw.wq, col0, nt, c);
      store_tile(acc, qs, ld, col0, nt, p.scale);
      zero(acc);
      gemm(acc, as, ld, aw.wk, col0, nt, c);
      store_tile(acc, ks, ld, col0, nt, 1.0f);
      zero(acc);
      gemm(acc, as, ld, aw.wv, col0, nt, c);
      store_tile(acc, vsm, ld, col0, nt, 1.0f);
    }
    __syncthreads();
    frame_attention<RT>(p, qs, ks, vsm, ld);
    __syncthreads();
    gemm(h, qs, ld, aw.wo, col0, nt, c);
    add_bias(h, aw.bo, col0, nt);
  }

  if (!p.include_ffn) {
    // emit h (bf16); ff_norm, the FFN and proj_out run outside
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long gr = row_of(p, r * 16 + g + 8 * hf);
        if (gr < 0) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            const int col = col0 + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(p.out + gr * c + col) =
                vs::pack_bf16(h[r][j][2 * hf], h[r][j][2 * hf + 1]);
          }
        }
      }
    return;
  }

  // GEGLU FFN, the 4C intermediate in chunks of 8 * kWarps columns
  layernorm_to_smem(h, p.ff_g, p.ff_b, nullptr, p, col0, nt, red, as, ld);
  __syncthreads();
  bf16* gt = ks;
  const int inner = 4 * c;
  for (int j0 = 0; j0 < inner; j0 += 8 * kWarps) {
    float ha[RT][4], hg[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) ha[r][e] = hg[r][e] = 0.0f;
    const bf16* wa = p.w1 + (size_t)(j0 + 8 * warp + g) * c + 2 * t;
    const bf16* wg = p.w1 + (size_t)(inner + j0 + 8 * warp + g) * c + 2 * t;
    for (int k0 = 0; k0 < c; k0 += 16) {
      const uint32_t ba[2] = {vs::ldg32(wa + k0), vs::ldg32(wa + k0 + 8)};
      const uint32_t bg[2] = {vs::ldg32(wg + k0), vs::ldg32(wg + k0 + 8)};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        uint32_t a[4];
        vs::frag_a(a, as, ld, r * 16, k0);
        vs::mma_16816(ha[r], a, ba);
        vs::mma_16816(hg[r], a, bg);
      }
    }
    const int jc = 8 * warp + 2 * t;
    const float ba0 = p.b1[j0 + jc], ba1 = p.b1[j0 + jc + 1];
    const float bg0 = p.b1[inner + j0 + jc], bg1 = p.b1[inner + j0 + jc + 1];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int rr = r * 16 + g;
      *reinterpret_cast<uint32_t*>(gt + rr * kGLd + jc) = vs::pack_bf16(
          (ha[r][0] + ba0) * gelu_fast(hg[r][0] + bg0),
          (ha[r][1] + ba1) * gelu_fast(hg[r][1] + bg1));
      *reinterpret_cast<uint32_t*>(gt + (rr + 8) * kGLd + jc) = vs::pack_bf16(
          (ha[r][2] + ba0) * gelu_fast(hg[r][2] + bg0),
          (ha[r][3] + ba1) * gelu_fast(hg[r][3] + bg1));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 8 * kWarps; kk += 16) {
      uint32_t a[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) vs::frag_a(a[r], gt, kGLd, r * 16, kk);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const bf16* wr =
              p.w2 + (size_t)(col0 + 8 * j + g) * inner + j0 + kk + 2 * t;
          const uint32_t b[2] = {vs::ldg32(wr), vs::ldg32(wr + 8)};
#pragma unroll
          for (int r = 0; r < RT; ++r) vs::mma_16816(h[r][j], a[r], b);
        }
      }
    }
    __syncthreads();  // the tile is rewritten by the next chunk
  }
  add_bias(h, p.b2, col0, nt);

  // proj_out on bf16(h), + b_out + x
  store_tile(h, as, ld, col0, nt, 1.0f);
  __syncthreads();
  float acc[RT][NT][4];
  zero(acc);
  gemm(acc, as, ld, p.w_out, col0, nt, c);
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long gr = row_of(p, r * 16 + g + 8 * hf);
      if (gr < 0) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const int col = col0 + 8 * j + 2 * t;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(p.x + gr * c + col);
          *reinterpret_cast<uint32_t*>(p.out + gr * c + col) = vs::pack_bf16(
              __low2float(xv) + acc[r][j][2 * hf] + p.b_out[col],
              __high2float(xv) + acc[r][j][2 * hf + 1] + p.b_out[col + 1]);
        }
      }
    }
}

template <int RT, int NT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int R = RT * 16;
  const size_t smem = (size_t)4 * R * (p.c + 8) * sizeof(bf16) +
                      (size_t)2 * kWarps * R * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_temporal_kernel<RT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.n_loc + p.locs - 1) / p.locs;
  const dim3 grid((unsigned)tiles, (unsigned)batch);
  fused_temporal_kernel<RT, NT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: g, x, out, pe, then the parameters in the order of
// videoswap_tpu/ops/fused_temporal.py `flatten_tt_params` (one block):
// w_in, b_in, 2 x (ln_g, ln_b, wq, wk, wv, wo, bo), and with the FFN
// ff_g, ff_b, w1, b1, w2, b2, w_out, b_out. layout 0: g, x, out are
// (n_loc * f, c) rows ordered (location, frame), batch = 1; layout 1: they
// are (batch, f, n_loc, c). Returns a cudaError_t code: 0 when the launch
// was accepted.
extern "C" int vs_fused_temporal(const void* const* ptrs, int n_ptrs, int c,
                                 int heads, int f, int include_ffn,
                                 int layout, long long n_loc, int batch,
                                 float scale, void* stream) {
  const int want = include_ffn ? 28 : 20;
  if (n_ptrs != want || c <= 0 || c % 64 != 0 || c > 640 || heads <= 0 ||
      c % heads != 0 || (c / heads) % 8 != 0 || c / heads > 8 * kDMax8 ||
      f <= 0 || n_loc <= 0 || batch <= 0 || (layout == 0 && batch != 1))
    return (int)cudaErrorInvalidValue;
  const int rt = c <= 320 ? 4 : 2;
  if (f > rt * 16) return (int)cudaErrorInvalidValue;
  Params p;
  int i = 0;
  auto nb = [&]() { return static_cast<const bf16*>(ptrs[i++]); };
  auto nf = [&]() { return static_cast<const float*>(ptrs[i++]); };
  p.g = nb();
  p.x = nb();
  p.out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.pe = nb();
  p.w_in = nb();
  p.b_in = nf();
  for (int j = 0; j < 2; ++j) {
    p.att[j].ln_g = nf();
    p.att[j].ln_b = nf();
    p.att[j].wq = nb();
    p.att[j].wk = nb();
    p.att[j].wv = nb();
    p.att[j].wo = nb();
    p.att[j].bo = nf();
  }
  p.ff_g = p.ff_b = p.b1 = p.b2 = p.b_out = nullptr;
  p.w1 = p.w2 = p.w_out = nullptr;
  if (include_ffn) {
    p.ff_g = nf();
    p.ff_b = nf();
    p.w1 = nb();
    p.b1 = nf();
    p.w2 = nb();
    p.b2 = nf();
    p.w_out = nb();
    p.b_out = nf();
  }
  p.c = c;
  p.heads = heads;
  p.f = f;
  p.locs = rt * 16 / f;
  p.include_ffn = include_ffn;
  p.layout = layout;
  p.n_loc = n_loc;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  if (rt == 4) return (int)launch<4, 5>(p, batch, s);
  return (int)launch<2, 10>(p, batch, s);
}
