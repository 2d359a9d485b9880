// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel.
//
// Replaces: videoswap_tpu/ops/flash_attention.py, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (the two Pallas TPU kernels of `_bwd_core`).
//
// Inputs as the forward (csrc/flash_attention.cu) saw them: q (B, Sq, H, D)
// and k, v (B, Sk, H, D) in bf16, read through their strides, the upstream
// gradient dO (B, Sq, H, D) bf16, the forward's natural-log row logsumexp
// lse (B*H, Sq) fp32, and D = rowsum(dO * O) (B*H, Sq) fp32, which the
// wrapper computes before the launches (as the JAX package does outside its
// kernels). With p = exp(q k^T * s - lse), s = D^-0.5:
//
//   dv = p^T dO,   ds = p (dO v^T - D),   dq = ds k s,   dk = ds^T q s
//
// The two kernels split the work as the JAX package's two kernels do, so
// nothing is shared between blocks and no atomics are needed:
//
// - dQ: a block owns 64 query rows of one (batch, head), 16 per warp, and
//   walks the keys in tiles of 64. It recomputes S = Q K^T and dP = dO V^T
//   for 16 keys at a time, forms dS in the S registers and accumulates
//   dS K into an fp32 dQ accumulator in registers.
// - dK/dV: a block owns 64 keys, 16 per warp, and walks the queries in
//   tiles of 64. It recomputes S^T = K Q^T and dP^T = V dO^T for 16 queries
//   at a time and accumulates P^T dO and dS^T Q into fp32 dV and dK
//   accumulators in registers.
//
// Working on 16 columns at a time keeps the transient S/dP fragments at 16
// registers a thread, so the two DP-wide accumulators of the dK/dV kernel
// (2 x DP/2 floats a thread, 160 at DP = 160) fit the register file without
// a spill. P and dS go from the C registers of one mma.sync straight into
// the A operand of the next (the fragment layouts line up); they are
// rounded to bf16 there, as the forward rounds P.
//
// What bounds it on the H100: each kernel reads q, k, v and dO once per
// tile pass and does 6 (dQ) or 8 (dK/dV) * Sq * Sk * D flops per (batch,
// head); at the SD level-0 sites (S = 4096, D = 40) that is far above the
// card's flop/byte balance, so tensor-core issue and the exp work bound it.
// The head dim is zero-padded to DP, a multiple of 16, in shared memory;
// keys at or beyond Sk get p = 0, and query rows at or beyond Sq get
// lse = +inf (p = 0) and zero dO, so the padding contributes nothing.

#include <math.h>

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kRows = 64;      // rows a block owns (16 per warp)
constexpr int kTile = 64;      // rows of the tile a block walks
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads, sq, sk, d;
  float scale, scale_log2;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
};

template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int d) {
  vs::load_rows<DP, kTile, kThreads>(dst, src, row_stride, r0, rows, d);
}

// fp32 accumulator rows (g, g + 8) of a warp's 16 rows -> bf16 at
// out[row * row_stride + col], columns < d, rows < rows_valid
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           int r0, int rows_valid, int d,
                                           const float acc[NO][4],
                                           float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    if (r0 + g < rows_valid)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + g) * row_stride + col) =
          vs::pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + g + 8 < rows_valid)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + g + 8) * row_stride + col) =
          vs::pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// ------------------------------------------------------------------- dQ
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* dosm = qsm + kRows * LD;
  bf16* ksm = dosm + kRows * LD;
  bf16* vsm = ksm + kTile * LD;

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  load_tile<DP>(qsm, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.sq, a.d);
  load_tile<DP>(dosm, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.sq,
                a.d);
  // this thread's two rows: lse in log2 units (+inf past Sq) and D
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    const bool ok = row < a.sq;
    lse2[r] = ok ? a.lse[(long long)bh * a.sq + row] * kLog2e : INFINITY;
    dd[r] = ok ? a.delta[(long long)bh * a.sq + row] : 0.0f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  for (int k0 = 0; k0 < a.sk; k0 += kTile) {
    __syncthreads();  // previous K/V tile fully consumed (and Q/dO loaded)
    load_tile<DP>(ksm, kb, a.ks.s, k0, a.sk, a.d);
    load_tile<DP>(vsm, vb, a.vs.s, k0, a.sk, a.d);
    __syncthreads();

#pragma unroll 1
    for (int kc = 0; kc < kTile; kc += 16) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows x 16 keys
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t aq[4], ado[4];
        vs::frag_a(aq, qsm, LD, wr, kk);
        vs::frag_a(ado, dosm, LD, wr, kk);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bk[2], bv[2];
          vs::frag_bt(bk, ksm, LD, kc + n * 8, kk);
          vs::frag_bt(bv, vsm, LD, kc + n * 8, kk);
          vs::mma_16816(s[n], aq, bk);
          vs::mma_16816(dp[n], ado, bv);
        }
      }
      // dS = P (dP - D), P = exp(S s - lse), keys >= Sk masked
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + kc + n * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          const float p =
              col < a.sk ? exp2f(s[n][e] * a.scale_log2 - lse2[r]) : 0.0f;
          s[n][e] = p * (dp[n][e] - dd[r]);
        }
      // dQ += dS K (K as it is: keys x head dim)
      uint32_t ads[4];
      vs::frag_a_from_c(ads, s[0], s[1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bk[2];
        vs::frag_b(bk, ksm, LD, kc, n * 8);
        vs::mma_16816(acc[n], ads, bk);
      }
    }
  }
  store_rows<NO>(a.dq + b * a.dqs.b + h * a.dqs.h, a.dqs.s, q0 + wr, a.sq,
                 a.d, acc, a.scale);
}

// ---------------------------------------------------------------- dK/dV
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* vsm = ksm + kRows * LD;
  bf16* qsm = vsm + kRows * LD;
  bf16* dosm = qsm + kTile * LD;
  float* lse2s = reinterpret_cast<float*>(dosm + kTile * LD);
  float* dds = lse2s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int j0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr = warp * 16;

  load_tile<DP>(ksm, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, j0, a.sk, a.d);
  load_tile<DP>(vsm, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, j0, a.sk, a.d);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* dob = a.dout + b * a.dos.b + h * a.dos.h;
  for (int q0 = 0; q0 < a.sq; q0 += kTile) {
    __syncthreads();  // previous Q/dO tile fully consumed (and K/V loaded)
    load_tile<DP>(qsm, qb, a.qs.s, q0, a.sq, a.d);
    load_tile<DP>(dosm, dob, a.dos.s, q0, a.sq, a.d);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < a.sq;
      lse2s[threadIdx.x] =
          ok ? a.lse[(long long)bh * a.sq + row] * kLog2e : INFINITY;
      dds[threadIdx.x] = ok ? a.delta[(long long)bh * a.sq + row] : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += 16) {
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 16 queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4];
        vs::frag_a(ak, ksm, LD, wr, kk);
        vs::frag_a(av, vsm, LD, wr, kk);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bq[2], bdo[2];
          vs::frag_bt(bq, qsm, LD, qc + n * 8, kk);
          vs::frag_bt(bdo, dosm, LD, qc + n * 8, kk);
          vs::mma_16816(st[n], ak, bq);
          vs::mma_16816(dpt[n], av, bdo);
        }
      }
      // P^T and dS^T: the query index runs along the columns
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc + n * 8 + 2 * t + (e & 1);
          const float p = exp2f(st[n][e] * a.scale_log2 - lse2s[qi]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dds[qi]);
        }
      // dV += P^T dO, dK += dS^T Q (dO and Q as they are: queries x dim)
      uint32_t ap[4], ads[4];
      vs::frag_a_from_c(ap, st[0], st[1]);
      vs::frag_a_from_c(ads, dpt[0], dpt[1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bdo[2], bq[2];
        vs::frag_b(bdo, dosm, LD, qc, n * 8);
        vs::frag_b(bq, qsm, LD, qc, n * 8);
        vs::mma_16816(dv[n], ap, bdo);
        vs::mma_16816(dk[n], ads, bq);
      }
    }
  }
  store_rows<NO>(a.dk + b * a.dks.b + h * a.dks.h, a.dks.s, j0 + wr, a.sk,
                 a.d, dk, a.scale);
  store_rows<NO>(a.dv + b * a.dvs.b + h * a.dvs.h, a.dvs.s, j0 + wr, a.sk,
                 a.d, dv, 1.0f);
}

template <int DP>
cudaError_t launch(bool dkv, const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + kTile) * 2 * (DP + 8) * sizeof(bf16) +
                      (dkv ? 2 * kTile * sizeof(float) : 0);
  const auto kernel = dkv ? flash_bwd_dkv_kernel<DP> : flash_bwd_dq_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dkv ? a.sk : a.sq;
  const dim3 grid((rows + kRows - 1) / kRows, batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
        const long long* st, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.scale = 1.0f / sqrtf((float)d);
  a.scale_log2 = a.scale * kLog2e;
  Strides* all[7] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 7; ++i) *all[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const auto s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
#define VS_FLASH_BWD_CASE(DP) \
  case DP:                    \
    return (int)launch<DP>(dkv, a, batch, s);
  switch (dp) {
    VS_FLASH_BWD_CASE(16)
    VS_FLASH_BWD_CASE(32)
    VS_FLASH_BWD_CASE(48)
    VS_FLASH_BWD_CASE(64)
    VS_FLASH_BWD_CASE(80)
    VS_FLASH_BWD_CASE(96)
    VS_FLASH_BWD_CASE(128)
    VS_FLASH_BWD_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_FLASH_BWD_CASE
}

}  // namespace

// strides: 21 values, the (batch, seq, head) element strides of q, k, v,
// dout, dq, dk, dv; lse and delta are (batch * heads, sq) fp32, contiguous.
// Each returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int batch, int heads,
                                         int sq, int sk, int d,
                                         const long long* strides,
                                         void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch,
             heads, sq, sk, d, strides, stream);
}

extern "C" int vs_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int batch,
                                          int heads, int sq, int sk, int d,
                                          const long long* strides,
                                          void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, batch, heads,
             sq, sk, d, strides, stream);
}
