// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, on the TMA + mbarrier + wgmma machinery of csrc/attention_sm90.cuh.
//
// Replaces: videoswap_tpu/ops/flash_attention.py:194 `_bwd_dq_kernel` and
// :213 `_bwd_dkv_kernel` (the two Pallas TPU kernels of `_bwd_core`).
//
// Inputs as the forward (csrc/flash_attention.cu) saw them: q (B, Sq, H, D)
// and k, v (B, Sk, H, D) in bf16, read through their strides, the upstream
// gradient dO (B, Sq, H, D) bf16, the forward's natural-log row logsumexp
// lse (B*H, Sq) fp32, and D = rowsum(dO * O) (B*H, Sq) fp32, which the
// wrapper computes before the launches (as the JAX package does outside its
// kernels). With p = exp(q k^T s - lse), s = D^-0.5:
//
//   dv = p^T dO,   ds = p (dO v^T - D),   dq = ds k s,   dk = ds^T q s
//
// The two kernels split the work as the JAX package's two kernels do: each
// output element is written by exactly one block, with no atomics, so two
// calls on the same inputs give the same bits.
//
// What bounds it on the H100: per (batch, head) the dQ kernel does
// 6*Sq*Sk*D operations (three products) and the dK/dV kernel 8*Sq*Sk*D
// (four) on about 2*(3*Sq + 2*Sk)*D bytes, so the tensor cores, with the
// exponentials close behind: at the training step's level 0 (B*H = 128,
// S = 4096, D = 40) 0.521 ms (dQ) and 0.695 ms (dK/dV) of products at 989
// TFLOP/s, while each kernel recomputes P, 128*4096^2 = 2.15e9 exp2, which
// at the special-function units' 16 a clock on each of 132 SMs (1.98 GHz)
// take 0.51 ms. So each kernel keeps the products of one warpgroup running
// under the exponentials of the other, and spends one FFMA and one ex2 a
// logit on P (the lse is known: no running max, no rescale).
//
// Design (every product a wgmma). A block owns 128 rows of one (batch,
// head): two consumer warpgroups of 64 rows that ping-pong on named
// barriers, and one producer warp that issues the TMA loads, 288 threads.
// Where the rows are <= 64, or at large D (dQ D > 120, dK/dV D > 80), one
// consumer of 64 rows and 160 threads. The registers set those limits:
// ptxas allocates from an SM sub-partition's quarter of the register file,
// so 168 a thread where a quarter holds three warps (the forward's 384
// threads or these 288; setmaxnreg's larger share is not used by ptxas,
// and every instantiation spilled with 128-row tiles), 255 where it holds
// two. Streamed tiles of BT = 64 rows keep S and dP at 32 registers each.
// - dQ: Q and dO are loaded once, K and V stream through a ring of STAGES
//   tiles of BT keys. S = Q.K^T and dP = dO.V^T have both operands in
//   shared memory, K-major; P and dS = P (dP - D) are formed in the S
//   registers and dS rounded to bf16 is the register A operand of
//   dQ += dS.K, with K the MN-major B operand (N = D), the form of the
//   forward's P.V. Tile n's S and dP are issued before tile n-1's dS.K, and
//   dS_n is computed while that runs. V is released after dP, K after
//   dS.K. Keys past Sk are masked on a ragged last tile only.
// - dK/dV: the forward with the roles swapped. K and V are loaded once, Q
//   and dO stream in tiles of BT queries, and with each tile the producer
//   warp stages its -lse*log2(e) and D in fp32, which the consumers read as
//   float2 pairs. S^T = K.Q^T and dP^T = V.dO^T are shared x shared; P^T
//   and dS^T are formed in registers, rounded to bf16 and are the A
//   operands of dV += P^T.dO and dK += dS^T.Q, which read the same swizzled
//   Q and dO tiles a second time through MN-major descriptors (N = D).
//   Query rows past Sq arrive as zero Q and dO (TMA's zero fill): their
//   column of S^T and dP^T is 0, and their row of dO and Q in the two
//   accumulating products is 0, so they add nothing to dK or dV as long as
//   P and dS are finite; the producer stages lse = D = 0 for them, so P = 1
//   and dS = 0 (the next row's lse could overflow exp2). dK is scaled by
//   D^-0.5 at the end.
// - tensor maps: those of the forward (make_map): boxes of 128 bytes of the
//   row across heads where the heads lie side by side, which covers the
//   contiguous dO and the U-Net's split-head views. Columns [D, D + 8) of
//   the resident operands of the shared x shared products (Q and dO in the
//   dQ kernel, K and V in the dK/dV kernel) are zeroed once where
//   D % 16 == 8: a wide map brought the next head's values there, and the
//   last k-step reads them. The MN-major products read only N = D columns.

#include "attention_sm90.cuh"

namespace {

using namespace vs::sm90;

constexpr int kSmemMax = 232448;  // dynamic shared memory a block can have
constexpr int kBT = 64;           // rows of a streamed tile

// Up to two consumer warpgroups and one producer warp. ptxas allocates a
// thread's registers from its SM sub-partition's quarter of the register
// file: 168 where a quarter holds three warps (288 or 384 threads; it does
// not allocate setmaxnreg's larger share), 255 where it holds two (160
// threads). 64-row tiles keep S and dP at 32 registers each, so two
// consumers fit 168 where D is small enough; above that, one consumer.
// dQ holds S, dP, the previous tile's dS (16) and dQ (D/2); dK/dV holds
// S^T, dP^T and two D/2 accumulators.
template <int D, bool kDkv>
struct BwdShape {
  static constexpr int CONSUMERS = D <= (kDkv ? 80 : 120) ? 2 : 1;
  static constexpr int THREADS = 128 * CONSUMERS + 32;
  static constexpr int NCH = Shape<D>::NCH;
  static constexpr int BT = kBT;
  // the two resident operands, 64 rows a consumer
  static constexpr int RES_ROWS = 64 * CONSUMERS;
  static constexpr int RES_BYTES = 2 * NCH * RES_ROWS * kAtomBytes;
  static constexpr int TILE_BYTES = NCH * BT * kAtomBytes;
  // a stage: two operand tiles and (dK/dV) a tile's lse and D in fp32
  static constexpr int ROWS_BYTES = 2 * BT * 4;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + ROWS_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + 4 * 3);
  static constexpr int FIT = (kSmemMax - 1024 - RES_BYTES - BAR_BYTES) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static_assert(STAGES >= 2, "shared memory");
  static constexpr int SMEM = 1024 + RES_BYTES + STAGES * STAGE_BYTES +
                              BAR_BYTES;
};

struct Out {
  bf16* ptr;
  long long sb, ss, sh;  // (batch, row, head) element strides
};

struct Rows {
  const float* lse;    // (B*H, Sq)
  const float* delta;  // (B*H, Sq)
};

// rows r0 and r0 + 8 of a 64 x N accumulator (this thread's) times `mul`
// -> bf16 at out[row * row_stride + col], rows < `rows`
template <int N>
__device__ __forceinline__ void store_acc(bf16* out, long long row_stride,
                                          int r0, int rows,
                                          const float (&acc)[N / 2],
                                          float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    bf16* orow = out + (long long)row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// Shared memory of both kernels: the resident operands A0, A1 (RES_ROWS
// each), then the ring: STAGES tiles of T0, of T1, of -lse*log2(e), of D,
// then the mbarriers.
template <class B>
struct Smem {
  unsigned char *a0, *a1, *t0, *t1;
  float *nl2, *delta;
  uint64_t* bars;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    // the swizzle pattern repeats every 1024 bytes of shared-memory address
    a0 = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    a1 = a0 + B::RES_BYTES / 2;
    t0 = a1 + B::RES_BYTES / 2;
    t1 = t0 + B::STAGES * B::TILE_BYTES;
    nl2 = reinterpret_cast<float*>(t1 + B::STAGES * B::TILE_BYTES);
    delta = nl2 + B::STAGES * B::BT;
    bars = reinterpret_cast<uint64_t*>(delta + B::STAGES * B::BT);
  }
};

// dS = P (dP - D) into s, P = exp2(s c - lse log2 e) with nl2 = -lse log2 e
// and dd = D of this thread's two rows; with kMask, keys at or past `valid`
// get P = 0
template <bool kMask, int NS>
__device__ __forceinline__ void form_ds(float (&s)[NS], const float (&dp)[NS],
                                        const float (&nl2)[2],
                                        const float (&dd)[2],
                                        float scale_log2, int valid, int t) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    float p = exp2_approx(fmaf(s[i], scale_log2, nl2[r]));
    if (kMask && (i / 4) * 8 + 2 * t + (i & 1) >= valid) p = 0.0f;
    s[i] = p * (dp[i] - dd[r]);
  }
}

// the column of operand i (bit i of `wide`: a map spanning the row's heads,
// column h*D + c, head coordinate 0) and its head coordinate
template <int D>
__device__ __forceinline__ int2 head_coords(int wide, int i, int h) {
  return (wide >> i) & 1 ? make_int2(h * D, 0) : make_int2(0, h);
}

// ------------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(BwdShape<D, false>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, Rows rows,
                    Out dq, int heads, int sq, int sk, int wide,
                    int consumers, float scale, float scale_log2) {
  using B = BwdShape<D, false>;
  constexpr int BT = B::BT;
  constexpr int NS = BT / 2;  // S and dP accumulator registers a thread
  constexpr int NO = D / 2;   // dQ accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const Smem<B> sm(smem_raw);
  unsigned char* q_s = sm.a0;
  unsigned char* do_s = sm.a1;
  unsigned char* k_s = sm.t0;
  unsigned char* v_s = sm.t1;
  uint64_t* full_q = sm.bars;  // Q and dO
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + B::STAGES;
  uint64_t* empty_k = full_v + B::STAGES;
  uint64_t* empty_v = empty_k + B::STAGES;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const bool pingpong = consumers == 2;
  const int q0 = blockIdx.x * 64 * consumers;
  const int n_tiles = (sk + BT - 1) / BT;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < B::STAGES; ++i) {
      mbar_init(full_k + i, 1);
      mbar_init(full_v + i, 1);
      mbar_init(empty_k + i, 4 * consumers);  // one arrival a consumer warp
      mbar_init(empty_v + i, 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * consumers) {
    // ------------------------------------------- producer warp, one lane
    if (threadIdx.x == 128 * consumers) {
      const int2 cq = head_coords<D>(wide, 0, h), ck = head_coords<D>(wide, 1, h);
      const int2 cv = head_coords<D>(wide, 2, h), co = head_coords<D>(wide, 3, h);
      mbar_expect_tx(full_q, 2 * B::NCH * 64 * consumers * kAtomBytes);
#pragma unroll
      for (int c = 0; c < B::NCH; ++c) {
        tma_load_4d(q_s + c * B::RES_ROWS * kAtomBytes, &tq, full_q, cq.x + c * 64,
                    cq.y, q0, b);
        tma_load_4d(do_s + c * B::RES_ROWS * kAtomBytes, &tdo, full_q, co.x + c * 64,
                    co.y, q0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % B::STAGES;
        const uint32_t ph = (n / B::STAGES) & 1;
        mbar_wait(empty_k + st, ph ^ 1);
        mbar_expect_tx(full_k + st, B::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < B::NCH; ++c)
          tma_load_4d(k_s + st * B::TILE_BYTES + c * BT * kAtomBytes, &tk,
                      full_k + st, ck.x + c * 64, ck.y, n * BT, b);
        mbar_wait(empty_v + st, ph ^ 1);
        mbar_expect_tx(full_v + st, B::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < B::NCH; ++c)
          tma_load_4d(v_s + st * B::TILE_BYTES + c * BT * kAtomBytes, &tv,
                      full_v + st, cv.x + c * 64, cv.y, n * BT, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int my_bar = 1 + cw, other_bar = 2 - cw;
    if (cw == 1) named_arrive(1, 256);  // consumer 0 issues first

    const uint32_t q_addr = smem_u32(q_s) + cw * 64 * kAtomBytes;
    const uint32_t do_addr = smem_u32(do_s) + cw * 64 * kAtomBytes;
    const uint32_t k_addr = smem_u32(k_s);
    const uint32_t v_addr = smem_u32(v_s);

    // this thread's rows r0 and r0 + 8: -lse*log2(e) and D (0 past Sq,
    // where Q and dO are zero and nothing is stored)
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    float nl2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const bool ok = row < sq;
      nl2[r] = ok ? -rows.lse[(long long)bh * sq + row] * kLog2e : 0.0f;
      dd[r] = ok ? rows.delta[(long long)bh * sq + row] : 0.0f;
    }

    auto s_dp = [&](float (&s)[NS], float (&dp)[NS], int st) {
      wgmma_fence();
      mma_ss_kmajor<BT, D>(s, q_addr, B::RES_ROWS * kAtomBytes,
                           k_addr + st * B::TILE_BYTES, BT * kAtomBytes);
      mma_ss_kmajor<BT, D>(dp, do_addr, B::RES_ROWS * kAtomBytes,
                           v_addr + st * B::TILE_BYTES, BT * kAtomBytes);
      wgmma_commit();
    };
    auto dsk = [&](float (&acc)[NO], uint32_t (&ds)[NS / 2], int st) {
      wgmma_fence();
      mma_rs_mnmajor<D, BT>(acc, ds, k_addr + st * B::TILE_BYTES,
                            BT * kAtomBytes);
      wgmma_commit();
    };
    // keys masked on a ragged last tile only
    auto ds_of_tile = [&](float (&s)[NS], const float (&dp)[NS], int n) {
      const int valid = sk - n * BT;
      if (valid < BT)
        form_ds<true>(s, dp, nl2, dd, scale_log2, valid, t);
      else
        form_ds<false>(s, dp, nl2, dd, scale_log2, BT, t);
    };

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
    float s[NS], dp[NS];
    uint32_t ds[NS / 2];

    mbar_wait(full_q, 0);
    if constexpr (D % 16 == 8) {
      const int tid = threadIdx.x & 127;
      zero_pad_columns<D>(tid < 64 ? q_s : do_s, B::RES_ROWS * kAtomBytes,
                          cw * 64 + (tid & 63));
      fence_proxy_async();
      named_sync(3 + cw, 128);
    }
    // ---- tile 0: S, dP, dS
    mbar_wait(full_k, 0);
    mbar_wait(full_v, 0);
    if (pingpong) named_sync(my_bar, 256);
    s_dp(s, dp, 0);
    if (pingpong) named_arrive(other_bar, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(empty_v);
    ds_of_tile(s, dp, 0);
    to_bf16<NS>(ds, s);

    // ---- tile n: S_n, dP_n issued, then dQ += dS_{n-1} K_{n-1}, then
    // dS_n while the product runs
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % B::STAGES;
      const int pst = (n - 1) % B::STAGES;
      const uint32_t ph = (n / B::STAGES) & 1;
      mbar_wait(full_k + st, ph);
      mbar_wait(full_v + st, ph);
      if (pingpong) named_sync(my_bar, 256);
      s_dp(s, dp, st);
      dsk(acc, ds, pst);
      if (pingpong) named_arrive(other_bar, 256);
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(empty_v + st);
      ds_of_tile(s, dp, n);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty_k + pst);
      to_bf16<NS>(ds, s);
    }
    // ---- the last dS.K
    {
      const int pst = (n_tiles - 1) % B::STAGES;
      dsk(acc, ds, pst);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_k + pst);
    }
    // consumer 1's first arrival on consumer 0's barrier is matched here
    if (pingpong && cw == 0) named_sync(my_bar, 256);

    store_acc<D>(dq.ptr + b * dq.sb + h * dq.sh, dq.ss, r0, sq, acc, scale,
                 t);
  }
}

// ---------------------------------------------------------------- dK/dV
template <int D>
__global__ void __launch_bounds__(BwdShape<D, true>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, Rows rows,
                     Out dk, Out dv, int heads, int sq, int sk, int wide,
                     int consumers, float scale, float scale_log2) {
  using B = BwdShape<D, true>;
  constexpr int BT = B::BT;
  constexpr int NS = BT / 2;  // S^T and dP^T accumulator registers a thread
  constexpr int NO = D / 2;   // dK and dV accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const Smem<B> sm(smem_raw);
  unsigned char* k_s = sm.a0;
  unsigned char* v_s = sm.a1;
  unsigned char* q_s = sm.t0;
  unsigned char* do_s = sm.t1;
  uint64_t* full_kv = sm.bars;
  uint64_t* full = full_kv + 1;  // a stage's Q, dO, lse and D
  uint64_t* empty = full + B::STAGES;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const bool pingpong = consumers == 2;
  const int k0 = blockIdx.x * 64 * consumers;
  const int n_tiles = (sq + BT - 1) / BT;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int i = 0; i < B::STAGES; ++i) {
      // the TMA lane's expect_tx and one arrival from each producer lane
      mbar_init(full + i, 1 + 32);
      mbar_init(empty + i, 4 * consumers);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * consumers) {
    // ----------------------------------------------------- producer warp
    const int lane = threadIdx.x & 31;
    const int2 cq = head_coords<D>(wide, 0, h), ck = head_coords<D>(wide, 1, h);
    const int2 cv = head_coords<D>(wide, 2, h), co = head_coords<D>(wide, 3, h);
    if (lane == 0) {
      mbar_expect_tx(full_kv, 2 * B::NCH * 64 * consumers * kAtomBytes);
#pragma unroll
      for (int c = 0; c < B::NCH; ++c) {
        tma_load_4d(k_s + c * B::RES_ROWS * kAtomBytes, &tk, full_kv, ck.x + c * 64,
                    ck.y, k0, b);
        tma_load_4d(v_s + c * B::RES_ROWS * kAtomBytes, &tv, full_kv, cv.x + c * 64,
                    cv.y, k0, b);
      }
    }
    const float* lse = rows.lse + (long long)bh * sq;
    const float* delta = rows.delta + (long long)bh * sq;
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % B::STAGES;
      mbar_wait(empty + st, ((n / B::STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + st, 2 * B::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < B::NCH; ++c) {
          tma_load_4d(q_s + st * B::TILE_BYTES + c * BT * kAtomBytes, &tq,
                      full + st, cq.x + c * 64, cq.y, n * BT, b);
          tma_load_4d(do_s + st * B::TILE_BYTES + c * BT * kAtomBytes, &tdo,
                      full + st, co.x + c * 64, co.y, n * BT, b);
        }
      }
      // the tile's -lse*log2(e) and D; rows past Sq (zero Q and dO) get 0:
      // P = 1 there and dS = 0
#pragma unroll
      for (int i = lane; i < BT; i += 32) {
        const int row = n * BT + i;
        const bool ok = row < sq;
        sm.nl2[st * BT + i] = ok ? -lse[row] * kLog2e : 0.0f;
        sm.delta[st * BT + i] = ok ? delta[row] : 0.0f;
      }
      mbar_arrive(full + st);
    }
  } else {
    // ------------------------------------------------------ consumers
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int my_bar = 1 + cw, other_bar = 2 - cw;
    if (cw == 1) named_arrive(1, 256);  // consumer 0 issues first

    const uint32_t k_addr = smem_u32(k_s) + cw * 64 * kAtomBytes;
    const uint32_t v_addr = smem_u32(v_s) + cw * 64 * kAtomBytes;
    const uint32_t q_addr = smem_u32(q_s);
    const uint32_t do_addr = smem_u32(do_s);

    float dk_acc[NO], dv_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    float s[NS], dp[NS];
    uint32_t p[NS / 2], ds[NS / 2];

    mbar_wait(full_kv, 0);
    if constexpr (D % 16 == 8) {
      const int tid = threadIdx.x & 127;
      zero_pad_columns<D>(tid < 64 ? k_s : v_s, B::RES_ROWS * kAtomBytes,
                          cw * 64 + (tid & 63));
      fence_proxy_async();
      named_sync(3 + cw, 128);
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % B::STAGES;
      const uint32_t tile = st * B::TILE_BYTES;
      mbar_wait(full + st, (n / B::STAGES) & 1);
      // S^T = K Q^T, dP^T = V dO^T
      if (pingpong) named_sync(my_bar, 256);
      wgmma_fence();
      mma_ss_kmajor<BT, D>(s, k_addr, B::RES_ROWS * kAtomBytes, q_addr + tile,
                           BT * kAtomBytes);
      mma_ss_kmajor<BT, D>(dp, v_addr, B::RES_ROWS * kAtomBytes, do_addr + tile,
                           BT * kAtomBytes);
      wgmma_commit();
      if (pingpong) named_arrive(other_bar, 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T: the query runs along the columns
      const float* nl2_t = sm.nl2 + st * BT;
      const float* delta_t = sm.delta + st * BT;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 nl = *reinterpret_cast<const float2*>(nl2_t + col);
        const float2 dd = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          const float pv =
              exp2_approx(fmaf(s[i], scale_log2, i & 1 ? nl.y : nl.x));
          dp[i] = pv * (dp[i] - (i & 1 ? dd.y : dd.x));
          s[i] = pv;
        }
      }
      to_bf16<NS>(p, s);
      to_bf16<NS>(ds, dp);
      // dV += P^T dO, dK += dS^T Q: the same tiles, MN-major
      wgmma_fence();
      mma_rs_mnmajor<D, BT>(dv_acc, p, do_addr + tile, BT * kAtomBytes);
      mma_rs_mnmajor<D, BT>(dk_acc, ds, q_addr + tile, BT * kAtomBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(p);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty + st);
    }
    // consumer 1's first arrival on consumer 0's barrier is matched here
    if (pingpong && cw == 0) named_sync(my_bar, 256);

    const int r0 = k0 + cw * 64 + warp * 16 + g;
    store_acc<D>(dk.ptr + b * dk.sb + h * dk.sh, dk.ss, r0, sk, dk_acc, scale,
                 t);
    store_acc<D>(dv.ptr + b * dv.sb + h * dv.sh, dv.ss, r0, sk, dv_acc, 1.0f,
                 t);
  }
}

// ------------------------------------------------------------------ host
struct Args {
  Operand q, k, v, dout;
  Rows rows;
  Out dq, dk, dv;
  int batch, heads, sq, sk;
};

// the four operand maps; `rows_q`/`rows_k` rows a box of q and dO / k and v
template <int D>
cudaError_t operand_maps(const Args& a, int rows_q, int rows_k,
                         CUtensorMap (&m)[4], int* wide) {
  const Operand* ops[4] = {&a.q, &a.k, &a.v, &a.dout};
  const int seq[4] = {a.sq, a.sk, a.sk, a.sq};
  const int box[4] = {rows_q, rows_k, rows_k, rows_q};
  *wide = 0;
  for (int i = 0; i < 4; ++i) {
    bool w;
    const cudaError_t err =
        make_map(&m[i], &w, ops[i]->ptr, D, a.heads, seq[i], a.batch,
                 ops[i]->sh, ops[i]->ss, ops[i]->sb, box[i]);
    if (err != cudaSuccess) return err;
    *wide |= w ? 1 << i : 0;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using B = BwdShape<D, false>;
  // one consumer warpgroup where a second would only compute rows past Sq
  const int consumers = a.sq <= 64 ? 1 : B::CONSUMERS;
  CUtensorMap m[4];
  int wide;
  cudaError_t err = operand_maps<D>(a, 64 * consumers, B::BT, m, &wide);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B::SMEM);
  if (err != cudaSuccess) return err;
  const int bq = 64 * consumers;
  const dim3 grid((a.sq + bq - 1) / bq, a.batch * a.heads);
  const float scale = 1.0f / sqrtf((float)D);
  flash_bwd_dq_kernel<D><<<grid, 128 * consumers + 32, B::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], a.rows, a.dq, a.heads, a.sq, a.sk, wide,
      consumers, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  using B = BwdShape<D, true>;
  const int consumers = a.sk <= 64 ? 1 : B::CONSUMERS;
  CUtensorMap m[4];
  int wide;
  cudaError_t err = operand_maps<D>(a, B::BT, 64 * consumers, m, &wide);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B::SMEM);
  if (err != cudaSuccess) return err;
  const int bk = 64 * consumers;
  const dim3 grid((a.sk + bk - 1) / bk, a.batch * a.heads);
  const float scale = 1.0f / sqrtf((float)D);
  flash_bwd_dkv_kernel<D><<<grid, 128 * consumers + 32, B::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], a.rows, a.dk, a.dv, a.heads, a.sq, a.sk, wide,
      consumers, scale, scale * kLog2e);
  return cudaGetLastError();
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
        const long long* st, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{Operand{q, st[0], st[1], st[2]},
               Operand{k, st[3], st[4], st[5]},
               Operand{v, st[6], st[7], st[8]},
               Operand{dout, st[9], st[10], st[11]},
               Rows{static_cast<const float*>(lse),
                    static_cast<const float*>(delta)},
               Out{static_cast<bf16*>(dq), st[12], st[13], st[14]},
               Out{static_cast<bf16*>(dk), st[15], st[16], st[17]},
               Out{static_cast<bf16*>(dv), st[18], st[19], st[20]},
               batch, heads, sq, sk};
  const auto s = static_cast<cudaStream_t>(stream);
  // the head dims of the forward's VS_FLASH_CASE list
#define VS_FLASH_BWD_CASE(D) \
  case D:                    \
    return (int)(dkv ? launch_dkv<D>(a, s) : launch_dq<D>(a, s));
  switch (d) {
    VS_FLASH_BWD_CASE(8)
    VS_FLASH_BWD_CASE(16)
    VS_FLASH_BWD_CASE(24)
    VS_FLASH_BWD_CASE(32)
    VS_FLASH_BWD_CASE(40)
    VS_FLASH_BWD_CASE(48)
    VS_FLASH_BWD_CASE(56)
    VS_FLASH_BWD_CASE(64)
    VS_FLASH_BWD_CASE(72)
    VS_FLASH_BWD_CASE(80)
    VS_FLASH_BWD_CASE(88)
    VS_FLASH_BWD_CASE(96)
    VS_FLASH_BWD_CASE(112)
    VS_FLASH_BWD_CASE(120)
    VS_FLASH_BWD_CASE(128)
    VS_FLASH_BWD_CASE(152)
    VS_FLASH_BWD_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_FLASH_BWD_CASE
}

}  // namespace

// strides: 21 values, the (batch, seq, head) element strides of q, k, v,
// dout, dq, dk, dv; lse and delta are (batch * heads, sq) fp32, contiguous.
// Each returns a cudaError_t code: 0 when the launch
// was accepted.
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
