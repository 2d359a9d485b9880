// One attention forward mainloop for Hopper (sm_90a): TMA loads, mbarrier
// pipelines, warpgroup matrix products (wgmma) and warp specialisation.
//
// Its PTX helpers, tensor maps and product forms also serve the GEGLU
// feed-forward (csrc/geglu_ffn.cu).
//
// Serves both attention kernels of the port, which compute the same tiled
// product over (B, S, H, D) operands read by stride and differ only in the
// softmax (the `Softmax` policy):
// - OnlineSoftmax (csrc/flash_attention.cu): running row max, rescale of the
//   accumulator, and the fp32 natural-log logsumexp (B*H, Sq) that the
//   backward kernels read;
// - ClippedExp (csrc/spatial_attention.cu): e = exp(min(s d^-1/2, 60)) with
//   no max and no rescale, every key attended, no logsumexp.
//
// What bounds it on the H100: per (batch, head) 4*Sq*Sk*D operations on
// 2*(Sq + Sk)*D*2 bytes, so at the U-Net's shapes the tensor cores and the
// exponentials, not memory: at level 0 (B*H = 256, S = 4096, D = 40) the
// products take 0.695 ms at 989 TFLOP/s, while the 256*4096^2 = 4.3e9 exp2
// at the special-function units' 16 a clock on each of 132 SMs (1.98 GHz)
// take 1.03 ms: the exp floor. At level 1 (S = 1024, D = 80) 0.087 ms of
// products and 0.064 ms of exps. So the design keeps the exponentials
// running under the products and spends as little as possible per logit.
// Measured on the H100 with variants that skip parts of the work, neither
// floor is what binds at D = 40: the K/V loads (80-byte rows at 80-byte
// offsets) take most of the kernel's time, and skipping the exponentials
// saves little.
//
// Design (one block = 128 query rows of one (batch, head), 384 threads;
// where Sq <= 64, 64 rows and 256 threads, with one consumer warpgroup, so
// that no warpgroup works on rows past Sq):
// - warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg) and
//   one thread issues the TMA loads: Q once, then the K and V tiles of BK
//   keys (128; 64 at D > 88, where the accumulators would spill) into a
//   ring of STAGES stages (3; 2 at D > 128, for shared memory), each with a
//   full and an empty mbarrier for K and for V (V is released later than K);
// - warpgroups 1 and 2 are consumers of 64 query rows each, raised to 240
//   registers (ptxas still compiles them within the launch's 168 a thread:
//   it allocates from an SM quarter's registers, three warps to a quarter
//   here, and does not count on setmaxnreg). S = Q.K^T is one wgmma chain with both operands in shared
//   memory (N = BK keys, ceil(D/16) k-steps: 3 at D = 40); P is converted
//   in registers from the S accumulator to bf16 and is the register A
//   operand of O += P.V, with V the MN-major B operand (N = D);
// - overlap: within a warpgroup, tile n's Q.K^T is issued before tile
//   n-1's P.V, and tile n's softmax runs while P.V is in flight; across the
//   two warpgroups, named barriers let one issue its products while the
//   other computes its exponentials (ping-pong);
// - softmax: exp2 with the scale folded into one FFMA a logit, keys masked
//   only on a ragged last tile, row reductions by quad shuffles;
// - tensor maps: 4-D, built from the tensors' own strides, boxes of 64
//   elements (128 bytes, 128-byte swizzle) by the tile's rows. Where a
//   row's heads lie side by side (the (B, S, H, D) views of merged
//   projections, and the spatial kernel's (B, S, C)) the map spans them,
//   (H*D, 1, S, B), and a box starts at column h*D: 128 bytes of the row.
//   A per-head map (D, H, S, B) would have TMA zero-fill columns D..63 of
//   every row, which measured several times slower than whole rows at
//   D = 40 on the H100 and bounded the kernel. The columns past D then
//   hold the next head's values: P.V never reads them (N = D), and Q.K^T
//   reads them only in its last k-step where D % 16 == 8, so those 8
//   columns of Q are zeroed in shared memory before the first product.
//   TMA's zero fill still covers the last head's tail, rows past Sq and
//   keys past Sk (keys past Sk are masked too: a zero key still has logit
//   0);
// - epilogue: normalise in registers, round to bf16, write by stride.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_bf16.cuh"

namespace vs {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;        // query rows a block at most (64 a consumer)
constexpr int kThreads = 384;   // producer + at most two consumer warpgroups
constexpr int kAtomBytes = 128; // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed. The data a block
// waits for arrives within microseconds; after some 2^30 polls (seconds)
// the pipeline is broken, and the kernel traps instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one box of a 2-D tensor map -> shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one box of a 4-D tensor map -> shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of asynchronously written
// registers across a fence, commit or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// shared-memory matrix descriptor with the 128-byte swizzle; byte offsets
// are stored in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the same with the 64-byte swizzle: rows of 64 bytes (32 bf16), the
// pattern repeating every 8 rows (512 bytes)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

// 2^x on the special-function unit, one instruction (subnormals flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------- products
// The two forms of every attention product. Tiles in shared memory are
// rows of 128 bytes (64 bf16 columns) with the 128-byte swizzle, a chunk of
// 64 columns after another, `*_chunk` bytes apart. Issue between
// wgmma_fence() and wgmma_commit().
//
// acc (64 x N) = A (64 x D) . B^T for a B tile of N rows x D: both operands
// K-major in shared memory, ceil(D/16) k-steps, the first overwriting acc
// (S = Q.K^T).
template <int N, int D>
__device__ __forceinline__ void mma_ss_kmajor(float (&acc)[N / 2], uint32_t a,
                                              int a_chunk, uint32_t b,
                                              int b_chunk) {
#pragma unroll
  for (int ks = 0; ks < (D + 15) / 16; ++ks) {
    const uint32_t off = (ks & 3) * 32;  // 16 columns inside an atom
    wgmma_ss<N>(acc, desc_sw128(a + (ks >> 2) * a_chunk + off, 16, 1024),
                desc_sw128(b + (ks >> 2) * b_chunk + off, 16, 1024), ks > 0);
  }
}

// acc (64 x N) += A (64 x K) . B for a B tile of K rows x N columns: A in
// registers (the bf16 pairs of a converted 64 x K accumulator, `to_bf16`),
// B MN-major in shared memory; K/16 k-steps of 16 rows (O += P.V)
template <int N, int K>
__device__ __forceinline__ void mma_rs_mnmajor(float (&acc)[N / 2],
                                               uint32_t (&a)[K / 4],
                                               uint32_t b, int b_chunk) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
    wgmma_rs<N>(acc, a + 4 * kc,
                desc_sw128(b + kc * 16 * kAtomBytes, b_chunk, 1024), 1);
}

// an fp32 accumulator -> the bf16 pairs of a register A operand
template <int NS>
__device__ __forceinline__ void to_bf16(uint32_t (&p)[NS / 2],
                                        const float (&s)[NS]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Zero columns [D, D + 8) of row r of a tile (chunks `chunk` bytes apart)
// where D % 16 == 8: a K-major product's last k-step reads them, and a
// wide map brought the next head's values there. Follow with
// fence_proxy_async() and a barrier before the product.
template <int D>
__device__ __forceinline__ void zero_pad_columns(unsigned char* tile,
                                                 int chunk, int r) {
  static_assert(D % 16 == 8, "only the last k-step's half is read");
  const int unit = ((D % 64) / 8) ^ (r & 7);  // 16-byte unit, swizzled
  *reinterpret_cast<uint4*>(tile + (D / 64) * chunk + r * kAtomBytes +
                            unit * 16) = make_uint4(0u, 0u, 0u, 0u);
}

// --------------------------------------------------------------- shapes
template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D >= 8 && D <= 192, "head dim");
  static constexpr int NCH = (D + 63) / 64;         // 64-column TMA boxes
  // keys a tile: 128, or 64 where the accumulators would not fit the
  // registers without spilling
  static constexpr int BK = D > 88 ? 64 : 128;
  // K/V ring depth: 3 where the ring fits the shared memory (measured a
  // little faster than 2 at D = 40 and 80 on the H100), else 2
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int Q_BYTES = NCH * kBQ * kAtomBytes;
  static constexpr int KV_BYTES = NCH * BK * kAtomBytes;  // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  // 1 KB of slack to align the swizzled tiles to 1024 bytes
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

// ------------------------------------------------------ softmax policies
// Each thread holds two rows (g and g + 8 of its warp's 16) of the S tile:
// s[4j + 2r + c] is row r, key 8j + 2t + c. `valid` keys of the tile are
// real (BK unless it is the ragged last tile).
struct OnlineSoftmax {
  static constexpr bool kLse = true;
  float m[2], l[2], alpha[2];  // raw-logit row max, partial row sum, rescale
  float scale_log2;
  __device__ __forceinline__ explicit OnlineSoftmax(float sl) : scale_log2(sl) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
    alpha[0] = alpha[1] = 1.0f;
  }
  template <int NS, bool kMask>
  __device__ __forceinline__ void apply(float (&s)[NS], int valid, int t) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (kMask && (i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // every tile holds a real key, so mx is finite; m = -inf gives 0
      alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      neg[r] = -mx[r] * scale_log2;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], scale_log2, neg[r]));
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  }
  template <int NO>
  __device__ __forceinline__ void rescale(float (&o)[NO]) const {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
  // natural-log logsumexp of row r (after finish)
  __device__ __forceinline__ float lse(int r) const {
    return (m[r] * scale_log2 + log2f(l[r])) * 0.69314718055994531f;
  }
};

struct ClippedExp {
  static constexpr bool kLse = false;
  static constexpr float kClip = 60.0f;  // the TPU kernel's CLIP
  float l[2];
  float scale_log2, clip_log2;
  __device__ __forceinline__ explicit ClippedExp(float sl)
      : scale_log2(sl), clip_log2(kClip * kLog2e) {
    l[0] = l[1] = 0.0f;
  }
  template <int NS, bool kMask>
  __device__ __forceinline__ void apply(float (&s)[NS], int valid, int t) {
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float e = exp2_approx(fminf(s[i] * scale_log2, clip_log2));
      if (kMask && (i / 4) * 8 + 2 * t + (i & 1) >= valid) e = 0.0f;
      s[i] = e;
      rs[(i >> 1) & 1] += e;
    }
    l[0] += rs[0];
    l[1] += rs[1];
  }
  template <int NO>
  __device__ __forceinline__ void rescale(float (&)[NO]) const {}
};

// ---------------------------------------------------------------- kernel
struct OutArgs {
  bf16* out;
  float* lse;                 // (B*H, Sq); null without a logsumexp
  long long sb, ss, sh;       // out's (batch, row, head) element strides
};

template <int D, class Softmax>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, OutArgs oa,
                     int heads, int sq, int sk, int wide, int consumers,
                     float scale_log2) {
  using S = Shape<D>;
  constexpr int BK = S::BK;
  constexpr int NS = BK / 2;   // S accumulator registers a thread
  constexpr int NO = D / 2;    // O accumulator registers a thread
  constexpr int NP = BK / 4;   // P registers (bf16 pairs) a thread
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared-memory address
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + S::Q_BYTES;
  unsigned char* v_s = k_s + S::STAGES * S::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + S::STAGES * S::KV_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + S::STAGES;
  uint64_t* empty_k = full_v + S::STAGES;
  uint64_t* empty_v = empty_k + S::STAGES;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  // one or two consumer warpgroups of 64 rows; with two they ping-pong
  const bool pingpong = consumers == 2;
  const int q0 = blockIdx.x * 64 * consumers;
  const int n_tiles = (sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(full_k + i, 1);
      mbar_init(full_v + i, 1);
      // one arrival from each consumer warp
      mbar_init(empty_k + i, 4 * consumers);
      mbar_init(empty_v + i, 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // a wide map (bit set in `wide`) spans the row's heads: column h*D + c,
      // head coordinate 0; a per-head map: column c, head h
      const int qc = (wide & 1) ? h * D : 0, qh = (wide & 1) ? 0 : h;
      const int kc = (wide & 2) ? h * D : 0, kh = (wide & 2) ? 0 : h;
      const int vc = (wide & 4) ? h * D : 0, vh = (wide & 4) ? 0 : h;
      mbar_expect_tx(full_q, S::NCH * 64 * consumers * kAtomBytes);
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_load_4d(q_s + c * kBQ * kAtomBytes, &tq, full_q, qc + c * 64, qh,
                    q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % S::STAGES;
        const uint32_t ph = (n / S::STAGES) & 1;
        mbar_wait(empty_k + st, ph ^ 1);
        mbar_expect_tx(full_k + st, S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::NCH; ++c)
          tma_load_4d(k_s + st * S::KV_BYTES + c * BK * kAtomBytes, &tk,
                      full_k + st, kc + c * 64, kh, n * BK, b);
        mbar_wait(empty_v + st, ph ^ 1);
        mbar_expect_tx(full_v + st, S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::NCH; ++c)
          tma_load_4d(v_s + st * S::KV_BYTES + c * BK * kAtomBytes, &tv,
                      full_v + st, vc + c * 64, vh, n * BK, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    const int cw = wg - 1;                    // consumer 0 or 1
    const int warp = (threadIdx.x / 32) & 3;  // warp within the warpgroup
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int my_bar = 1 + cw, other_bar = 2 - cw;
    // consumer 0 issues its products first (cw is 1 only with two)
    if (cw == 1) named_arrive(1, 256);

    const uint32_t q_addr = smem_u32(q_s) + cw * 64 * kAtomBytes;
    const uint32_t k_addr = smem_u32(k_s);
    const uint32_t v_addr = smem_u32(v_s);

    auto qk = [&](float (&s)[NS], int st) {
      wgmma_fence();
      mma_ss_kmajor<BK, D>(s, q_addr, kBQ * kAtomBytes,
                           k_addr + st * S::KV_BYTES, BK * kAtomBytes);
      wgmma_commit();
    };
    auto pv = [&](float (&o)[NO], uint32_t (&p)[NP], int st) {
      wgmma_fence();
      mma_rs_mnmajor<D, BK>(o, p, v_addr + st * S::KV_BYTES, BK * kAtomBytes);
      wgmma_commit();
    };

    Softmax sm(scale_log2);
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float s[NS];
    uint32_t p[NP];
    const int last_valid = sk - (n_tiles - 1) * BK;

    mbar_wait(full_q, 0);
    if constexpr (D % 16 == 8) {
      // the last k-step reads columns [D, D + 8) of Q and K: a wide map
      // brought the next head's values there, so zero Q's (and with them
      // those products)
      const int tid = threadIdx.x & 127;
      if (tid < 64)
        zero_pad_columns<D>(q_s, kBQ * kAtomBytes, cw * 64 + tid);
      fence_proxy_async();
      named_sync(3 + cw, 128);
    }
    // ---- tile 0: S, softmax, P
    mbar_wait(full_k, 0);
    if (pingpong) named_sync(my_bar, 256);
    qk(s, 0);
    if (pingpong) named_arrive(other_bar, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty_k);
    if (n_tiles == 1 && last_valid < BK)
      sm.template apply<NS, true>(s, last_valid, t);
    else
      sm.template apply<NS, false>(s, BK, t);
    to_bf16<NS>(p, s);

    // ---- tile n: S_n = Q K_n^T issued, then O += P_{n-1} V_{n-1}, then
    // the softmax of S_n while the product runs
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % S::STAGES;
      const int pst = (n - 1) % S::STAGES;
      mbar_wait(full_k + st, (n / S::STAGES) & 1);
      if (pingpong) named_sync(my_bar, 256);
      qk(s, st);
      sm.rescale(o);
      mbar_wait(full_v + pst, ((n - 1) / S::STAGES) & 1);
      pv(o, p, pst);
      if (pingpong) named_arrive(other_bar, 256);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k + st);
      if (n == n_tiles - 1 && last_valid < BK)
        sm.template apply<NS, true>(s, last_valid, t);
      else
        sm.template apply<NS, false>(s, BK, t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty_v + pst);
      to_bf16<NS>(p, s);
    }
    // ---- the last P.V
    {
      const int pst = (n_tiles - 1) % S::STAGES;
      sm.rescale(o);
      mbar_wait(full_v + pst, ((n_tiles - 1) / S::STAGES) & 1);
      pv(o, p, pst);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + pst);
    }
    // consumer 1's first arrival on consumer 0's barrier is matched here
    if (pingpong && cw == 0) named_sync(my_bar, 256);

    // ---- epilogue: full row sums, normalise, write by stride
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm.l[r] = quad_sum(sm.l[r]);
      inv[r] = 1.0f / sm.l[r];
    }
    bf16* ob = oa.out + b * oa.sb + h * oa.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < sq) {
        bf16* orow = ob + (long long)row * oa.ss + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
              o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        if constexpr (Softmax::kLse)
          if (t == 0) oa.lse[(long long)bh * sq + row] = sm.lse(r);
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links without -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over one bf16 operand, read in boxes of 64 x 1 x box_rows x 1
// with the 128-byte swizzle; out-of-range elements read as zero. Where the
// heads lie side by side in a row (sh == d, several heads) the map is wide:
// (heads * d, 1, rows, batch), so that a box is 128 bytes of the row even
// where d is not a multiple of 64 (TMA reads rows it has to cut short
// several times slower); `*wide` says so. Otherwise (d, heads, rows, batch)
// with element strides (1, sh, ss, sb).
inline cudaError_t make_map(CUtensorMap* map, bool* wide, const void* ptr,
                            int d, int heads, int rows, int batch,
                            long long sh, long long ss, long long sb,
                            int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  *wide = heads > 1 && sh == d;
  const int dim0 = *wide ? heads * d : d;
  if (*wide) heads = 1;
  const long long extent[3] = {heads, rows, batch};
  long long stride[3] = {sh, ss, sb};
  for (int i = 0; i < 3; ++i) {
    // a dimension of extent 1 is never stepped: give it any valid stride
    if (extent[i] == 1) stride[i] = d;
    if (stride[i] <= 0 || stride[i] % 8) return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)dim0, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[0] * 2,
                                 (cuuint64_t)stride[1] * 2,
                                 (cuuint64_t)stride[2] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a row-major bf16 matrix (rows x cols, cols a multiple of
// 8), read in boxes of box_cols x box_rows with the given swizzle (the box's
// row is at most the swizzle's span); out-of-range elements read as zero.
inline cudaError_t make_map_2d(CUtensorMap* map, const void* ptr, int cols,
                               int rows, int box_cols, int box_rows,
                               CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Operand {
  const void* ptr;
  long long sb, ss, sh;  // (batch, row, head) element strides
};

// Encode the three maps and launch one instantiation. Rows past sq and keys
// past sk are masked; d is a multiple of 8 (the instantiation's D).
template <int D, class Softmax>
cudaError_t launch(Operand q, Operand k, Operand v, OutArgs oa, int batch,
                   int heads, int sq, int sk, cudaStream_t stream) {
  using S = Shape<D>;
  if ((long long)batch * heads > 65535) return cudaErrorInvalidValue;
  // one consumer warpgroup (64 query rows a block) where a second would
  // only compute rows past sq
  const int consumers = sq <= 64 ? 1 : 2;
  CUtensorMap tq, tk, tv;
  bool wq, wk, wv;
  cudaError_t err;
  if ((err = make_map(&tq, &wq, q.ptr, D, heads, sq, batch, q.sh, q.ss, q.sb,
                      64 * consumers)) != cudaSuccess ||
      (err = make_map(&tk, &wk, k.ptr, D, heads, sk, batch, k.sh, k.ss, k.sb,
                      S::BK)) != cudaSuccess ||
      (err = make_map(&tv, &wv, v.ptr, D, heads, sk, batch, v.sh, v.ss, v.sb,
                      S::BK)) != cudaSuccess)
    return err;
  const int wide = (wq ? 1 : 0) | (wk ? 2 : 0) | (wv ? 4 : 0);
  err = cudaFuncSetAttribute(attention_fwd_kernel<D, Softmax>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  const int bq = 64 * consumers;
  const dim3 grid((sq + bq - 1) / bq, batch * heads);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  attention_fwd_kernel<D, Softmax>
      <<<grid, 128 * (1 + consumers), S::SMEM, stream>>>(
          tq, tk, tv, oa, heads, sq, sk, wide, consumers, scale_log2);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace vs
