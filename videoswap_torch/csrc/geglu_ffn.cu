// GEGLU feed-forward for Hopper (sm_90a): one fused kernel at C <= 640 and
// the gate pass of the split route above it.
//
// Replaces: videoswap_tpu/ops/geglu_ffn.py, `_forward` / `_kernel` (the
// Pallas TPU kernel behind `geglu_ffn`), and, above its MAX_KERNEL_WIDTH =
// 640, the elementwise pass of `_xla_reference` between its two products.
//
// Computes out = (a * gelu_fast(gate)) @ W2^T + b2 with
// [a | gate] = x @ W1^T + b1, for x (N, C) bf16, W1 (8C, C), W2 (C, 4C) in
// the torch Linear layout, all bf16.
//
// What bounds it on the H100: 24*N*C^2 operations (0.326 ms at the bf16
// peak at N*C^2 = 1.34e10, every U-Net level) against 4*N*C + 24*C^2 bytes
// of device memory once the 4C intermediate stays on chip, so the tensor
// cores; but a block reads all 24*C^2 bytes of weights from L2 for its row
// block, BM*2 operations a weight byte, so with 64-row blocks (C > 320) the
// L2 rate binds first. The design keeps the intermediate on chip, reads
// every weight byte once a block through TMA, and gives each weight tile
// 128 rows where the accumulator allows it.
//
// Fused kernel (C a multiple of 64 up to 320, or of 128 up to 640): 256
// threads, two warpgroups, 255 registers a thread (two warps to an SM
// quarter; a producer warp would make three, and ptxas then allows 168).
// One elected thread, warpgroup 1's first, issues the TMA loads between its
// own products. A block TMA-loads its x tile once (rows past N zero-filled,
// never stored), then walks the 4C intermediate in chunks of 32 columns:
// the chunk's 32 rows of W1's `a` half and 32 of its gate half (one 64-row
// K-major tile, 128-byte swizzle) and W2's 32 columns (C rows of 64 bytes,
// 64-byte swizzle) stream through rings of ST1 and ST2 stages (2 and 2 at
// C = 320; 1 and 1 at C = 640, where the x tile and one stage each fill
// the shared memory), with full and empty mbarriers for W1 and for W2
// apart, so that W1 of a later chunk loads while W2 of this one is read.
// - C <= 320: each warpgroup owns 64 rows (128 a block, one weight tile
//   serving both) and all C output columns: 64 x C fp32 in registers (160
//   a thread at C = 320). h = x.W1_chunk^T is an SS wgmma (N = 64: 32 a and
//   32 gate columns), bias, gelu_fast and the gate are applied in registers,
//   and G, rounded to bf16, is the register A operand of out += G.W2^T (RS
//   wgmma, B K-major). The warpgroups issue their products in turns (named
//   barriers), so that one computes its gate while the other's products run.
// - 320 < C <= 640: 64 rows a block; warpgroup w owns output columns
//   [w*C/2, (w+1)*C/2) (160 fp32 a thread at C = 640) and computes 16 of
//   the chunk's 32 G columns (SS, N = 32); the two halves meet in a
//   double-buffered 64 x 32 shared tile, the A operand of an SS out product.
// - Within a warpgroup, chunk j's first product is issued before chunk
//   j-1's second, and chunk j's gate runs while the second is in flight.
// Measured slower on the H100 and not kept: a 2-CTA cluster sharing each
// weight tile by TMA multicast (both widths), and W1 tiles streamed in
// K parts through a deeper ring of smaller stages.
//
// Gate pass (the split route, C > 640, as the JAX package's XLA route):
// h (N, 8C) bf16 -> (N, 4C) bf16, 16-byte loads and stores, bounded by its
// 24*N*C bytes; the two products around it are cuBLAS's.
//
// GELU: gelu_fast, the same Horner erf polynomial as the JAX package
// (|gelu_fast - gelu| <= 4.7e-5), evaluated in fp32. The fused kernel rounds
// the gated product to bf16 before the second product, as the Pallas kernel
// does. The gate pass takes bf16 h and rounds as the plain version does on
// it: gate / sqrt(2) to bf16 before the polynomial (the JAX package's
// gelu_fast on a bf16 input rounds it too, with 1/sqrt(2) itself in bf16),
// gelu_fast(gate) to bf16, then the product. It evaluates the polynomial
// with each product and sum rounded apart (no fused multiply-add), as
// PyTorch's elementwise operations do, so that it gives the plain version's
// bits.

#include "attention_sm90.cuh"

namespace {

using namespace vs::sm90;

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

// gelu_fast of a bf16 gate as the plain version computes it on bf16: the
// argument of erf rounded to bf16, every operation rounded apart (the
// constants are the plain version's, doubles rounded to fp32)
__device__ __forceinline__ float gelu_fast_rn(float x) {
  const float u = __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(x, (float)0.70710678118654752)));
  const float s = fminf(__fmul_rn(__fmul_rn(u, u), (float)(1.0 / 9.0)), 1.0f);
  float q = (float)1.4207271411;
  q = __fadd_rn(__fmul_rn(q, s), (float)-8.8140112788);
  q = __fadd_rn(__fmul_rn(q, s), (float)24.913610011);
  q = __fadd_rn(__fmul_rn(q, s), (float)-43.054002726);
  q = __fadd_rn(__fmul_rn(q, s), (float)51.767980495);
  q = __fadd_rn(__fmul_rn(q, s), (float)-46.861629272);
  q = __fadd_rn(__fmul_rn(q, s), (float)33.590318391);
  q = __fadd_rn(__fmul_rn(q, s), (float)-19.508373138);
  q = __fadd_rn(__fmul_rn(q, s), (float)9.1353631098);
  q = __fadd_rn(__fmul_rn(q, s), (float)-3.3850338503);
  q = __fadd_rn(__fmul_rn(q, s), (float)1.1283787715);
  const float e = fminf(fmaxf(__fmul_rn(u, q), -1.0f), 1.0f);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float bf16_at(const bf16* p) {
  return __bfloat162float(*p);
}

constexpr int kChunk = 32;     // intermediate columns a chunk (a and gate)
constexpr int kThreadsFfn = 256;
constexpr int kSmemMax = 232448;

template <int C>
struct Ffn {
  static_assert(C % 64 == 0 && C <= 640 && (C <= 320 || C % 128 == 0),
                "fused widths");
  static constexpr bool kSplit = C > 320;  // warpgroups split the columns
  static constexpr int BM = kSplit ? 64 : 128;    // rows a block
  static constexpr int CW = kSplit ? C / 2 : C;   // output columns a wg
  static constexpr int NI = CW > 160 ? CW / 2 : CW;  // N of an out product
  static constexpr int NH = kSplit ? 32 : 64;     // N of the first product
  static constexpr int NCH = C / 64;              // 128-byte column chunks
  static constexpr int NJ = 4 * C / kChunk;       // intermediate chunks
  static constexpr int X_BYTES = NCH * BM * kAtomBytes;
  static constexpr int W1_BYTES = NCH * 2 * kChunk * kAtomBytes;
  static constexpr int W2_BYTES = C * kChunk * 2;
  static constexpr int G_TILE = 64 * kChunk * 2;  // one 64 x 32 G tile
  static constexpr int G_BYTES = kSplit ? 2 * G_TILE : 0;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * 4 + 2 * 2);
  static constexpr int FIXED = 1024 + X_BYTES + G_BYTES + BAR_BYTES;
  static constexpr int ST2 = kSplit ? 1 : 2;      // W2 stages
  static constexpr int FIT = (kSmemMax - FIXED - ST2 * W2_BYTES) / W1_BYTES;
  static constexpr int ST1 = FIT < 4 ? FIT : 4;   // W1 stages
  static constexpr int SMEM = FIXED + ST1 * W1_BYTES + ST2 * W2_BYTES;
  static_assert(ST1 >= 1, "one W1 tile must fit the shared memory");
  static_assert(CW % NI == 0 && NI % 8 == 0 && NI <= 160, "out products");
};

template <int C>
__global__ void __launch_bounds__(kThreadsFfn, 1)
geglu_ffn_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                 bf16* __restrict__ out, int n) {
  using F = Ffn<C>;
  constexpr int ST1 = F::ST1, ST2 = F::ST2;
  constexpr int NH = F::NH;
  constexpr int NO = F::CW / 2;         // out accumulators a thread
  constexpr int NG = NH / 4;            // G values a thread (a chunk)
  constexpr bool kPingPong = !F::kSplit;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle pattern repeats every 1024 bytes
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_s = base;
  unsigned char* w1_s = x_s + F::X_BYTES;
  unsigned char* w2_s = w1_s + ST1 * F::W1_BYTES;
  unsigned char* g_s = w2_s + ST2 * F::W2_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(g_s + F::G_BYTES);
  uint64_t* full_x = bars;
  uint64_t* full1 = bars + 1;
  uint64_t* empty1 = full1 + ST1;
  uint64_t* full2 = empty1 + ST1;
  uint64_t* empty2 = full2 + ST2;

  const int row0 = blockIdx.x * F::BM;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the elected TMA thread is warpgroup 1's: with the ping-pong it is the
  // later of the two to release a stage, so it seldom waits for the other
  const bool producer = threadIdx.x == 128;

  // chunk j's W1 rows: [a 0..15 | gate 0..15 | a 16..31 | gate 16..31], so
  // that each half of the split form is 32 contiguous rows
  auto load_w1 = [&](int j) {
    const int s = j % ST1;
    unsigned char* dst = w1_s + s * F::W1_BYTES;
    mbar_expect_tx(full1 + s, F::W1_BYTES);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = (q & 1) * 4 * C + j * kChunk + (q >> 1) * 16;
#pragma unroll
      for (int c = 0; c < F::NCH; ++c)
        tma_load_2d(dst + c * 2 * kChunk * kAtomBytes + q * 16 * kAtomBytes,
                    &tw1, full1 + s, c * 64, src);
    }
  };
  // W2's 32 columns of chunk j: C rows in boxes of 64
  auto load_w2 = [&](int j) {
    const int s = j % ST2;
    unsigned char* dst = w2_s + s * F::W2_BYTES;
    mbar_expect_tx(full2 + s, F::W2_BYTES);
#pragma unroll
    for (int r = 0; r < C / 64; ++r)
      tma_load_2d(dst + r * 64 * kChunk * 2, &tw2, full2 + s, j * kChunk,
                  r * 64);
  };
  // a stage is free once all 8 warps are done with it
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_x, 1);
    for (int s = 0; s < ST1; ++s) {
      mbar_init(full1 + s, 1);
      mbar_init(empty1 + s, 8);
    }
    for (int s = 0; s < ST2; ++s) {
      mbar_init(full2 + s, 1);
      mbar_init(empty2 + s, 8);
    }
    fence_barrier_init();
  }
  // no thread waits on a barrier, and no TMA load completes on one, before
  // its initialisation is visible to the block
  __syncthreads();
  if (producer) {
    mbar_expect_tx(full_x, F::X_BYTES);
#pragma unroll
    for (int c = 0; c < F::NCH; ++c)
      tma_load_2d(x_s + c * F::BM * kAtomBytes, &tx, full_x, c * 64, row0);
    for (int j = 0; j < ST1; ++j) load_w1(j);
    for (int j = 0; j < ST2; ++j) load_w2(j);
  }
  __syncwarp();

  // operand addresses: the warpgroup's 64 rows of x (C <= 320), its 32 W1
  // rows and its CW W2 rows (split)
  const uint32_t x_addr =
      smem_u32(x_s) + (F::kSplit ? 0 : wg * 64 * kAtomBytes);
  const uint32_t w1_addr =
      smem_u32(w1_s) + (F::kSplit ? wg * kChunk * kAtomBytes : 0);
  const uint32_t w2_addr =
      smem_u32(w2_s) + (F::kSplit ? wg * F::CW * kChunk * 2 : 0);
  const uint32_t g_addr = smem_u32(g_s);
  // ping-pong (C <= 320): the warpgroups issue their products in turns, so
  // that one computes its gate while the other's products run. A turn is a
  // sync on the own barrier and then an arrival on the other's: warpgroup 1
  // gives warpgroup 0 the first turn, each takes NJ + 1 turns, and
  // warpgroup 0's last sync takes warpgroup 1's last arrival. A warpgroup
  // arrives again only after the other's turn, so no barrier phase sees two
  // arrivals of one warpgroup. Within a turn a warpgroup waits only for W2
  // stages the producer loaded in an earlier turn of its own, and the
  // producer waits for empty stages only outside its turns, for stages both
  // warpgroups release outside theirs: no wait closes a cycle
  const int my_bar = 2 + wg, other_bar = 3 - wg;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float h[NH / 2];
  float gv[NG];
  uint32_t p[8];   // G as the register A operand (C <= 320): 2 k-steps

  // out += G(j) . W2_chunk^T, B K-major (64-byte rows, 64-byte swizzle)
  auto second = [&](int j) {
    const uint32_t w2 = w2_addr + (j % ST2) * F::W2_BYTES;
    mbar_wait(full2 + j % ST2, (j / ST2) & 1);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int i = 0; i < F::CW / F::NI; ++i) {
        const uint64_t db = desc_sw64(w2 + i * F::NI * kChunk * 2 + kc * 32,
                                      16, 512);
        if constexpr (F::kSplit)
          wgmma_ss<F::NI>(o + i * F::NI / 2,
                          desc_sw64(g_addr + (j & 1) * F::G_TILE + kc * 32,
                                    16, 512),
                          db, 1);
        else
          wgmma_rs_k<F::NI>(o + i * F::NI / 2, p + 4 * kc, db, 1);
      }
    wgmma_commit();
  };

  mbar_wait(full_x, 0);
  if (kPingPong && wg == 1) named_arrive(2, kThreadsFfn);
  for (int j = 0; j < F::NJ; ++j) {
    // ---- h = x . W1_chunk^T, then out += G(j-1) . W2^T
    const int s = j % ST1;
    const uint32_t ph = (j / ST1) & 1;
    mbar_wait(full1 + s, ph);
    if (kPingPong) named_sync(my_bar, kThreadsFfn);
    wgmma_fence();
    mma_ss_kmajor<NH, C>(h, x_addr, F::BM * kAtomBytes,
                         w1_addr + s * F::W1_BYTES, 2 * kChunk * kAtomBytes);
    wgmma_commit();
    if (j > 0) second(j - 1);
    if (kPingPong) named_arrive(other_bar, kThreadsFfn);
    if (j > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(h);
    release(empty1 + s);
    if (producer && j + ST1 < F::NJ) {
      mbar_wait(empty1 + s, ph);
      load_w1(j + ST1);
    }
    __syncwarp();

    // ---- bias, gelu_fast and the gate in registers. h holds n8 blocks
    // [a 0..15 | gate 0..15 | a 16..31 | gate 16..31] of the chunk (C <= 320)
    // or [a | gate] of the warpgroup's 16 columns (split); G block m takes
    // a block am and gate block am + 2
#pragma unroll
    for (int m = 0; m < NG / 4; ++m) {
      const int am = F::kSplit ? m : (m >> 1) * 4 + (m & 1);
      const int col = j * kChunk + (F::kSplit ? wg * 16 : 0) + 8 * m + 2 * t;
      const float ba[2] = {bf16_at(b1 + col), bf16_at(b1 + col + 1)};
      const float bg[2] = {bf16_at(b1 + 4 * C + col),
                           bf16_at(b1 + 4 * C + col + 1)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[4 * m + e] = (h[4 * am + e] + ba[e & 1]) *
                        gelu_fast(h[4 * (am + 2) + e] + bg[e & 1]);
    }

    if (j > 0) {
      wgmma_wait<0>();
      fence_regs(o);
      if constexpr (!F::kSplit) fence_regs(p);
      release(empty2 + (j - 1) % ST2);
      if (producer && j - 1 + ST2 < F::NJ) {
        mbar_wait(empty2 + (j - 1) % ST2, ((j - 1) / ST2) & 1);
        load_w2(j - 1 + ST2);
      }
      __syncwarp();
    }
    if constexpr (F::kSplit) {
      // this warpgroup's 16 columns of the 64 x 32 G tile, written in the
      // 64-byte swizzle: 16-byte unit u of row r at u ^ ((r >> 1) & 3)
      unsigned char* gt = g_s + (j & 1) * F::G_TILE;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = warp * 16 + g + 8 * rr;
          const int unit = (2 * wg + m) ^ ((r >> 1) & 3);
          *reinterpret_cast<uint32_t*>(gt + r * 64 + unit * 16 + 4 * t) =
              pack_bf16(gv[4 * m + 2 * rr], gv[4 * m + 2 * rr + 1]);
        }
      fence_proxy_async();
      named_sync(1, kThreadsFfn);
    } else {
      to_bf16<NG>(p, gv);
    }
  }
  if (kPingPong) named_sync(my_bar, kThreadsFfn);
  second(F::NJ - 1);
  if (kPingPong) named_arrive(other_bar, kThreadsFfn);
  wgmma_wait<0>();
  fence_regs(o);
  // warpgroup 1's last arrival on warpgroup 0's barrier is matched here
  if (kPingPong && wg == 0) named_sync(my_bar, kThreadsFfn);

  // ---- epilogue: + b2, round once to bf16; rows past n are not stored
  const int r0 = row0 + (F::kSplit ? 0 : wg * 64) + warp * 16 + g;
  const int c0 = F::kSplit ? wg * F::CW : 0;
#pragma unroll
  for (int jj = 0; jj < F::CW / 8; ++jj) {
    const int col = c0 + 8 * jj + 2 * t;
    const float bias0 = bf16_at(b2 + col), bias1 = bf16_at(b2 + col + 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) =
            pack_bf16(o[4 * jj + 2 * rr] + bias0,
                      o[4 * jj + 2 * rr + 1] + bias1);
    }
  }
}

template <int C>
cudaError_t launch_ffn(const bf16* x, const bf16* w1, const bf16* b1,
                       const bf16* w2, const bf16* b2, bf16* out, int n,
                       cudaStream_t stream) {
  using F = Ffn<C>;
  CUtensorMap tx, tw1, tw2;
  cudaError_t err;
  if ((err = make_map_2d(&tx, x, C, n, 64, F::BM,
                         CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map_2d(&tw1, w1, C, 8 * C, 64, 16,
                         CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = make_map_2d(&tw2, w2, 4 * C, C, kChunk, 64,
                         CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(geglu_ffn_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + F::BM - 1) / F::BM);
  geglu_ffn_kernel<C><<<grid, kThreadsFfn, F::SMEM, stream>>>(
      tx, tw1, tw2, b1, b2, out, n);
  return cudaGetLastError();
}

// g[r, c] = bf16(a * bf16(gelu_fast(gate))) with a = h[r, c] and gate =
// h[r, inner + c]; eight columns a thread
__global__ void __launch_bounds__(256)
geglu_gate_kernel(const bf16* __restrict__ h, bf16* __restrict__ g,
                  long long n, int inner) {
  const int vpr = inner / 8;
  const long long total = n * vpr;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const long long r = i / vpr;
    const int v = (int)(i - r * vpr);
    const bf16* hr = h + r * 2 * inner + v * 8;
    const uint4 av = __ldg(reinterpret_cast<const uint4*>(hr));
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(hr + inner));
    const bf16* a = reinterpret_cast<const bf16*>(&av);
    const bf16* gate = reinterpret_cast<const bf16*>(&gv);
    uint4 ov;
    bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float ge = __bfloat162float(
          __float2bfloat16_rn(gelu_fast_rn(__bfloat162float(gate[e]))));
      o[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(a[e]), ge));
    }
    *reinterpret_cast<uint4*>(g + r * inner + v * 8) = ov;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_geglu_ffn(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int n,
                            int c, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* b1b = static_cast<const bf16*>(b1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* b2b = static_cast<const bf16*>(b2);
  auto* ob = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (c) {
#define VS_FFN_CASE(C) \
  case C:              \
    return (int)launch_ffn<C>(xb, w1b, b1b, w2b, b2b, ob, n, s);
    VS_FFN_CASE(64)
    VS_FFN_CASE(128)
    VS_FFN_CASE(192)
    VS_FFN_CASE(256)
    VS_FFN_CASE(320)
    VS_FFN_CASE(384)
    VS_FFN_CASE(512)
    VS_FFN_CASE(640)
#undef VS_FFN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// h (n, 2 * inner) -> g (n, inner), inner a multiple of 8
extern "C" int vs_geglu_gate(const void* h, void* g, int n, int inner,
                             void* stream) {
  if (n <= 0 || inner <= 0 || inner % 8) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * (inner / 8);
  const long long blocks = (total + 255) / 256;
  geglu_gate_kernel<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)),
                      256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<bf16*>(g), n, inner);
  return (int)cudaGetLastError();
}
