// Fused AnimateDiff temporal transformer for Hopper (sm_90a): TMA-fed
// weight rings and warpgroup matrix products (wgmma).
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
// in registers for the whole module. The softmax subtracts the row max.
//
// What bounds it on the H100: 44 C^2 + 8 F C operations a row with the FFN
// (18 C^2 + 8 F C without) against 6 C bytes of g, x and out a row, so by
// device memory it is bound by the tensor cores (0.603 ms for the level-0
// call's 131072 rows at C = 320, 0.247 ms for level 1's 32768 rows at
// C = 640 without the FFN, at 989 TFLOP/s). But the weights (44 C^2 bytes
// with the FFN, 4.5 MB at C = 320; 18 C^2 = 7.4 MB for the attention half
// at C = 640) do not fit in shared memory: every block reads all of them
// from L2. A model of that traffic (blocks x weight bytes, no counter read
// it): 1024 x 4.5 MB = 4.6 GB at level 0 with 128 rows a block, 512 x 7.4
// MB = 3.8 GB at level 1 with 64; at the 4.9 TB/s that the GEGLU kernel's
// modelled weight bytes over its measured time come to, 0.94 and 0.77 ms,
// above the tensor cores' bound (the card's L2 rate itself was not
// measured). So the design gives every weight tile as many rows as the
// registers hold, and streams the weights through a ring of TMA stages
// under the products. Measured (PERF.md, sections 5-6): level 1 0.87 ms,
// level 0 2.83 ms (the model's bytes over those times: 4.3 and 1.6 TB/s).
//
// Design. 256 threads, two warpgroups, no producer warp (a third warp on an
// SM quarter would cap ptxas at 168 registers); thread 0 issues the TMA
// loads between its own products. A warpgroup's rows are a "row set" of 64
// rows holding floor(64 / F) whole locations (rows ordered (location,
// frame); rows past them are zero and never stored), so every frame
// attention stays inside one row set.
// - C <= 320: two row sets a block (128 rows); each warpgroup keeps its 64 x C
//   fp32 h in wgmma accumulator registers (160 a thread at C = 320) and both
//   read each weight tile.
// - 320 < C <= 640: one row set (64 rows); warpgroup w keeps h's columns
//   [w C/2, (w+1) C/2) (160 a thread at C = 640), computes the q, k, v and
//   frame attention of its half of each head group, and the two halves meet
//   in shared memory (LayerNorm row sums, the attention output o, the GEGLU
//   intermediate) before each warpgroup adds its columns.
// - The g tile is loaded by the threads (16-byte loads, by row, so the two
//   layouts give the tile the same rows in the same order: only the global
//   address of a row differs). Every operand in shared memory is K-major in
//   32-column chunks of 64-byte rows with the 64-byte swizzle: the
//   LayerNorm / bf16(h) tile a (rows x C), and the q/o, k and v tiles of one
//   head group.
// - Weights stream through ONE ring of ST stages (2-4) of C x 32 bf16 each
//   (20 KB at C = 320, 40 KB at 640; full and empty mbarriers, 8 warps
//   release a stage) in the exact order the products read them: W_in's
//   32-column K-chunks; per attention block and head group, the group's Wq,
//   Wk, Wv rows (80 a warpgroup, several K-chunks a stage) and Wo's columns
//   of the group; per 32-column chunk of the GEGLU intermediate, W1's 32 a
//   and 32 gate rows (two stages) and W2's 32 columns; W_out's K-chunks. A
//   block first writes this schedule as a table of 8-byte entries into
//   shared memory. Thread 0 refills a stage right after its own warp has
//   released it, so one warpgroup never waits for a load that the other's
//   lag holds back behind a barrier it has not reached.
// - Products: every h product (proj_in, out-projection, FFN output,
//   proj_out) is an SS wgmma of N = C (or C/2) in pieces (four of 80 at
//   C = 320, else up to two). Attention one head group at a time: q, k, v
//   of the group (N = 80, several heads), then the frame attention of each
//   head on mma.sync with ldmatrix from shared memory (16 query rows a warp,
//   the keys of their own locations in 16-key chunks, two passes: row max
//   and sum, then bf16(P) and P v; 8FC/44C^2 = 0.9% of the operations at
//   C = 320), o written over q, then h += o Wo[:, group]^T with K the
//   group's width: no full q, k, v or o tile is kept. The GEGLU tail
//   reuses geglu_ffn.cu's forms: h of a 32-column chunk is an SS product,
//   the gate is applied in registers, and G is the register A operand of
//   the W2 product (C <= 320) or is exchanged through a double-buffered
//   64 x 32 shared tile (C > 320).
// - LayerNorm rows live in one warp's quads (C <= 320: no shared memory);
//   at C > 320 the two warpgroups' partial sums meet in shared memory, read
//   in a fixed order, so both compute the same bits. No atomics: two calls
//   give the same bits.
// - Both layouts tile one sequence of locations: the frame-major layout
//   takes its B x HW locations in (batch, location) order, the order of the
//   rows layout, so a row set holds the same locations at the same rows in
//   both, only a row's global address differs, and the layouts give the
//   same bits.
//
// Registers. h takes 160 of a thread's 255 at C = 320 and 640, so nothing
// else may be held across the kernel. What ptxas needed to build every
// width with no spill (each measured with ptxas -v, PERF.md section 6):
// loops over h's columns at compile time, whose loads and stores take the
// column as an immediate offset of one base register (ptxas otherwise
// computed and spilled an address a column); the LayerNorm applied as
// h * s + c (no h - mean kept from the variance pass); the thread-index
// values read anew from %tid.x where used; the schedule's sizes computed on
// the host (kernel parameters cost no registers); the schedule table; the
// attention's P built one 16-key chunk at a time (unrolled, ptxas
// interleaved the chunks' exponentials); four 80-column h pieces at
// C = 320; the wgmma descriptors built inside the asm from one base
// register and immediate offsets (Sw64 in wgmma_bf16.cuh). Every stage's products are waited for before the stage is
// released (wait<0>): a product group left in flight across a loop's back
// edge makes ptxas serialize every wgmma of the kernel (C7512).
// Tried and dropped: that wait<1> overlap (C7512); volatile loads with
// computed addresses (more spills); the attention-block loop unrolled
// (700 bytes of spill); a shared G tile at C <= 320 (no change).
//
// It replaced a kernel of one 8-warp block of 64 rows (32 at C = 640),
// mma.sync with B fragments read from L2 by every warp, h split by columns
// across warps with LayerNorm sums through shared memory, and full q, k, v
// tiles (5.04 ms at level 0, 2.62 ms at level 1 on the H100).

#include <math.h>

#include <utility>

#include "attention_sm90.cuh"
#include "common.cuh"

namespace {

using namespace vs::sm90;

constexpr int kThreadsFt = 256;
constexpr int kSmemMaxFt = 232448;
constexpr int kGW = 80;   // q/k/v product width of a warpgroup (N); head dim <= 80
constexpr int kRowSet = 64;

// byte offset of element (r, c) (c even) in a tile of `rows` rows stored as
// 32-column chunks of 64-byte rows with the 64-byte swizzle: 16-byte unit u
// of row r at u ^ ((r >> 1) & 3)
__device__ __forceinline__ uint32_t sw64_off(int r, int c, int rows) {
  return (uint32_t)((c >> 5) * rows * 64 + r * 64 +
                    ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + ((c & 7) << 1));
}

// zero that the compiler cannot see through: an address offset by it is not
// loop-invariant, so it is computed where it is used and not held across
// the loops around
__device__ __forceinline__ int opaque_zero() {
  return __shfl_sync(0xffffffffu, 0, 0);
}

// Loops over h's columns run at compile time (static_for), and their loads
// and stores take the column's offset as an immediate of the instruction:
// one base register a row, where ptxas otherwise computes an address a
// column ahead of time and spills them beside h's 160 registers
template <class F, int... I>
__device__ __forceinline__ void static_for_(F& f,
                                            std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

template <int OFF>
__device__ __forceinline__ void st_shared(uint32_t base, uint32_t v) {
  asm volatile("st.shared.b32 [%0+%2], %1;\n" ::"r"(base), "r"(v), "n"(OFF)
               : "memory");
}
template <int OFF>
__device__ __forceinline__ void st_global(bf16* base, uint32_t v) {
  asm volatile("st.global.b32 [%0+%2], %1;\n" ::"l"(base), "r"(v), "n"(OFF)
               : "memory");
}
template <int OFF>
__device__ __forceinline__ float2 ld_f2(const float* base) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2+%3];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(base), "n"(OFF));
  return v;
}
template <int OFF>
__device__ __forceinline__ float2 ld_bf2(const bf16* base) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1+%2];\n"
               : "=r"(v)
               : "l"(base), "n"(OFF));
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Shared addresses of one row of a sw64 tile (ROWS rows) for the column
// pairs (col0 + 8 jj + 2 t, +1), jj = 0, 1, ..: four bases, one per
// (col0 / 8 + jj) mod 4; jj / 4 selects the 32-column chunk (an immediate)
template <int ROWS>
struct RowAddr {
  uint32_t b[4];
  __device__ __forceinline__ RowAddr(uint32_t tile, int r, int col0, int t) {
    const int w8 = col0 >> 3;
    const int x = (r >> 1) & 3;
    tile += opaque_zero();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      b[k] = tile + ((w8 + k) >> 2) * ROWS * 64 + r * 64 +
             ((((w8 + k) & 3) ^ x) << 4) + 4 * t;
  }
  template <int JJ>
  __device__ __forceinline__ void store(uint32_t v) const {
    st_shared<(JJ >> 2) * ROWS * 64>(b[JJ & 3], v);
  }
};

// ldmatrix: four (or two) 8 x 8 bf16 matrices from shared memory, lane l
// giving the address of row l % 8 of matrix l / 8 (16 bytes); `.trans`
// hands each thread the transposed fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
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

template <int C>
struct Ft {
  static_assert(C % 64 == 0 && C >= 64 && C <= 640, "fused widths");
  static constexpr bool kSplit = C > 320;        // warpgroups split h's columns
  static constexpr int RSETS = kSplit ? 1 : 2;   // row sets a block
  static constexpr int BR = kRowSet * RSETS;     // rows a block
  static constexpr int CW = kSplit ? C / 2 : C;  // h columns a warpgroup
  // N pieces of an h product: two (one at CW <= 160), four of 80 at C = 320
  // (two of 160 spill: the placement of two 80-register accumulator blocks
  // leaves ptxas too little room beside them)
  static constexpr int NP = (!kSplit && CW == 320) ? 4 : CW > 160 ? 2 : 1;
  static constexpr int NI = CW / NP;
  static constexpr int NHR = CW / 2;             // h registers a thread
  static constexpr int GT = kSplit ? 2 * kGW : kGW;  // q/k/v weight rows a stage
  static constexpr int QW = kSplit ? 2 * kGW : 96;   // q/o, k, v tile columns
  static constexpr int NK = C / 32;              // 32-column K-chunks
  static constexpr int SB = (C > GT ? C : GT) * 64;  // stage bytes
  static constexpr int KPT = C / GT > 1 ? C / GT : 1;  // K-chunks a q/k/v stage
  static constexpr int KPT1 = C / 64;            // K-chunks a W1 stage (64 rows)
  static constexpr int A_BYTES = BR * C * 2;
  static constexpr int T_BYTES = BR * QW * 2;
  static constexpr int RED_BYTES = kSplit ? 4 * kRowSet * 4 : 0;
  static constexpr int FIXED = 1024 + A_BYTES + 3 * T_BYTES + RED_BYTES + 64;
  static constexpr int FIT = (kSmemMaxFt - FIXED) / SB;
  static constexpr int ST = FIT < 4 ? FIT : 4;   // ring stages
  static constexpr int SMEM = FIXED + ST * SB;
  static_assert(ST >= 2, "two stages must fit the shared memory");
  static_assert(CW % NP == 0 && NI % 16 == 0 && NI <= 160, "h products");
  static_assert(2 * 64 * 32 * 2 <= T_BYTES, "the GEGLU exchange tile");
};

// the weights' tensor maps (two of each attention matrix: the blocks)
enum : uint16_t {
  kMapWIn, kMapWOut, kMapW1, kMapW2,
  kMapWq, kMapWk = kMapWq + 2, kMapWv = kMapWk + 2, kMapWo = kMapWv + 2,
  kMaps = kMapWo + 2
};
struct Maps {
  CUtensorMap m[kMaps];
};

// One stage of the weight stream: the map, the column and row of its box,
// and, for q/k/v rows, its number of 32-column K-chunks (0 for C rows of 32
// columns, W1's 64 rows have KPT1). A block writes the table of its stages
// into shared memory first, so that the refill in the product loops reads
// one entry instead of decoding the schedule beside h's registers.
struct Stage {
  uint16_t map, x, y, n;
};

struct Params {
  const bf16* g;
  const bf16* x;
  bf16* out;
  const bf16* pe;  // (F, C)
  const float* b_in;
  const float* ln_g[2];
  const float* ln_b[2];
  const float* bo[2];
  const float* ff_g;
  const float* ff_b;
  const float* b1;  // (8C)
  const float* b2;
  const float* b_out;
  long long n_loc;  // locations (layout 1: B HW, in (batch, location) order)
  int hw;           // layout 1: HW
  int heads, d, f, include_ffn, layout;
  float scale;
  // derived on the host (kernel parameters cost no registers):
  int locs;        // whole locations a 64-row set (64 / f)
  int hg;          // heads of a warpgroup's part of a head group (hg d <= 80)
  int ga;          // a warpgroup's columns of a head group (hg d)
  int gg;          // a group's columns (ga, or 2 ga at C > 320)
  int g16;         // gg rounded up to 16: the out-projection's K
  int hpg;         // heads a group
  int ngroups;
  int valid;       // rows of a row set with data (locs f)
  int to;          // Wo stages a group (32 columns each)
  int per_group;   // stages a group: q, k, v and Wo
  int attn_tiles;  // stages of the two attention blocks
  int n_tiles;     // stages of the kernel
};

// global row of tile row R, or -1 past the data (layout 0: (L*F, C) rows
// ordered (location, frame); layout 1: (B, F, HW, C), location l at batch
// l / HW; the host keeps B HW below 2^31)
template <int RSETS>
__device__ __forceinline__ long long global_row(const Params& p, int R) {
  const int rr = R & (kRowSet - 1);
  if (rr >= p.locs * p.f) return -1;
  const int loc = rr / p.f;
  const int fr = rr - loc * p.f;
  const long long l =
      ((long long)blockIdx.x * RSETS + (R >> 6)) * p.locs + loc;
  if (l >= p.n_loc) return -1;
  if (p.layout == 0) return l * p.f + fr;
  const int bi = (int)l / p.hw;
  return ((long long)bi * p.f + fr) * p.hw + ((int)l - bi * p.hw);
}

// acc (64 x N) += A . B^T over one 32-column K-chunk (two k-steps): A (64
// rows at a + OA) and B (N rows at b + OB) K-major in shared memory,
// 64-byte swizzle; the offsets are immediates of the instructions
template <int N, int OA, int OB>
__device__ __forceinline__ void mma_chunk(float* acc, uint32_t a, uint32_t b) {
  Sw64<N>::template ss<OA, OB>(acc, a, b);
  Sw64<N>::template ss<OA + 32, OB + 32>(acc, a, b);
}

// Frame attention of one head for the 16 query rows [r0, r0 + 16) of a row
// set (tile rows R0 + ..): q (scaled), k, v at columns [c0, c0 + d) of sw64
// tiles of BR rows (shared addresses qo, kt, vt); the output overwrites q.
// Keys are the rows of the query's own location, in 16-key chunks: a first
// pass takes each row's max and sum of exponentials, a second recomputes
// the logits of each chunk and rounds the probabilities to bf16 (P's A
// fragments), then o = P v, 24 columns at a time. Rows past `valid` get
// o = 0.
// Fragments come by ldmatrix (one address a lane).
template <int BR>
__device__ __forceinline__ void attend_head(unsigned char* qs, uint32_t kt,
                                            uint32_t vt, int R0, int r0,
                                            int valid, int f, int d, int c0) {
  const uint32_t qo = smem_u32(qs);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  r0 += opaque_zero();   // what follows is computed here, not held across loops
  const int loc_lo = r0 / f;
  const int loc_hi = min(r0 + 15, valid - 1) / f;
  const int k_lo = (loc_lo * f) & ~15;
  const int k_hi = min(((loc_hi + 1) * f + 15) & ~15, kRowSet);
  const int nch = (k_hi - k_lo) / 16;  // 16-key chunks, <= 4
  // keys of the rows' own locations: [lo, min(lo + f, valid))
  int lo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) lo[hf] = (r0 + g + 8 * hf) / f * f;
  // q rows by lane % 16, column half by lane / 16; a chunk's keys by
  // lane % 8 and lane / 16, column half by lane / 8 % 2
  const int qcol = c0 + (lane >> 4) * 8;
  const int krow = R0 + k_lo + (lane & 7) + ((lane >> 4) << 3);
  const int kcol = c0 + ((lane >> 3) & 1) * 8;

  // logits of chunk ch, keys of other locations (and past the data) -inf
  auto scores = [&](float (&s)[2][4], int ch) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += 16) {
      const bool half = k0 + 8 >= d;  // columns k0+8.. are the next head's
      uint32_t a[4], b[4];
      ldsm_x4(a, qo + sw64_off(R0 + r0 + (lane & 15), qcol + k0, BR));
      ldsm_x4(b, kt + sw64_off(krow + 16 * ch, kcol + k0, BR));
      if (half) a[2] = a[3] = b[1] = b[3] = 0u;
      vs::mma_16816(s[0], a, b);
      vs::mma_16816(s[1], a, b + 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k_lo + 16 * ch + 8 * j + 2 * t + (e & 1);
        if (key < lo[e >> 1] || key >= min(lo[e >> 1] + f, valid))
          s[j][e] = -INFINITY;
      }
  };

  // pass 1: row max m and (per thread) sum of exponentials l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int ch = 0; ch < nch; ++ch) {
    float s[2][4];
    scores(s, ch);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                       fmaxf(s[1][2 * hf], s[1][2 * hf + 1]));
      mx = fmaxf(quad_max(mx), m[hf]);
      if (mx != -INFINITY) {
        float sum = m[hf] == -INFINITY ? 0.0f : l[hf] * __expf(m[hf] - mx);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = s[j][2 * hf + e];
            sum += v == -INFINITY ? 0.0f : __expf(v - mx);
          }
        l[hf] = sum;
        m[hf] = mx;
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float sum = quad_sum(l[hf]);
    inv[hf] = sum > 0.0f ? 1.0f / sum : 0.0f;  // rows past the data
  }

  // pass 2: P = bf16(probabilities) as the A fragments of each chunk; then
  // o = P v, 24 columns of o at a time (three n8-tiles: a pair by
  // ldmatrix.x4.trans, keys by lane % 16 and columns by lane / 16, and one
  // by ldmatrix.x2.trans)
  // (one chunk at a time, placed by its index: unrolled, ptxas would
  // interleave the chunks' exponentials and spill beside h)
  uint32_t pa[4][4];
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    float s[2][4];
    scores(s, ch);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[j][e];
        s[j][e] = v == -INFINITY
                      ? 0.0f
                      : exp2_approx((v - m[e >> 1]) * kLog2e) * inv[e >> 1];
      }
    uint32_t p4[4];
    vs::frag_a_from_c(p4, s[0], s[1]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ch == k) pa[k][i] = p4[i];
  }
  // every lane has read q of this head before o overwrites it
  __syncwarp();
  const int vrow = R0 + k_lo + (lane & 15);
  const int vcol = c0 + (lane >> 4) * 8;
  for (int n0 = 0; n0 < d; n0 += 24) {
    const int nt = min(3, (d - n0) / 8);
    float o[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch < nch) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (2 * jp + 1 < nt) {
            uint32_t b[4];
            ldsm_x4_t(b, vt + sw64_off(vrow + 16 * ch, vcol + n0 + 16 * jp,
                                       BR));
            vs::mma_16816(o[2 * jp], pa[ch], b);
            vs::mma_16816(o[2 * jp + 1], pa[ch], b + 2);
          } else if (2 * jp < nt) {
            uint32_t b[2];
            ldsm_x2_t(b, vt + sw64_off(vrow + 16 * ch, c0 + n0 + 16 * jp,
                                       BR));
            vs::mma_16816(o[2 * jp], pa[ch], b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < nt) {
        const int col = c0 + n0 + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(qs + sw64_off(R0 + r0 + g, col, BR)) =
            pack_bf16(o[j][0], o[j][1]);
        *reinterpret_cast<uint32_t*>(qs + sw64_off(R0 + r0 + g + 8, col, BR)) =
            pack_bf16(o[j][2], o[j][3]);
      }
    }
  }
}

// threadIdx.x read anew at each use: the values derived from it (lane,
// warp, warpgroup, row and column offsets) are recomputed where they are
// needed instead of being held in registers for the whole kernel
__device__ __forceinline__ int tid_x() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

// stage i of the weight stream, in the order the products read them:
// W_in's K-chunks; per attention block and head group, the group's Wq, Wk,
// Wv rows (TQ stages each) and Wo's columns (p.to stages); per GEGLU chunk,
// W1 in two stages and W2; W_out's K-chunks
template <int C>
__device__ Stage stage_of(const Params& p, int i) {
  using T = Ft<C>;
  constexpr int TQ = (T::NK + T::KPT - 1) / T::KPT;
  constexpr int NJ = C / 8;
  auto st = [](int map, int x, int y, int n) {
    return Stage{(uint16_t)map, (uint16_t)x, (uint16_t)y, (uint16_t)n};
  };
  if (i < T::NK) return st(kMapWIn, 32 * i, 0, 0);
  i -= T::NK;
  if (i < p.attn_tiles) {
    const int blk = i / (p.ngroups * p.per_group);
    int r = i - blk * p.ngroups * p.per_group;
    const int gi = r / p.per_group;
    r -= gi * p.per_group;
    if (r < 3 * TQ) {
      const int which = r / TQ;
      const int c0 = (r - which * TQ) * T::KPT;
      const int c1 = min(T::NK, c0 + T::KPT);
      return st(kMapWq + 2 * which + blk, 32 * c0, gi * p.gg, c1 - c0);
    }
    return st(kMapWo + blk, gi * p.gg + 32 * (r - 3 * TQ), 0, 0);
  }
  i -= p.attn_tiles;
  if (i < NJ * 3) {
    const int j = i / 3;
    const int r = i - 3 * j;
    if (r < 2) return st(kMapW1, 32 * r * T::KPT1, j * 32, T::KPT1);
    return st(kMapW2, 32 * j, 0, 0);
  }
  return st(kMapWOut, 32 * (i - NJ * 3), 0, 0);
}

template <int C>
__global__ void __launch_bounds__(kThreadsFt, 1)
fused_temporal_kernel(const __grid_constant__ Maps maps, const Params p) {
  using T = Ft<C>;
  constexpr int BR = T::BR;
  constexpr int NI = T::NI;
  constexpr int ST = T::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_s = base;                 // g, LayerNorm output, bf16(h)
  unsigned char* q_s = a_s + T::A_BYTES;     // q, then o (and the GEGLU tile)
  unsigned char* k_s = q_s + T::T_BYTES;
  unsigned char* v_s = k_s + T::T_BYTES;
  float* red = reinterpret_cast<float*>(v_s + T::T_BYTES);
  unsigned char* ring = v_s + T::T_BYTES + T::RED_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * T::SB);
  uint64_t* empty = full + ST;

  auto wg = [] { return tid_x() >> 7; };
  auto warp = [] { return (tid_x() >> 5) & 3; };
  auto lane = [] { return tid_x() & 31; };
  auto g = [] { return (tid_x() & 31) >> 2; };
  auto t = [] { return tid_x() & 3; };
  auto producer = [] { return tid_x() == 0; };
  // this warpgroup's first tile row (its row set's) and first h column
  auto R0 = [] { return T::kSplit ? 0 : (tid_x() >> 7) * kRowSet; };
  auto cb = [] { return T::kSplit ? (tid_x() >> 7) * T::CW : 0; };
  constexpr int TQ = (T::NK + T::KPT - 1) / T::KPT;  // stages of q, k or v
  constexpr int NJ = C / 8;                    // 32-column GEGLU chunks
  // ------------------------------------------------------ the weight stream
  Stage* sched = reinterpret_cast<Stage*>(empty + ST);
  auto load_tile = [&](int i) {
    const Stage e = sched[i];
    unsigned char* dst = ring + (i % ST) * T::SB;
    uint64_t* bar = full + i % ST;
    const CUtensorMap* m = &maps.m[e.map];
    if (e.map == kMapW1) {
      // rows [a 0..15 | gate 0..15 | a 16..31 | gate 16..31] of chunk y / 32
      mbar_expect_tx(bar, T::KPT1 * 64 * 64);
      for (int c = 0; c < T::KPT1; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load_2d(dst + c * 64 * 64 + q * 16 * 64, m, bar, e.x + 32 * c,
                      (q & 1) * 4 * C + e.y + (q >> 1) * 16);
    } else if (e.n) {
      // GT rows of q, k or v weights, e.n K-chunks
      mbar_expect_tx(bar, e.n * T::GT * 64);
      for (int c = 0; c < e.n; ++c)
        tma_load_2d(dst + c * T::GT * 64, m, bar, e.x + 32 * c, e.y);
    } else {
      // all C rows of 32 columns from x (W rows are h columns)
      mbar_expect_tx(bar, C * 64);
#pragma unroll
      for (int r = 0; r < C / 64; ++r)
        tma_load_2d(dst + r * 64 * 64, m, bar, e.x, r * 64);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < p.n_tiles; i += kThreadsFt)
    sched[i] = stage_of<C>(p, i);
  // no thread waits on a barrier, and no TMA load completes on one, before
  // its initialisation is visible to the block (nor reads the table before
  // it is written)
  __syncthreads();
  if (producer())
    for (int i = 0; i < ST && i < p.n_tiles; ++i) load_tile(i);

  int it = 0;     // tiles acquired so far
  auto release = [&](int i) {
    const int s = i % ST;
    if (lane() == 0) mbar_arrive(empty + s);
    if (producer() && i + ST < p.n_tiles) {
      mbar_wait(empty + s, (i / ST) & 1);
      load_tile(i + ST);
    }
    __syncwarp();
  };
  auto acquire = [&]() -> uint32_t {
    const int s = it % ST;
    mbar_wait(full + s, (it / ST) & 1);
    return smem_u32(ring + s * T::SB);
  };
  // after committing the acquired tile's products: wait for them and free
  // the stage. No product stays in flight across a loop's back edge: ptxas
  // then serializes every wgmma of the kernel (C7512); the two warpgroups
  // fill each other's gaps instead
  auto retire = [&]() {
    wgmma_wait<0>();
    release(it++);
  };
  // the warpgroups' common barrier (C > 320), or this warpgroup's
  auto sync_rows = [&]() {
    if constexpr (T::kSplit)
      named_sync(1, 256);
    else
      named_sync(2 + wg(), 128);
  };

  // ------------------------------------------------------ g -> a
  // q/o starts zero: columns no head writes (past the group's width, up to
  // the out-projection's last 32-column K-chunk) stay zero
  for (int i = threadIdx.x; i < T::T_BYTES / 16; i += kThreadsFt)
    reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < BR * (C / 8); i += kThreadsFt) {
    const int r = i / (C / 8);
    const int u = i - r * (C / 8);
    const long long gr = global_row<T::RSETS>(p, r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0) val = *reinterpret_cast<const uint4*>(p.g + gr * C + u * 8);
    *reinterpret_cast<uint4*>(a_s + sw64_off(r, u * 8, BR)) = val;
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t a_u32 = smem_u32(a_s);
  const uint32_t a_addr = a_u32 + R0() * 64;   // this row set's rows
  const uint32_t q_addr = smem_u32(q_s) + R0() * 64;
  float h[T::NHR];

  // h (+)= A . W^T over `n` wide tiles (a's K-chunks, or o's)
  auto h_product = [&](uint32_t a, int n) {
    for (int kc = 0; kc < n; ++kc) {
      const uint32_t b = acquire() + cb() * 64;
      wgmma_fence();
      static_for<T::NP>([&](auto pc) {
        constexpr int pi = decltype(pc)::value;
        mma_chunk<NI, 0, pi * NI * 64>(h + pi * NI / 2, a + kc * BR * 64, b);
      });
      wgmma_commit();
      retire();
    }
  };
  auto add_bias = [&](const float* bias) {
    bias += cb() + 2 * t() + opaque_zero();
    static_for<T::CW / 8>([&](auto jc) {
      constexpr int jj = decltype(jc)::value;
      const float2 bv = ld_f2<32 * jj>(bias);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        h[4 * jj + 2 * r] += bv.x;
        h[4 * jj + 2 * r + 1] += bv.y;
      }
    });
  };
  auto zero_h = [&]() {
#pragma unroll
    for (int i = 0; i < T::NHR; ++i) h[i] = 0.0f;
  };
  // bf16(LayerNorm(h) * gamma + beta (+ pe[frame])) -> a (this warpgroup's
  // rows and columns). A row's values lie in one quad of one warp; at
  // C > 320 the two warpgroups' partial sums meet in `red`, summed in a
  // fixed order.
  auto layernorm = [&](const float* gamma, const float* beta,
                       bool with_pe) {
    const float inv_c = 1.0f / (float)C;
    float mean[2], rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int jj = 0; jj < T::CW / 8; ++jj)
        s += h[4 * jj + 2 * r] + h[4 * jj + 2 * r + 1];
      mean[r] = quad_sum(s);
    }
    const int rr0 = warp() * 16 + g();
    if constexpr (T::kSplit) {
      if (t() == 0) {
        red[wg() * kRowSet + rr0] = mean[0];
        red[wg() * kRowSet + rr0 + 8] = mean[1];
      }
      named_sync(1, 256);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mean[r] = red[rr0 + 8 * r] + red[kRowSet + rr0 + 8 * r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mean[r] *= inv_c;
      float s = 0.0f;
#pragma unroll
      for (int jj = 0; jj < T::CW / 8; ++jj) {
        const float z0 = h[4 * jj + 2 * r] - mean[r];
        const float z1 = h[4 * jj + 2 * r + 1] - mean[r];
        s += z0 * z0 + z1 * z1;
      }
      rstd[r] = quad_sum(s);
    }
    if constexpr (T::kSplit) {
      float* red2 = red + 2 * kRowSet;
      if (t() == 0) {
        red2[wg() * kRowSet + rr0] = rstd[0];
        red2[wg() * kRowSet + rr0 + 8] = rstd[1];
      }
      named_sync(1, 256);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rstd[r] = red2[rr0 + 8 * r] + red2[kRowSet + rr0 + 8 * r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) rstd[r] = rsqrtf(rstd[r] * inv_c + 1e-6f);
    // gamma, beta and pe at this thread's columns (pe: the rows' frames;
    // it is the same in every attention block, and is kept from being
    // loaded once for both and held across them)
    const int z = opaque_zero();
    gamma += cb() + 2 * t() + z;
    beta += cb() + 2 * t() + z;
    const bf16* pe_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pe_row[r] = p.pe + (size_t)((rr0 + 8 * r) % p.f) * C + cb() + 2 * t() + z;
    const RowAddr<BR> dst[2] = {RowAddr<BR>(a_u32, R0() + rr0, cb(), t()),
                                RowAddr<BR>(a_u32, R0() + rr0 + 8, cb(), t())};
    // h * (rstd gamma) + (beta - mean rstd gamma): no h - mean of the
    // variance pass to keep (160 values live beside h: spills)
    static_for<T::CW / 8>([&](auto jc) {
      constexpr int jj = decltype(jc)::value;
      const float2 gv = ld_f2<32 * jj>(gamma);
      const float2 bv = ld_f2<32 * jj>(beta);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float s0 = rstd[r] * gv.x, s1 = rstd[r] * gv.y;
        float v0 = fmaf(h[4 * jj + 2 * r], s0, fmaf(-mean[r], s0, bv.x));
        float v1 = fmaf(h[4 * jj + 2 * r + 1], s1, fmaf(-mean[r], s1, bv.y));
        if (with_pe) {
          const float2 pv = ld_bf2<16 * jj>(pe_row[r]);
          v0 += pv.x;
          v1 += pv.y;
        }
        dst[r].template store<jj>(pack_bf16(v0, v1));
      }
    });
    fence_proxy_async();
    sync_rows();
  };

  // ------------------------------------------------------ proj_in
  zero_h();
  h_product(a_addr, T::NK);
  fence_regs(h);
  add_bias(p.b_in);

  // ------------------------------------------------------ attention blocks
  // this warpgroup's q/k/v columns of a group, and this warp's 16 rows
  auto wcol = [&] { return T::kSplit ? wg() * p.ga : 0; };
  auto r0 = [] { return ((tid_x() >> 5) & 3) * 16; };
  for (int blk = 0; blk < 2; ++blk) {
    layernorm(blk ? p.ln_g[1] : p.ln_g[0], blk ? p.ln_b[1] : p.ln_b[0],
              true);
    for (int gi = 0; gi < p.ngroups; ++gi) {
      // q, k, v of the group: N = 80 rows of the stage from this warpgroup's
      // first; columns past ga are not kept
#pragma unroll
      for (int which = 0; which < 3; ++which) {
        float acc[kGW / 2];
#pragma unroll
        for (int i = 0; i < kGW / 2; ++i) acc[i] = 0.0f;
        // NK / KPT stages of KPT K-chunks, then one of the rest
        for (int tt = 0; tt < T::NK / T::KPT; ++tt) {
          const uint32_t b = acquire() + wcol() * 64;
          wgmma_fence();
          static_for<T::KPT>([&](auto cc) {
            constexpr int c = decltype(cc)::value;
            mma_chunk<kGW, c * BR * 64, c * T::GT * 64>(
                acc, a_addr + tt * T::KPT * BR * 64, b);
          });
          wgmma_commit();
          retire();
        }
        if constexpr (T::NK % T::KPT != 0) {
          const uint32_t b = acquire() + wcol() * 64;
          wgmma_fence();
          static_for<T::NK % T::KPT>([&](auto cc) {
            constexpr int c = decltype(cc)::value;
            mma_chunk<kGW, (T::NK / T::KPT * T::KPT + c) * BR * 64,
                      c * T::GT * 64>(acc, a_addr, b);
          });
          wgmma_commit();
          retire();
        }
        fence_regs(acc);
        // at C > 320 the other warpgroup may still read o of the group
        // before: wait for it before q is written over o
        if (which == 0 && T::kSplit) named_sync(1, 256);
        const uint32_t tile =
            smem_u32(which == 0 ? q_s : which == 1 ? k_s : v_s);
        const float mul = which == 0 ? p.scale : 1.0f;
        const RowAddr<BR> dst[2] = {
            RowAddr<BR>(tile, R0() + r0() + g(), wcol(), t()),
            RowAddr<BR>(tile, R0() + r0() + g() + 8, wcol(), t())};
        static_for<kGW / 8>([&](auto jc) {
          constexpr int jj = decltype(jc)::value;
          const int col = 8 * jj + 2 * t();
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (col < p.ga)
              dst[r].template store<jj>(pack_bf16(acc[4 * jj + 2 * r] * mul,
                                                  acc[4 * jj + 2 * r + 1] * mul));
            else if (!T::kSplit && which == 0 && col < p.g16)
              // the out-projection's last k-step reads these: zero (at
              // C > 320 a group's width is a multiple of 16)
              dst[r].template store<jj>(0u);
          }
        });
      }
      sync_rows();
      // the frame attention of this warpgroup's heads of the group
      const int h0 = gi * p.hpg + (T::kSplit ? wg() * p.hg : 0);
      const int nh = min(p.hg, p.heads - h0);
      if (r0() < p.valid)
        for (int hh = 0; hh < nh; ++hh)
          attend_head<BR>(q_s, smem_u32(k_s), smem_u32(v_s), R0(), r0(), p.valid,
                          p.f, p.d, wcol() + hh * p.d);
      fence_proxy_async();
      sync_rows();
      // h += o . Wo[:, group]^T over the group's columns (o's columns past
      // them are zero)
      h_product(q_addr, p.to);
    }
    fence_regs(h);
    add_bias(blk ? p.bo[1] : p.bo[0]);
  }

  // ------------------------------------------------------ GEGLU FFN, proj_out
  if (p.include_ffn) {
    layernorm(p.ff_g, p.ff_b, false);
    constexpr int NH = T::kSplit ? 32 : 64;   // W1 product columns
    constexpr int NG = NH / 4;                // G values a thread
    const uint32_t g_addr = smem_u32(q_s);    // the exchange tile (C > 320)
    for (int j = 0; j < NJ; ++j) {
      float hw[NH / 2];
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) hw[i] = 0.0f;
      for (int r = 0; r < 2; ++r) {
        const uint32_t b = acquire() + (T::kSplit ? wg() * 32 * 64 : 0);
        wgmma_fence();
        static_for<T::KPT1>([&](auto cc) {
          constexpr int c = decltype(cc)::value;
          mma_chunk<NH, c * BR * 64, c * 64 * 64>(
              hw, a_addr + r * T::KPT1 * BR * 64, b);
        });
        wgmma_commit();
        retire();
      }
      fence_regs(hw);
      // bias, gelu_fast and the gate in registers: hw holds n8 blocks
      // [a 0..15 | gate 0..15 | a 16..31 | gate 16..31] of the chunk, or
      // [a | gate] of this warpgroup's 16 columns (C > 320)
      // G, rounded to bf16 in pairs: pk[2m + rr] holds row g + 8 rr of
      // columns 8m + 2t, +1
      uint32_t pk[NG / 2];
      {
        const float* b1c =
            p.b1 + j * 32 + (T::kSplit ? wg() * 16 : 0) + 2 * t();
        static_for<NG / 4>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          constexpr int am = T::kSplit ? m : (m >> 1) * 4 + (m & 1);
          const float2 ba = ld_f2<32 * m>(b1c);
          const float2 bg = ld_f2<4 * (4 * C + 8 * m)>(b1c);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            pk[2 * m + rr] = pack_bf16(
                (hw[4 * am + 2 * rr] + ba.x) *
                    gelu_fast(hw[4 * (am + 2) + 2 * rr] + bg.x),
                (hw[4 * am + 2 * rr + 1] + ba.y) *
                    gelu_fast(hw[4 * (am + 2) + 2 * rr + 1] + bg.y));
        });
      }
      const uint32_t b = acquire() + cb() * 64;
      if constexpr (T::kSplit) {
        // this warpgroup's 16 columns of the 64 x 32 G tile (64-byte
        // swizzle), double-buffered: the other warpgroup may still read the
        // tile of chunk j - 1
        unsigned char* gt = q_s + (j & 1) * 64 * 64;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<uint32_t*>(
                gt + sw64_off(r0() + g() + 8 * rr, wg() * 16 + 8 * m + 2 * t(),
                              64)) = pk[2 * m + rr];
        fence_proxy_async();
        named_sync(1, 256);
        wgmma_fence();
        static_for<2 * T::NP>([&](auto kp) {
          constexpr int kc = decltype(kp)::value / T::NP;
          constexpr int pi = decltype(kp)::value % T::NP;
          Sw64<NI>::template ss<32 * kc, pi * NI * 64 + 32 * kc>(
              h + pi * NI / 2, g_addr + (j & 1) * 64 * 64, b);
        });
      } else {
        wgmma_fence();
        static_for<2 * T::NP>([&](auto kp) {
          constexpr int kc = decltype(kp)::value / T::NP;
          constexpr int pi = decltype(kp)::value % T::NP;
          Sw64<NI>::template rs_k<pi * NI * 64 + 32 * kc>(h + pi * NI / 2,
                                                         pk + 4 * kc, b);
        });
      }
      wgmma_commit();
      retire();
    }
    fence_regs(h);
    add_bias(p.b2);

    // proj_out on bf16(h): h's registers become the output accumulator
    {
      const RowAddr<BR> dst[2] = {RowAddr<BR>(a_u32, R0() + r0() + g(), cb(), t()),
                                  RowAddr<BR>(a_u32, R0() + r0() + g() + 8, cb(), t())};
      static_for<T::CW / 8>([&](auto jc) {
        constexpr int jj = decltype(jc)::value;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dst[r].template store<jj>(
              pack_bf16(h[4 * jj + 2 * r], h[4 * jj + 2 * r + 1]));
      });
    }
    fence_proxy_async();
    sync_rows();
    zero_h();
    h_product(a_addr, T::NK);
    fence_regs(h);
  }

  // ------------------------------------------------------ epilogue
  // each row's x and out at this thread's columns; columns outer, rows
  // inner, so that each b_out pair is loaded once for both rows
  const bf16* xr[2];
  bf16* orow[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long gr = global_row<T::RSETS>(p, R0() + r0() + g() + 8 * r);
    ok[r] = gr >= 0;
    xr[r] = p.x + gr * C + cb() + 2 * t();
    orow[r] = p.out + gr * C + cb() + 2 * t();
  }
  const float* bout = p.b_out + cb() + 2 * t();
  static_for<T::CW / 8>([&](auto jc) {
    constexpr int jj = decltype(jc)::value;
    const float2 bv =
        p.include_ffn ? ld_f2<32 * jj>(bout) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!ok[r]) continue;
      float v0 = h[4 * jj + 2 * r], v1 = h[4 * jj + 2 * r + 1];
      if (p.include_ffn) {
        const float2 xv = ld_bf2<16 * jj>(xr[r]);
        v0 = xv.x + v0 + bv.x;
        v1 = xv.y + v1 + bv.y;
      }
      st_global<16 * jj>(orow[r], pack_bf16(v0, v1));
    }
  });
}

// A 2-D map over a row-major (rows x cols) bf16 weight, boxes of 32 columns
// (64 bytes, 64-byte swizzle) by box_rows rows; past the edge reads zero
inline cudaError_t weight_map(CUtensorMap* m, const void* w, int cols,
                              int rows, int box_rows) {
  return make_map_2d(m, w, cols, rows, 32, box_rows,
                     CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int C>
cudaError_t launch_ft(const void* const* w, Params p, cudaStream_t stream) {
  using T = Ft<C>;
  p.locs = kRowSet / p.f;
  p.hg = kGW / p.d < p.heads ? kGW / p.d : p.heads;
  p.ga = p.hg * p.d;
  p.gg = T::kSplit ? 2 * p.ga : p.ga;
  p.g16 = (p.gg + 15) & ~15;
  p.hpg = T::kSplit ? 2 * p.hg : p.hg;
  p.ngroups = (p.heads + p.hpg - 1) / p.hpg;
  p.valid = p.locs * p.f;
  p.to = (p.g16 + 31) / 32;
  p.per_group = 3 * ((T::NK + T::KPT - 1) / T::KPT) + p.to;
  p.attn_tiles = 2 * p.ngroups * p.per_group;
  p.n_tiles = T::NK + p.attn_tiles + (p.include_ffn ? (C / 8) * 3 + T::NK : 0);
  // w: w_in, wq0, wk0, wv0, wo0, wq1, wk1, wv1, wo1, w1, w2, w_out (the
  // last three null without the FFN)
  Maps m;
  cudaError_t err;
  const void* w1 = w[9] ? w[9] : w[0];
  const void* w2 = w[10] ? w[10] : w[0];
  const void* wout = w[11] ? w[11] : w[0];
  if ((err = weight_map(&m.m[kMapWIn], w[0], C, C, 64)) != cudaSuccess ||
      (err = weight_map(&m.m[kMapWOut], wout, C, C, 64)) != cudaSuccess ||
      (err = weight_map(&m.m[kMapW1], w1, C, w[9] ? 8 * C : C, 16)) !=
          cudaSuccess ||
      (err = weight_map(&m.m[kMapW2], w2, w[10] ? 4 * C : C, C, 64)) !=
          cudaSuccess)
    return err;
  for (int b = 0; b < 2; ++b)
    if ((err = weight_map(&m.m[kMapWq + b], w[1 + 4 * b], C, C, T::GT)) !=
            cudaSuccess ||
        (err = weight_map(&m.m[kMapWk + b], w[2 + 4 * b], C, C, T::GT)) !=
            cudaSuccess ||
        (err = weight_map(&m.m[kMapWv + b], w[3 + 4 * b], C, C, T::GT)) !=
            cudaSuccess ||
        (err = weight_map(&m.m[kMapWo + b], w[4 + 4 * b], C, C, 64)) !=
            cudaSuccess)
      return err;
  // the schedule table after the fixed layout
  const int smem = T::SMEM + 8 * p.n_tiles;
  if (smem > kSmemMaxFt) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_temporal_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.n_loc + p.locs - 1) / p.locs;
  const long long blocks = (tiles + T::RSETS - 1) / T::RSETS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_temporal_kernel<C><<<(unsigned)blocks, kThreadsFt, smem, stream>>>(m,
                                                                           p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: g, x, out, pe, then the parameters in the order of
// videoswap_tpu/ops/fused_temporal.py `flatten_tt_params` (one block):
// w_in, b_in, 2 x (ln_g, ln_b, wq, wk, wv, wo, bo), and with the FFN
// ff_g, ff_b, w1, b1, w2, b2, w_out, b_out. layout 0: g, x, out are
// (n_loc * f, c) rows ordered (location, frame), batch = 1; layout 1: they
// are (batch, f, n_loc, c), batch * n_loc < 2^31. Returns a cudaError_t
// code: 0 when the launch was accepted.
extern "C" int vs_fused_temporal(const void* const* ptrs, int n_ptrs, int c,
                                 int heads, int f, int include_ffn,
                                 int layout, long long n_loc, int batch,
                                 float scale, void* stream) {
  const int want = include_ffn ? 28 : 20;
  if (n_ptrs != want || c <= 0 || c % 64 != 0 || c > 640 || heads <= 0 ||
      c % heads != 0 || (c / heads) % 8 != 0 || c / heads > kGW || f <= 0 ||
      f > kRowSet || n_loc <= 0 || batch <= 0 ||
      (layout == 0 && batch != 1) || (layout != 0 && layout != 1) ||
      (layout == 1 && n_loc * batch > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  Params p;
  int i = 0;
  auto nb = [&]() { return static_cast<const bf16*>(ptrs[i++]); };
  auto nf = [&]() { return static_cast<const float*>(ptrs[i++]); };
  const void* w[12] = {};
  p.g = nb();
  p.x = nb();
  p.out = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.pe = nb();
  w[0] = ptrs[i++];
  p.b_in = nf();
  for (int j = 0; j < 2; ++j) {
    p.ln_g[j] = nf();
    p.ln_b[j] = nf();
    for (int k = 0; k < 4; ++k) w[1 + 4 * j + k] = ptrs[i++];
    p.bo[j] = nf();
  }
  p.ff_g = p.ff_b = p.b1 = p.b2 = p.b_out = nullptr;
  if (include_ffn) {
    p.ff_g = nf();
    p.ff_b = nf();
    w[9] = ptrs[i++];
    p.b1 = nf();
    w[10] = ptrs[i++];
    p.b2 = nf();
    w[11] = ptrs[i++];
    p.b_out = nf();
  }
  p.n_loc = n_loc * batch;
  p.hw = (int)(layout ? n_loc : 0);
  p.heads = heads;
  p.d = c / heads;
  p.f = f;
  p.include_ffn = include_ffn;
  p.layout = layout;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  switch (c) {
#define VS_FT_CASE(C) \
  case C:             \
    return (int)launch_ft<C>(w, p, s);
    VS_FT_CASE(64)
    VS_FT_CASE(128)
    VS_FT_CASE(192)
    VS_FT_CASE(256)
    VS_FT_CASE(320)
    VS_FT_CASE(384)
    VS_FT_CASE(448)
    VS_FT_CASE(512)
    VS_FT_CASE(576)
    VS_FT_CASE(640)
#undef VS_FT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
