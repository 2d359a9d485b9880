// Hash-grid table gradient (a scatter-add) for Hopper (sm_90a), all levels
// of one backward in one launch.
//
// Replaces: videoswap_tpu/ops/hash_table_grad.py:125, `hash_table_grad` /
// `_kernel` (the Pallas TPU kernel behind the atlas hash encoding's custom
// VJP, one call a level there).
//
// For each level l < L: out[l, idx[l, r], :] += val[l, r, :] for every row r
// with 0 <= idx[l, r] < used[l]; other rows (the negative padding rows, and
// rows past the level's used entries) are dropped. idx (L, R) int32, val
// (L, R, F) fp32 row-major, out (L, T, F) fp32 with used[l] <= T,
// accumulated into. The TPU kernel phrases this as one-hot matrix products
// over a hi/lo split of the index with each fp32 value split into two bf16
// halves: a workaround for the TPU's serial scatter, which gives one answer.
// Here it is written as the scatter it is, in fixed point, so that it gives
// one answer too.
//
// Deterministic: each finite value of level l is rounded once to a 64-bit
// integer at the level's own scale, 2^k with max|val| * 2^Rb * 2^k <= 2^62
// (max|val| over the level's finite kept values, R < 2^Rb), and the integers
// are summed with integer atomics, whose sum does not depend on the order
// they commit in. The table is then scaled back and added to out in fp32.
// Each term is off by at most half a unit, 2^-k; a sum of R terms by at most
// R/2 units, below max|val| * 2^(2*Rb - 62) (1.5e-8 of max|val| at 240000
// rows), and the sum of |terms| stays below 2^63. A value that is not finite
// (a diverging step) is added to out in fp32 instead, as the plain version
// adds it: sums of infinities and NaNs do not depend on order either, and
// the entry comes out NaN or infinite as index_add_ leaves it. Each level's
// table is the bits of `hash_table_grad_fixed` on that level alone.
//
// What bounds it on the H100: bytes. A row is 4 + 4F bytes read and F adds;
// at the atlas's 16 levels of 240000 rows (F = 2) that is 46 MB in and at
// most 22 MB of table out, about 20 us at 3.35 TB/s. Launches and the
// atomics' same-address serialisation in L2 are what the old form (three
// kernels a level, 48 an atlas step) paid for; the integer atomics' rate
// into L2 and the sweep of the int64 tables are what is left.
//
// Design: one cooperative launch (every block resident), grid-stride over
// work units of (level, chunk), three phases with grid-wide syncs
// (cooperative_groups) between them. The call's buffer (allocated by the
// caller for the call, any contents) holds each level's max|val| word at
// its head, then the levels' int64 tables; block 0 zeroes the max words
// before a first sync.
// 1. each level's max|val| over its finite kept rows: a warp reduction,
//    a shared atomicMax a warp, one global atomicMax on the float's bits a
//    block and level; and the int64 tables zeroed;
// 2. the scatter, one of two forms a level:
//    - global: each row's F integers added into the level's int64 table
//      with 64-bit atomics, resolved in L2;
//    - shared: for a small table that takes many rows an entry (levels 0-3
//      of the atlas: 289-1849 entries for 240000 rows), a unit of 8192 rows
//      is summed into a shared-memory int64 table with shared atomics, and
//      each non-zero entry is then added to the level's table with one
//      atomic;
// 3. a sweep of each level's table (16-byte loads, L2 only): where a word
//    is not 0, out += word * 2^-k.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr int kSharedMaxBytes = 48 * 1024;   // no opt-in needed below this
constexpr int kMaxBlocksPerSm = 4;
constexpr int kBatch = 8;                   // rows a thread loads at once
constexpr int kRowsPerUnit = kBatch * kThreads;   // phases 1, 2 (global)
constexpr int kRowsPerSharedUnit = 4 * kRowsPerUnit;   // phase 2, shared
constexpr int kWordsPerSweepUnit = 2 * kRowsPerUnit;   // phase 3
constexpr int kMaxGenericF = 8;             // F of the generic form
// u64 words at the head of the call's buffer: each level's max|val| bits
constexpr int kHeadWords = kMaxLevels / 2;

struct Levels {
  const int* idx;
  const float* val;
  float* out;
  u64* acc;            // the levels' tables
  unsigned int* level_max;   // the head of the call's buffer
  long long table;   // T: entries a level of out
  long long acc_words;   // all levels' tables, even
  int levels, rows, nf;
  unsigned int shared_mask;   // bit l: level l takes the shared form
  int used[kMaxLevels];
  long long acc_off[kMaxLevels];   // each level's table in acc, even
  // prefix sums of each phase's work units over the levels
  int units1[kMaxLevels + 1], units2[kMaxLevels + 1], units3[kMaxLevels + 1];
};

__device__ __forceinline__ int level_of(const int* units, int u) {
  int l = 0;
  while (units[l + 1] <= u) ++l;
  return l;
}

// the fixed-point exponent k of a level from max|val| (its float bits)
__device__ __forceinline__ int fixed_shift(unsigned int max_bits, int rows) {
  int e;
  frexpf(__uint_as_float(max_bits), &e);     // max|val| < 2^e
  const int rb = 32 - __clz(rows);            // rows < 2^rb
  return 62 - rb - e;
}

__device__ __forceinline__ u64 to_fixed(float v, int shift) {
  return (u64)__double2ll_rn(ldexp((double)v, shift));
}

__device__ __forceinline__ unsigned int level_max(const Levels& p, int l) {
  return __ldcg(p.level_max + l);
}

// a batch of kBatch rows a thread (rows r0 + j * kThreads + tid, all loads
// issued before any is used): their level-local indices (-1 past r1 or
// outside [0, used)) and F values. NF: F at compile time, 0 to read p.nf
template <int NF>
struct Batch {
  static constexpr int kF = NF > 0 ? NF : kMaxGenericF;
  int e[kBatch];
  float v[kBatch][kF];

  __device__ __forceinline__ void load(const Levels& p, const int* idx,
                                       const float* val, int r0, int r1,
                                       int used) {
    const int nf = NF > 0 ? NF : p.nf;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * kThreads + threadIdx.x;
      e[j] = r < r1 ? __ldg(idx + r) : -1;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * kThreads + threadIdx.x;
      if constexpr (NF == 2) {
        const float2 x = r < r1 ? __ldg(reinterpret_cast<const float2*>(
                                      val + (size_t)r * 2))
                                : make_float2(0.0f, 0.0f);
        v[j][0] = x.x;
        v[j][1] = x.y;
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f)
          v[j][f] = r < r1 && f < nf ? __ldg(val + (size_t)r * nf + f) : 0.0f;
      }
      if (e[j] >= used) e[j] = -1;
    }
  }
};

template <int NF>
__global__ void __launch_bounds__(kThreads)
hash_grad_levels_kernel(const Levels p) {
  extern __shared__ u64 table[];
  __shared__ unsigned int block_max[kMaxLevels];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nf = NF > 0 ? NF : p.nf;
  const size_t rows = (size_t)p.rows;
  cg::grid_group grid = cg::this_grid();
  Batch<NF> b;

  if (blockIdx.x == 0 && tid < kMaxLevels) p.level_max[tid] = 0u;
  grid.sync();

  // ---- phase 1: each level's max|val| over its finite kept values, and
  // the tables zeroed (an even number of words)
  for (long long w = 2 * ((long long)blockIdx.x * kThreads + tid);
       w < p.acc_words; w += 2LL * gridDim.x * kThreads)
    *reinterpret_cast<ulonglong2*>(p.acc + w) = make_ulonglong2(0ull, 0ull);
  if (tid < p.levels) block_max[tid] = 0u;
  __syncthreads();
  for (int u = blockIdx.x; u < p.units1[p.levels]; u += gridDim.x) {
    const int l = level_of(p.units1, u);
    const int r0 = (u - p.units1[l]) * kRowsPerUnit;
    b.load(p, p.idx + l * rows, p.val + l * rows * nf, r0,
           min(r0 + kRowsPerUnit, p.rows), p.used[l]);
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int f = 0; f < Batch<NF>::kF; ++f)
        if (b.e[j] >= 0 && (NF > 0 || f < nf) && isfinite(b.v[j][f]))
          m = fmaxf(m, fabsf(b.v[j][f]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // non-negative floats order as their bits do
    if (lane == 0 && m > 0.0f) atomicMax(block_max + l, __float_as_uint(m));
  }
  __syncthreads();
  if (tid < p.levels && block_max[tid] != 0u)
    atomicMax(p.level_max + tid, block_max[tid]);
  grid.sync();

  // ---- phase 2: the scatter into the int64 tables
  for (int u = blockIdx.x; u < p.units2[p.levels]; u += gridDim.x) {
    const int l = level_of(p.units2, u);
    const bool shared = (p.shared_mask >> l) & 1u;
    const int unit_rows = shared ? kRowsPerSharedUnit : kRowsPerUnit;
    const int r0 = (u - p.units2[l]) * unit_rows;
    const int r1 = min(r0 + unit_rows, p.rows);
    float* out = p.out + (size_t)l * p.table * nf;
    u64* acc = p.acc + p.acc_off[l];
    const int n = p.used[l] * nf;
    const int shift = fixed_shift(level_max(p, l), p.rows);
    if (shared) {
      for (int i = tid; i < n; i += kThreads) table[i] = 0ull;
      __syncthreads();
    }
    u64* sum = shared ? table : acc;
    for (int rb = r0; rb < r1; rb += kRowsPerUnit) {
      b.load(p, p.idx + l * rows, p.val + l * rows * nf, rb, r1, p.used[l]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (b.e[j] < 0) continue;
#pragma unroll
        for (int f = 0; f < Batch<NF>::kF; ++f) {
          if (NF == 0 && f >= nf) continue;
          const float v = b.v[j][f];
          const int i = b.e[j] * nf + f;
          if (isfinite(v))
            atomicAdd(sum + i, to_fixed(v, shift));
          else   // a value that is not finite goes straight to out
            atomicAdd(out + i, v);
        }
      }
    }
    if (shared) {
      __syncthreads();
      for (int i = tid; i < n; i += kThreads)
        if (table[i] != 0ull) atomicAdd(acc + i, table[i]);
      __syncthreads();   // before the next unit zeroes the table
    }
  }
  grid.sync();

  // ---- phase 3: scale the tables back into out
  for (int u = blockIdx.x; u < p.units3[p.levels]; u += gridDim.x) {
    const int l = level_of(p.units3, u);
    const int n = p.used[l] * nf;
    const int w0 = (u - p.units3[l]) * kWordsPerSweepUnit;
    const int w1 = min(w0 + kWordsPerSweepUnit, n);
    const u64* acc = p.acc + p.acc_off[l];
    float* out = p.out + (size_t)l * p.table * nf;
    const int shift = fixed_shift(level_max(p, l), p.rows);
    // pairs of words: acc_off is even and a level's odd last word is
    // followed by a padding word that stays 0
    ulonglong2 a[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int w = w0 + 2 * (j * kThreads + tid);
      a[j] = w < w1 ? __ldcg(reinterpret_cast<const ulonglong2*>(acc + w))
                    : make_ulonglong2(0ull, 0ull);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int w = w0 + 2 * (j * kThreads + tid);
      if (a[j].x != 0ull)
        out[w] += (float)ldexp((double)(long long)a[j].x, -shift);
      if (a[j].y != 0ull)
        out[w + 1] += (float)ldexp((double)(long long)a[j].y, -shift);
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// One launch for 1..32 levels of one backward. used: the host array of
// each level's entry count (<= table). buf: the call's buffer of
// vs_hash_table_grad_table_words u64 words (any contents, 16-byte
// aligned). mode: 0 picks each level's scatter (shared when the level's
// int64 table fits in 48 KB and takes at least 16 rows an entry), 1 forces
// the global form, 2 the shared one; every mode gives the same bits. F (nf)
// is at most 8.
extern "C" long long vs_hash_table_grad_table_words(const int* used,
                                                     int levels, int nf) {
  long long words = kHeadWords;
  for (int l = 0; l < levels; ++l) words += ((long long)used[l] * nf + 1) & ~1LL;
  return words;
}

extern "C" int vs_hash_table_grad_levels(const void* idx, const void* val,
                                         void* out, void* buf,
                                         const int* used, int levels,
                                         int rows, long long table, int nf,
                                         int mode, void* stream) {
  if (levels <= 0 || levels > kMaxLevels || rows <= 0 || nf <= 0 ||
      nf > kMaxGenericF || table <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Levels p{};
  p.idx = static_cast<const int*>(idx);
  p.val = static_cast<const float*>(val);
  p.out = static_cast<float*>(out);
  p.level_max = static_cast<unsigned int*>(buf);
  p.acc = static_cast<u64*>(buf) + kHeadWords;
  p.table = table;
  p.levels = levels;
  p.rows = rows;
  p.nf = nf;
  size_t smem = 0;
  long long off = 0;
  for (int l = 0; l < levels; ++l) {
    const long long n = (long long)used[l] * nf;
    if (used[l] <= 0 || used[l] > table || n > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)n * sizeof(u64);
    const bool fits = bytes <= (size_t)kSharedMaxBytes;
    const bool shared =
        mode == 2 || (mode == 0 && fits && (long long)rows >= 16LL * used[l]);
    if (shared && !fits) return (int)cudaErrorInvalidValue;
    if (shared) {
      p.shared_mask |= 1u << l;
      smem = bytes > smem ? bytes : smem;
    }
    p.used[l] = used[l];
    p.acc_off[l] = off;
    off += (n + 1) & ~1LL;
    p.acc_words = off;
    p.units1[l + 1] = p.units1[l] + ceil_div(rows, kRowsPerUnit);
    p.units2[l + 1] = p.units2[l] + ceil_div(rows, shared ? kRowsPerSharedUnit
                                                          : kRowsPerUnit);
    p.units3[l + 1] = p.units3[l] + ceil_div(n, kWordsPerSweepUnit);
  }
  const void* kernel = nf == 2 ? (const void*)hash_grad_levels_kernel<2>
                               : (const void*)hash_grad_levels_kernel<0>;
  int sms = 0, per_sm = 0;
  cudaError_t err = vs::resident_blocks(kernel, kThreads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  int blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  int most = p.units1[levels] > p.units2[levels] ? p.units1[levels]
                                                 : p.units2[levels];
  most = most > p.units3[levels] ? most : p.units3[levels];
  blocks = blocks < most ? blocks : most;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
