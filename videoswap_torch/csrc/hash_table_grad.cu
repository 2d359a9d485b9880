// Hash-grid table gradient (a scatter-add) for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/hash_table_grad.py:125, `hash_table_grad` /
// `_kernel` (the Pallas TPU kernel behind the atlas hash encoding's custom
// VJP).
//
// out[idx[r], :] += val[r, :] for every row r with 0 <= idx[r] < entries;
// other rows (the negative padding rows) are dropped. idx (R,) int32, val
// (R, F) fp32 row-major, out (T, F) fp32, accumulated into. The TPU kernel
// phrases this as one-hot matrix products over a hi/lo split of the index
// with each fp32 value split into two bf16 halves: a workaround for the
// TPU's serial scatter, which gives one answer. Here it is written as the
// scatter it is, in fixed point, so that it gives one answer too.
//
// Deterministic: each finite value is rounded once to a 64-bit integer at
// one scale a call, 2^k with max|val| * 2^Rb * 2^k <= 2^62 (max|val| over
// the finite kept values, R < 2^Rb), and the integers are summed with
// integer atomics, whose sum does not depend on the order they commit in.
// The table is then scaled back and added to out in fp32. Each term is off
// by at most half a unit, 2^-k; a sum of R terms by at most R/2 units,
// below max|val| * 2^(2*Rb - 62) (1.5e-8 of max|val| at 240000 rows), and
// the sum of |terms| stays below 2^63. A value that is not finite (a
// diverging step) is added to out in fp32 instead, as the plain version
// adds it: sums of infinities and NaNs do not depend on order either, and
// the entry comes out NaN or infinite as index_add_ leaves it.
//
// What bounds it on the H100: bytes. A row is 4 + 4F bytes read and F adds;
// at the atlas's 240000 rows a level (F = 2) that is 2.9 MB in and at most
// 4.2 MB of table out, about 2 us at 3.35 TB/s, so launch latency (three
// kernels: max|val|, the scatter, the scale back) and the atomics'
// same-address serialisation in L2 are what a call costs.
//
// Design: the scale pass reduces max|val| over the finite kept rows (a
// block reduction by shuffles, one atomicMax on the float's bits a block)
// into this call's 32-bit half of the scratch's first word, and zeroes the
// other half for the next call; the scatter is one of two forms, picked per
// call:
// - global: one thread per row, F 64-bit integer atomics into the scratch
//   table, resolved in L2;
// - shared: for a small table that takes many rows an entry (the atlas's
//   level 0 has 289 entries and receives 240000 rows, ~830 an address), each
//   block sums its grid-stride share of the rows into a shared-memory int64
//   table with shared atomics, then adds each non-zero entry to the scratch
//   table with one atomic;
// and the last pass adds scratch * 2^-k to out where the scratch is not 0
// and sets that word back to 0, so the scratch is zero again after a call
// and persists between calls with no memset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kSharedMaxBytes = 48 * 1024;   // no opt-in needed below this
constexpr int kRowsPerSharedBlock = 4096;
constexpr int kMaxSharedBlocks = 264;        // two a streaming multiprocessor
constexpr int kMaxScaleBlocks = 528;         // four a streaming multiprocessor

__device__ __forceinline__ bool kept(int e, int entries) {
  return e >= 0 && e < entries;
}

// the fixed-point exponent k of this call from max|val| (its float bits)
__device__ __forceinline__ int fixed_shift(unsigned int max_bits, int rows) {
  int e;
  frexpf(__uint_as_float(max_bits), &e);     // max|val| < 2^e
  const int rb = 32 - __clz(rows);            // rows < 2^rb
  return 62 - rb - e;
}

__device__ __forceinline__ u64 to_fixed(float v, int shift) {
  return (u64)__double2ll_rn(ldexp((double)v, shift));
}

__global__ void __launch_bounds__(kThreads)
hash_grad_absmax_kernel(const int* __restrict__ idx,
                        const float* __restrict__ val,
                        unsigned int* __restrict__ max_bits,
                        unsigned int* __restrict__ next_max_bits, int rows,
                        int entries, int nf) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_max_bits = 0u;
  float m = 0.0f;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < rows;
       r += gridDim.x * kThreads)
    if (kept(idx[r], entries))
      for (int f = 0; f < nf; ++f) {
        const float v = val[(size_t)r * nf + f];
        if (isfinite(v)) m = fmaxf(m, fabsf(v));
      }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    // non-negative floats order as their bits do
    atomicMax(max_bits, __float_as_uint(m));
  }
}

__global__ void __launch_bounds__(kThreads)
hash_grad_global_kernel(const int* __restrict__ idx,
                        const float* __restrict__ val, u64* __restrict__ acc,
                        float* __restrict__ out,
                        const unsigned int* __restrict__ max_bits, int rows,
                        int entries, int nf) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int e = idx[r];
  if (!kept(e, entries)) return;
  const int shift = fixed_shift(*max_bits, rows);
  for (int f = 0; f < nf; ++f) {
    const size_t i = (size_t)e * nf + f;
    const float v = val[(size_t)r * nf + f];
    if (isfinite(v))   // a value that is not finite goes straight to out
      atomicAdd(acc + i, to_fixed(v, shift));
    else
      atomicAdd(out + i, v);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_grad_shared_kernel(const int* __restrict__ idx,
                        const float* __restrict__ val, u64* __restrict__ acc,
                        float* __restrict__ out,
                        const unsigned int* __restrict__ max_bits, int rows,
                        int entries, int nf) {
  extern __shared__ u64 table[];
  const int n = entries * nf;
  for (int i = threadIdx.x; i < n; i += kThreads) table[i] = 0ull;
  __syncthreads();
  const int shift = fixed_shift(*max_bits, rows);
  const int stride = gridDim.x * kThreads;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < rows; r += stride) {
    const int e = idx[r];
    if (!kept(e, entries)) continue;
    for (int f = 0; f < nf; ++f) {
      const float v = val[(size_t)r * nf + f];
      if (isfinite(v))
        atomicAdd(table + e * nf + f, to_fixed(v, shift));
      else
        atomicAdd(out + (size_t)e * nf + f, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (table[i] != 0ull) atomicAdd(acc + i, table[i]);
}

__global__ void __launch_bounds__(kThreads)
hash_grad_finish_kernel(u64* __restrict__ acc,
                        const unsigned int* __restrict__ max_bits,
                        float* __restrict__ out, int rows, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const u64 a = acc[i];
  if (a == 0ull) return;
  acc[i] = 0ull;
  const int shift = fixed_shift(*max_bits, rows);
  out[i] += (float)ldexp((double)(long long)a, -shift);
}

}  // namespace

// scratch: an int64 buffer of 1 + entries * nf words, zero when first
// given and left zero by every call (its first word holds the max|val| of
// two calls in turn: `phase`, 0 or 1, is this call's half, and the caller
// flips it after each call; then the fixed-point table). mode: 0 picks the scatter (shared when
// the int64 table fits in 48 KB and takes at least 256 rows an entry), 1
// forces the global form, 2 the shared one; every mode gives the same bits.
extern "C" int vs_hash_table_grad(const void* idx, const void* val, void* out,
                                  void* scratch, int phase, int rows,
                                  int entries, int nf, int mode,
                                  void* stream) {
  if (rows <= 0 || entries <= 0 || nf <= 0 || mode < 0 || mode > 2 ||
      (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)entries * nf;
  const size_t smem = n * sizeof(u64);
  const bool fits = smem <= (size_t)kSharedMaxBytes;
  const bool shared = mode == 2 || (mode == 0 && fits &&
                                    (long long)rows >= 256LL * entries);
  if (shared && !fits) return (int)cudaErrorInvalidValue;
  if (n > (size_t)0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  auto* max_bits = static_cast<unsigned int*>(scratch) + phase;
  auto* next_max_bits = static_cast<unsigned int*>(scratch) + (1 - phase);
  u64* acc = static_cast<u64*>(scratch) + 1;
  const int row_blocks = (rows + kThreads - 1) / kThreads;
  hash_grad_absmax_kernel<<<row_blocks < kMaxScaleBlocks ? row_blocks
                                                         : kMaxScaleBlocks,
                            kThreads, 0, s>>>(i, v, max_bits, next_max_bits,
                                              rows, entries, nf);
  if (shared) {
    int blocks = (rows + kRowsPerSharedBlock - 1) / kRowsPerSharedBlock;
    blocks = blocks < kMaxSharedBlocks ? blocks : kMaxSharedBlocks;
    hash_grad_shared_kernel<<<blocks, kThreads, smem, s>>>(
        i, v, acc, o, max_bits, rows, entries, nf);
  } else {
    hash_grad_global_kernel<<<row_blocks, kThreads, 0, s>>>(
        i, v, acc, o, max_bits, rows, entries, nf);
  }
  hash_grad_finish_kernel<<<(int)((n + kThreads - 1) / kThreads), kThreads, 0,
                            s>>>(acc, max_bits, o, rows, (int)n);
  return (int)cudaGetLastError();
}
