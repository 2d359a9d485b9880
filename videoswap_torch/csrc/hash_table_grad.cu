// Hash-grid table gradient (a scatter-add) for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/hash_table_grad.py, `hash_table_grad` / `_kernel`
// (the Pallas TPU kernel behind the atlas hash encoding's custom VJP).
//
// out[idx[r], :] += val[r, :] for every row r with 0 <= idx[r] < entries;
// other rows (the negative padding rows) are dropped. idx (R,) int32, val
// (R, F) fp32 row-major, out (T, F) fp32, accumulated into (the caller zeroes
// it). The TPU kernel phrases this as one-hot matrix products over a hi/lo
// split of the index with each fp32 value split into two bf16 halves: a
// workaround for the TPU's serial scatter. Here it is written as the scatter
// it is.
//
// What bounds it on the H100: bytes. A row is 4 + 4F bytes read and F adds;
// at the atlas's 240000 rows a level (F = 2) that is 2.9 MB in and at most
// 4.2 MB of table out, about 2 us at 3.35 TB/s, so launch latency and the
// atomics' same-address serialisation in L2 are what a call costs.
//
// Design: two kernels, picked per call.
// - global: one thread per row, one float2 vector atomic into the table when
//   F == 2 (sm_90 has `atomicAdd(float2*, float2)` for global memory), F
//   scalar atomics otherwise. The result is unused, so they compile to
//   fire-and-forget reductions resolved in L2.
// - shared: for a small table that takes many rows an entry (the atlas's
//   level 0 has 289 entries and receives 240000 rows, ~830 an address), each
//   block sums its grid-stride share of the rows into a shared-memory copy of
//   the table with shared atomics, then adds each non-zero entry to the table
//   in device memory with one atomic. Same-address contention in L2 drops from
//   R / T to the number of blocks.
// fp32 atomics commit in an order that changes from run to run, so the low
// bits of each sum do too; a sorted segmented reduction would be
// deterministic (later work).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxBytes = 48 * 1024;   // no opt-in needed below this
constexpr int kRowsPerSharedBlock = 4096;
constexpr int kMaxSharedBlocks = 264;        // two a streaming multiprocessor

__global__ void __launch_bounds__(kThreads)
hash_grad_global_kernel(const int* __restrict__ idx,
                        const float* __restrict__ val, float* __restrict__ out,
                        int rows, int entries, int nf) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int e = idx[r];
  if (e < 0 || e >= entries) return;
  if (nf == 2) {
    const float2 v = reinterpret_cast<const float2*>(val)[r];
    atomicAdd(reinterpret_cast<float2*>(out) + e, v);
  } else {
    for (int f = 0; f < nf; ++f)
      atomicAdd(out + (size_t)e * nf + f, val[(size_t)r * nf + f]);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_grad_shared_kernel(const int* __restrict__ idx,
                        const float* __restrict__ val, float* __restrict__ out,
                        int rows, int entries, int nf) {
  extern __shared__ float table[];
  const int n = entries * nf;
  for (int i = threadIdx.x; i < n; i += kThreads) table[i] = 0.0f;
  __syncthreads();
  const int stride = gridDim.x * kThreads;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < rows; r += stride) {
    const int e = idx[r];
    if (e < 0 || e >= entries) continue;
    for (int f = 0; f < nf; ++f)
      atomicAdd(table + e * nf + f, val[(size_t)r * nf + f]);
  }
  __syncthreads();
  if (nf == 2) {
    const float2* t2 = reinterpret_cast<const float2*>(table);
    for (int e = threadIdx.x; e < entries; e += kThreads) {
      const float2 v = t2[e];
      if (v.x != 0.0f || v.y != 0.0f)
        atomicAdd(reinterpret_cast<float2*>(out) + e, v);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      if (table[i] != 0.0f) atomicAdd(out + i, table[i]);
  }
}

}  // namespace

// mode: 0 picks the kernel (shared when the table fits in 48 KB and takes at
// least 256 rows an entry), 1 forces the global kernel, 2 the shared one.
// val and out must be 8-byte aligned when nf == 2.
extern "C" int vs_hash_table_grad(const void* idx, const void* val, void* out,
                                  int rows, int entries, int nf, int mode,
                                  void* stream) {
  if (rows <= 0 || entries <= 0 || nf <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)entries * nf * sizeof(float);
  const bool fits = smem <= (size_t)kSharedMaxBytes;
  const bool shared = mode == 2 || (mode == 0 && fits &&
                                    (long long)rows >= 256LL * entries);
  if (shared && !fits) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  if (shared) {
    int blocks = (rows + kRowsPerSharedBlock - 1) / kRowsPerSharedBlock;
    blocks = blocks < kMaxSharedBlocks ? blocks : kMaxSharedBlocks;
    hash_grad_shared_kernel<<<blocks, kThreads, smem, s>>>(i, v, o, rows,
                                                            entries, nf);
  } else {
    const int blocks = (rows + kThreads - 1) / kThreads;
    hash_grad_global_kernel<<<blocks, kThreads, 0, s>>>(i, v, o, rows,
                                                         entries, nf);
  }
  return (int)cudaGetLastError();
}
