// Frame-axis (temporal) multi-head self-attention for Hopper (sm_90a).
//
// Replaces: videoswap_tpu/ops/temporal_attention.py:96, `_forward` /
// `_kernel` (the Pallas TPU kernel behind `temporal_attention`).
//
// q, k, v, out: (L*F, C) bf16, rows ordered (location, frame); each of the
// L locations attends over its own F <= 32 frames, per head (d = C / heads,
// a multiple of 8). Softmax is the usual max-subtracted one in fp32, which
// is what the JAX package's `_xla_reference` computes; the TPU kernel's
// max-free exp with logits clipped at 60 was a VPU trick and is not carried
// over.
//
// What bounds it on the H100: bytes. Each location does 4*F*F*C operations
// on 8*F*C bytes of q, k, v and out, F/2 = 8 operations a byte at F = 16,
// far below the card's balance point: at the swap's C = 1280 shapes (L =
// 512 and 128 locations) 84 and 21 MB a call, 25 and 6.3 us at 3.35 TB/s.
//
// Design: a persistent grid (one block an SM at the U-Net's shapes) walks
// work items of `lg` whole locations by `hc` heads (`plan_item`: about 32
// KB of q, k and v a location, lg = 2 at every U-Net width). The block is
// warp-specialised:
// - a producer warp copies each item's q, k and v into a ring of up to
//   three shared-memory stages with 1-D TMA bulk copies (`cp.async.bulk`,
//   one a row piece: a location's rows are contiguous, an item's columns
//   hc*d of them), completion on the stage's `full` mbarrier, and refills
//   a stage once every consumer warp has arrived on its `empty` mbarrier;
// - up to 16 consumer warps take the item's tasks, one (location, head,
//   16-query tile, column chunk of at most 64) a warp at a time, so that a
//   few heads of large d still spread over the warps. Shared rows are
//   padded to 16 bytes past a multiple of 128, so that ldmatrix reads them
//   without bank conflicts; rows F..15 (or F..31) of each location are
//   zeroed once and never written. A task:
//   - S = Q.K^T with mma.sync m16n8k16 (bf16 in, fp32 out), ldmatrix
//     straight from the bf16 rows, d/16 k-steps (a last half step
//     zero-padded where d % 16 == 8), keys past F masked;
//   - softmax in registers: row max and sum by quad shuffles, exp2 with
//     the scale folded in;
//   - O = P.V for its column chunk (32 accumulators a thread, whatever d
//     is), with P split into bf16 hi + lo parts (two products; P is kept to
//     about 2^-16, as an fp32 P would be to the bf16 output's rounding), V
//     through ldmatrix.trans;
//   - the bf16 output goes through the warp's own staging tile in shared
//     memory to out, by 16-byte stores.
// q, k and v are read once and out written once.

#include <math.h>

#include "attention_sm90.cuh"
#include "common.cuh"

namespace {

using vs::bf16;
namespace sm90 = vs::sm90;

constexpr int kMaxConsumers = 16;
constexpr int kMaxStages = 3;
constexpr int kBarBytes = 128;              // the stages' mbarriers
constexpr int kChunkCols = 64;              // output columns a task at most
constexpr int kStageRowElems = kChunkCols + 8;   // a staging row, padded
constexpr int kStagingElems = 16 * kStageRowElems;   // one warp's tile
constexpr long long kMaxSmem = 227 * 1024;
constexpr long long kItemBytes = 64 * 1024;   // an item's q, k, v at most

struct TaParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int locations, f, c, d;
  int hc, lg;          // heads and locations an item
  int chunks;          // heads / hc
  int items, stages, consumers;
  int dchunks, dw;     // column chunks a head and their width (<= 64)
  int row_elems;       // a shared row: roundup(hc*d, 64) + 8 bf16
  int tile_elems;      // one tensor's tile in a stage: lg * FP rows
  float scale_log2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

// `bytes` (a multiple of 16) from global to shared memory, completion on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// p0, p1 -> bf16 hi parts and the bf16 rounding of what they leave
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = vs::pack_bf16(__low2float(h), __high2float(h));
  lo = vs::pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// the producer warp: one item's row pieces into a stage, completion on bar
// (lane i copies frame i of each location and tensor)
template <int FP>
__device__ void issue_item(const TaParams& p, int item, bf16* stage,
                           uint64_t* bar, int lane) {
  const int group = item / p.chunks;
  const int chunk = item - group * p.chunks;
  const int loc0 = group * p.lg;
  const int nloc = min(p.lg, p.locations - loc0);
  const int cols = p.hc * p.d;
  const uint32_t row_bytes = (uint32_t)cols * 2u;
  if (lane == 0) sm90::mbar_expect_tx(bar, 3u * nloc * p.f * row_bytes);
  __syncwarp();
  if (lane >= p.f) return;
  for (int t = 0; t < 3; ++t) {
    const bf16* src = (t == 0 ? p.q : t == 1 ? p.k : p.v)
                      + ((size_t)loc0 * p.f + lane) * p.c + chunk * cols;
    bf16* dst = stage + t * p.tile_elems + lane * p.row_elems;
    for (int l = 0; l < nloc; ++l)
      bulk_load(dst + l * FP * p.row_elems, src + (size_t)l * p.f * p.c,
                row_bytes, bar);
  }
}

// one consumer warp, one task: query rows [16m, 16m + 16) of one
// (location, head), output columns [c0, c0 + w). q, k, v point at the
// head's first column of the location's rows in shared memory, gout at the
// location's first row of out, at the head's first column
template <int KT>
__device__ void attend(const TaParams& p, const bf16* q, const bf16* k,
                       const bf16* v, int m, int c0, int w, bf16* gout,
                       bf16* staging, int lane) {
  constexpr int NT = 2 * KT;   // n-tiles of 8 keys
  const int rs = p.row_elems;
  const int d = p.d;
  const int g = lane >> 2;
  const int t = lane & 3;

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const bf16* qa = q + (m * 16 + (lane & 15)) * rs + (lane >> 4) * 8;
  const bf16* kb = k + ((lane >> 4) * 8 + (lane & 7)) * rs
                   + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < d; kk += 16) {
    const bool half = kk + 16 > d;   // d % 16 == 8: columns kk+8.. are not
    uint32_t a[4];                   // this head's; zero them
    ldsm_x4(a, qa + kk);
    if (half) a[2] = a[3] = 0u;
#pragma unroll
    for (int np = 0; np < KT; ++np) {
      uint32_t b[4];
      ldsm_x4(b, kb + np * 16 * rs + kk);
      if (half) b[1] = b[3] = 0u;
      vs::mma_16816(s[2 * np], a, b);
      vs::mma_16816(s[2 * np + 1], a, b + 2);
    }
  }

  // softmax over keys < F, rows g and g + 8 of the tile
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n * 8 + 2 * t + (e & 1) >= p.f) s[n][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i] = sm90::quad_max(mx[i]) * p.scale_log2;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2f(fmaf(s[n][e], p.scale_log2, -mx[e >> 1]));
      s[n][e] = x;
      sum[e >> 1] += x;
    }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.0f / sm90::quad_sum(sum[i]);
  // P as A fragments of 16 keys, split into bf16 hi and lo parts
  uint32_t ph[KT][4], pl[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* c = s[2 * kk + (j >> 1)];
      const int r = j & 1;   // 0: row g, 1: row g + 8
      split_bf16(c[2 * r] * inv[r], c[2 * r + 1] * inv[r], ph[kk][j],
                 pl[kk][j]);
    }

  // O = P.V for columns [c0, c0 + w), into the warp's staging tile
  const bf16* vb = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * rs
                   + (lane >> 4) * 8 + c0;
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np * 16 >= w) continue;
    const bool second = np * 16 + 8 < w;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      ldsm_x4_trans(b, vb + kk * 16 * rs + np * 16);
      vs::mma_16816(o[2 * np], ph[kk], b);
      vs::mma_16816(o[2 * np], pl[kk], b);
      if (second) {
        vs::mma_16816(o[2 * np + 1], ph[kk], b + 2);
        vs::mma_16816(o[2 * np + 1], pl[kk], b + 2);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n * 8 >= w) continue;
    bf16* st = staging + g * kStageRowElems + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(st) = vs::pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(st + 8 * kStageRowElems) =
        vs::pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  // rows < F of the tile, w / 8 16-byte pieces a row: four rows a pass
  const int rows = min(16, p.f - m * 16);
  const int piece = lane & 7;
  bf16* go = gout + (size_t)(m * 16) * p.c + c0 + piece * 8;
#pragma unroll
  for (int r = lane >> 3; r < 16; r += 4)
    if (r < rows && piece * 8 < w)
      *reinterpret_cast<uint4*>(go + (size_t)r * p.c) =
          *reinterpret_cast<const uint4*>(staging + r * kStageRowElems
                                          + piece * 8);
  __syncwarp();   // the staging tile is free for the warp's next task
}

template <int KT>
__global__ void __launch_bounds__((kMaxConsumers + 1) * 32, 1)
temporal_attention_kernel(const TaParams p) {
  constexpr int FP = 16 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  bf16* tiles = reinterpret_cast<bf16*>(smem + kBarBytes);
  const int stage_elems = 3 * p.tile_elems;
  bf16* staging = tiles + p.stages * stage_elems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rs = p.row_elems;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, p.consumers);
    }
    sm90::fence_barrier_init();
  }
  // rows F..FP-1 of every location slot: zero once, never written (keys
  // there are masked, but P.V reads V's rows and 0 * garbage may be NaN)
  if (p.f < FP) {
    const int pad = FP - p.f;
    const int per_row = rs / 8;
    const int slots = p.stages * 3 * p.lg;
    for (int i = threadIdx.x; i < slots * pad * per_row; i += blockDim.x) {
      const int row = i / per_row;
      const int slot = row / pad;
      bf16* dst = tiles + (size_t)slot * FP * rs + (p.f + row - slot * pad) * rs
                  + (i - row * per_row) * 8;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int grid = gridDim.x;
  if (warp == p.consumers) {   // the producer
    for (int j = 0;; ++j) {
      const int item = blockIdx.x + j * grid;
      if (item >= p.items) break;
      const int s = j % p.stages;
      if (j >= p.stages)
        sm90::mbar_wait(empty + s, (uint32_t)(j / p.stages - 1) & 1u);
      issue_item<FP>(p, item, tiles + s * stage_elems, full + s, lane);
    }
    return;
  }
  bf16* my_staging = staging + warp * kStagingElems;
  const int per_loc = p.hc * KT * p.dchunks;   // tasks a location
  for (int j = 0;; ++j) {
    const int item = blockIdx.x + j * grid;
    if (item >= p.items) break;
    const int s = j % p.stages;
    sm90::mbar_wait(full + s, (uint32_t)(j / p.stages) & 1u);
    const bf16* sq = tiles + s * stage_elems;
    const bf16* sk = sq + p.tile_elems;
    const bf16* sv = sk + p.tile_elems;
    const int group = item / p.chunks;
    const int chunk = item - group * p.chunks;
    const int loc0 = group * p.lg;
    const int tasks = min(p.lg, p.locations - loc0) * per_loc;
    for (int task = warp; task < tasks; task += p.consumers) {
      const int l = task / per_loc;
      const int rest = task - l * per_loc;
      const int dc = rest % p.dchunks;
      const int m = (rest / p.dchunks) % KT;
      const int hh = rest / (p.dchunks * KT);
      const int off = l * FP * rs + hh * p.d;
      const int c0 = dc * p.dw;
      attend<KT>(p, sq + off, sk + off, sv + off, m, c0,
                 min(p.dw, p.d - c0),
                 p.out + (size_t)(loc0 + l) * p.f * p.c
                     + (chunk * p.hc + hh) * p.d,
                 my_staging, lane);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }
}

// A work item: hc, the most heads (a divisor of heads) whose q, k and v
// rows of one location take at most kItemBytes / 2 of shared memory (rows
// padded as the stages pad them, frames to 16 or 32), else 1; lg, as many
// whole locations as kItemBytes and kMaxConsumers tasks allow, at least 1.
void plan_item(int f, int d, int heads, int* hc, int* lg) {
  const int kt = f <= 16 ? 1 : 2;
  auto loc_bytes = [&](int h) {
    return 3LL * 16 * kt * ((h * d + 63) / 64 * 64 + 8) * 2;   // bf16
  };
  *hc = 1;
  for (int h = heads; h > 1; --h)
    if (heads % h == 0 && loc_bytes(h) <= kItemBytes / 2) {
      *hc = h;
      break;
    }
  long long g = kItemBytes / loc_bytes(*hc);
  const long long by_tasks = kMaxConsumers / (*hc * kt);
  g = g < by_tasks ? g : by_tasks;
  *lg = g > 1 ? (int)g : 1;
}

bool takes(int f, int c, int heads) {
  return f > 0 && f <= 32 && heads > 0 && c > 0 && c % heads == 0 &&
         (c / heads) % 8 == 0;
}

}  // namespace

// hc_lg[0], hc_lg[1]: the heads and whole locations of one work item at
// (f, c, heads), as vs_temporal_attention cuts the work. Returns a
// cudaError_t code.
extern "C" int vs_temporal_attention_plan(int f, int c, int heads,
                                          int* hc_lg) {
  if (!takes(f, c, heads)) return (int)cudaErrorInvalidValue;
  plan_item(f, c / heads, heads, hc_lg, hc_lg + 1);
  return 0;
}

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_temporal_attention(const void* q, const void* k,
                                     const void* v, void* out, int locations,
                                     int f, int c, int heads, void* stream) {
  if (locations <= 0 || !takes(f, c, heads))
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  int hc = 1, lg = 1;
  plan_item(f, d, heads, &hc, &lg);
  const int kt = f <= 16 ? 1 : 2;
  TaParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.locations = locations;
  p.f = f;
  p.c = c;
  p.d = d;
  p.hc = hc;
  p.lg = lg;
  p.chunks = heads / hc;
  const long long items =
      (long long)((locations + lg - 1) / lg) * p.chunks;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  // column chunks of at most 64, as even as multiples of 8 allow
  p.dchunks = (d + kChunkCols - 1) / kChunkCols;
  p.dw = ((d + p.dchunks - 1) / p.dchunks + 7) / 8 * 8;
  p.dchunks = (d + p.dw - 1) / p.dw;
  const int tasks = lg * hc * kt * p.dchunks;
  p.consumers = tasks < kMaxConsumers ? tasks : kMaxConsumers;
  p.row_elems = (hc * d + 63) / 64 * 64 + 8;
  const long long tile = (long long)lg * 16 * kt * p.row_elems;
  const long long stage_bytes = 3 * tile * (long long)sizeof(bf16);
  const long long fixed =
      kBarBytes + (long long)p.consumers * kStagingElems * sizeof(bf16);
  long long stages = (kMaxSmem - fixed) / stage_bytes;
  stages = stages > kMaxStages ? kMaxStages : stages;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  p.stages = (int)stages;
  p.tile_elems = (int)tile;
  p.scale_log2 = sm90::kLog2e / sqrtf((float)d);
  const size_t smem = (size_t)(fixed + stages * stage_bytes);
  const int threads = 32 * (p.consumers + 1);
  const void* kernel = kt == 1 ? (const void*)temporal_attention_kernel<1>
                               : (const void*)temporal_attention_kernel<2>;
  // the attribute once a device and form, at the most any plan takes
  static bool raised[64][2] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 64) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !raised[dev][kt - 1]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    raised[dev][kt - 1] = err == cudaSuccess;
  }
  if (err == cudaSuccess)
    err = vs::resident_blocks(kernel, threads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(items < most ? items : most);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt == 1)
    temporal_attention_kernel<1><<<grid, threads, smem, s>>>(p);
  else
    temporal_attention_kernel<2><<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}
