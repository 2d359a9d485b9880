// Fused GroupNorm affine -> SiLU -> 3x3 convolution for Hopper (sm_90a).
//
// Replaces: scripts/bench_resnet_fused.py, `fused_gn_silu_conv` / `_kernel`
// (the Pallas TPU kernel of the JAX package's fused-resnet experiment, never
// routed: XLA's convolution beat it at both U-Net levels on the TPU).
//
// x: (N, H, W, Cin) bf16 channels-last; scale, shift: (N, Cin) fp32, the
// GroupNorm statistics and affine folded per (image, channel) by the caller
// (per image, or one video's statistics repeated over its frames);
// w: (Cout, 3, 3, Cin) bf16 (OIHW carried to OHWI), bias: (Cout,) fp32;
// out: (N, H, W, Cout) bf16. Computes
//   a   = bf16(silu(x * scale + shift))     inside the image, 0 outside
//   out = bf16(bias + sum_{ky, kx, ci} a[y + ky - 1, x + kx - 1, ci] w[co, ky, kx, ci])
// i.e. a stride-1 convolution with zero padding 1 applied to the activation.
// The TPU kernel pads x with the value whose affine image is 0 instead,
// which breaks for a channel with scale 0; this one writes the out-of-image
// taps as 0 after the activation.
//
// What bounds it on the H100: an implicit GEMM of M = N*H*W pixels,
// N = Cout and K = 9*Cin, 2*M*Cout*9*Cin flops on about 2*M*(Cin + Cout)
// bytes: at the SD level-0 shape (32 x 64 x 64, 320 -> 320) some 1400
// flops a byte, so the tensor cores bound it (0.244 ms at 989 TFLOP/s),
// with the affine and SiLU of every staged input as the CUDA cores' and
// special-function units' share. Measured at the 700 W limit, the power
// draw sits at the limit: work taken off the activation path (fewer
// activations, fewer instructions each) shows as time.
//
// Design: a block of two warpgroups (256 threads, no producer warp, so
// ptxas may give 255 registers) owns 256 "virtual" output rows and 160
// output channels, each warpgroup 128 rows (two 64-row wgmma M groups, 160
// fp32 accumulators a thread).
// - Rows: an image is cut into column segments of tw <= 64 columns
//   (`plan`); in a segment, output pixel (y, x) is virtual row
//   v = y * pw + x with the pitch pw = tw + 2, so the two columns past each
//   row are rows that are computed and never stored. The input is staged
//   as the segment's zero-padded image flattened at the same pitch, halo
//   position q = y' * pw + x' holding pixel (y' - 1, x0 + x' - 1): tap
//   (dy, dx) of row v reads position v + dy * pw + dx, so each tap of an M
//   group is 64 consecutive positions, one shared-memory descriptor
//   whatever the image width (a tile of image rows would break that where
//   an M group spans two rows of a narrow image, as at W = 32).
// - Layout: eight planes of 8 channels, a position's 16 bytes at q * 16 in
//   each: wgmma's no-swizzle K-major layout, in which a one-row shift is a
//   16-byte move of the descriptor's start (Halo<160>::ss in
//   wgmma_bf16.cuh). Each plane of a 64-channel chunk is one TMA box of
//   8 channels x pw columns x image rows, which TMA writes in exactly this
//   order, zero-filled outside the image and past Cin.
// - Activation in place: after the box lands, the positions that are
//   pixels are activated where they lie (fp32 affine and SiLU, rounded to
//   bf16); the others stay 0, after the activation (silu(shift) is not 0).
//   SiLU takes one reciprocal for two values (silu_pair).
// - Clusters: where Cout has an even number of 160-channel blocks, the two
//   blocks of a pixel tile form a cluster and split the planes: each loads
//   and activates four and sends them to the other by a shared-memory bulk
//   copy (cp.async.bulk.shared::cluster), so that each input is activated
//   about 1.5 times at level 0 and 3 times at level 1 (the halo of 256
//   rows holds 390 and 326 positions), against 10 and 16 for the earlier
//   mma.sync kernel's 64-channel blocks. Clusters of four measured slower.
// - K loop: 64 input channels a chunk. Each chunk's nine taps' 160 x 64
//   weight tiles (the packed weight by a 3-D TMA map, 128-byte swizzle)
//   stream through a ring of kStages stages with full and empty mbarriers,
//   issued by one thread of warpgroup 1 (as csrc/geglu_ffn.cu streams its
//   weights). A tap is 8 SS wgmma (4 k16 steps x 2 M groups, N = 160); its
//   products stay in flight while the next tap's are issued, and are
//   waited for at the chunk's end (a group in flight across the loop's
//   back edge would serialise them). Under the chunk's products the next
//   chunk's boxes are requested (tap 0), activated (from tap kActFirst)
//   and sent. One block barrier a chunk orders the halo writes, the
//   products that read them and the buffer's next writes; across the
//   cluster, a block tells its peer that it is done reading a buffer by an
//   arrival on the peer's barrier (`hfree`), and the peer's sending thread
//   alone waits for it (a cluster barrier a chunk measured slower on the
//   H100).
// - Epilogue: bias added, rounded to bf16, staged in the halo buffers and
//   stored as 16-byte pieces of each pixel's channels (coalesced), rows
//   that are not pixels skipped. Both warpgroups issue their products even
//   where the second's rows all lie past the segment (the last tile at
//   level 1): a wgmma on a path ptxas cannot prove uniform is serialised
//   (C7518).

#include "attention_sm90.cuh"

namespace {

using namespace vs::sm90;

constexpr int kConvThreads = 256;  // two warpgroups
constexpr int kRowsBlock = 256;    // virtual output rows a block
constexpr int kNBlock = 160;       // output channels a block
constexpr int kKChunk = 64;        // input channels a K chunk: 128-byte rows
constexpr int kTwMax = 64;         // segment width at most
// halo positions a block reads: rows [v0, v0 + 256) and their taps
constexpr int kHaloMax = kRowsBlock + 2 * (kTwMax + 2) + 2;  // 390
// positions a plane: the input box's rows x pw (`box_rows`), at most 512
// for pw <= 66 (at pw = 64); 128-byte aligned, as TMA destinations must be
constexpr int kPlane = 512;
constexpr int kPlaneBytes = kPlane * 16;
constexpr int kHaloBytes = 8 * kPlaneBytes;
constexpr int kWBytes = kNBlock * 128;  // one tap's 160 x 64 weight tile
constexpr int kStages = 4;
// 16-byte halo items a thread (at most, with no cluster): of the 8/c
// planes its CTA activates (c the cluster size), warp w takes plane
// w % (8/c) and, of its positions, lane + 32 (w / (8/c) + c k)
constexpr int kItems = (kHaloMax + 31) / 32;
// the next chunk's items are activated under taps kActFirst..8, kSlice a
// tap, once its input boxes have landed
constexpr int kActFirst = 2;
constexpr int kSlice = (kItems + 8 - kActFirst) / (9 - kActFirst);
constexpr int kConvSmem =
    1024 + kStages * kWBytes + 2 * kHaloBytes + (2 * kStages + 6) * 8;
// the output tile staged for the stores: rows of 160 bf16 + 16 bytes, so
// that the accumulator fragments' rows (g = 0..7) fall on distinct banks;
// 240 threads copy it out, 12 rows at a time
constexpr int kOutPitch = kNBlock * 2 + 16;
constexpr int kOutThreads = (kConvThreads / (kNBlock / 8)) * (kNBlock / 8);
static_assert(kRowsBlock * (kOutPitch + 8) <= 2 * kHaloBytes, "out tile");
static_assert(kPlane % 8 == 0 && kPlane >= kHaloMax, "plane size");
static_assert(kSlice * (9 - kActFirst) >= kItems, "a chunk's halo in time");
static_assert(kConvSmem <= 232448, "shared memory");

// silu of two values y with one reciprocal: y / (1 + 2^z), z = -y log2 e,
// for both, 1 / (d0 d1) on the special-function unit, then d1 / (d0 d1)
// and d0 / (d0 d1): three special-function operations for two values, not
// four. The exponent is clamped to 63 so that d0 d1 stays finite; there
// silu(y) > -1e-17, and the quotient is 0.
__device__ __forceinline__ uint32_t silu_pair(float y0, float y1, float z0,
                                              float z1) {
  const float d0 = 1.0f + exp2_approx(fminf(z0, 63.0f));
  const float d1 = 1.0f + exp2_approx(fminf(z1, 63.0f));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d0 * d1));
  return pack_bf16(y0 * (d1 * r), y1 * (d0 * r));
}

// eight bf16 of x -> bf16(silu(x * sc + sh)), fp32 in between; ez, sz are
// -sc log2 e and -sh log2 e, so that the exponent is one FMA of x
__device__ __forceinline__ uint4 activate(uint4 raw, const float sc[8],
                                          const float sh[8], const float ez[8],
                                          const float sz[8]) {
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p;
    memcpy(&p, &w[j], 4);
    const float2 f = __bfloat1622float2(p);
    w[j] = silu_pair(f.x * sc[2 * j] + sh[2 * j],
                     f.y * sc[2 * j + 1] + sh[2 * j + 1],
                     f.x * ez[2 * j] + sz[2 * j],
                     f.y * ez[2 * j + 1] + sz[2 * j + 1]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one box of a 3-D tensor map -> shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// all threads of all CTAs of the cluster: earlier shared-memory writes
// (local and remote) and barrier initialisations visible to later reads
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// arrive on the barrier at `bar`'s offset in CTA `peer` of the cluster
__device__ __forceinline__ void arrive_at_peer(uint64_t* bar, uint32_t peer) {
  asm volatile(
      "{\n.reg .b32 b;\n"
      "mapa.shared::cluster.u32 b, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [b];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(peer)
      : "memory");
}
// `bytes` of this CTA's shared memory at `src` -> the same offset in CTA
// `peer` of the cluster, completion on that CTA's barrier at `bar`'s offset
__device__ __forceinline__ void copy_to_peer(const void* src, uint64_t* bar,
                                             uint32_t bytes, uint32_t peer) {
  asm volatile(
      "{\n.reg .b32 d, b;\n"
      "mapa.shared::cluster.u32 d, %0, %3;\n"
      "mapa.shared::cluster.u32 b, %1, %3;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [d], [%0], %2, [b];\n}\n" ::"r"(smem_u32(src)),
      "r"(smem_u32(bar)), "r"(bytes), "r"(peer)
      : "memory");
}

// k16 step KS of one tap: both M groups of the warpgroup (64 rows, 1024
// bytes of a plane apart), A's k16 step two planes on, B's 32 bytes on
template <int KS>
__device__ __forceinline__ void tap_step(float (&acc)[2][kNBlock / 2],
                                         uint32_t a, uint32_t b) {
  Halo<kNBlock>::template ss<KS * 2 * kPlaneBytes, KS * 32, kPlaneBytes>(
      acc[0], a, b);
  Halo<kNBlock>::template ss<KS * 2 * kPlaneBytes + 1024, KS * 32,
                             kPlaneBytes>(acc[1], a, b);
}

// The tiling of an h x w image: column segments of tw <= 64 columns (as
// even as they come), the pitch pw = tw + 2, and `tiles` blocks of 256
// virtual rows a segment. ops/gn_silu_conv.py `plan` computes the same.
struct Plan {
  int tw, pw, segments, tiles, rows;  // rows: the input box's image rows
};

__host__ __device__ inline Plan plan(int h, int w) {
  Plan p;
  p.segments = (w + kTwMax - 1) / kTwMax;
  p.tw = (w + p.segments - 1) / p.segments;
  p.pw = p.tw + 2;
  p.tiles = (int)(((long long)h * p.pw + kRowsBlock - 1) / kRowsBlock);
  // a block's halo positions [v0, v0 + 258 + 2 pw), counted from the
  // start of the padded row that holds v0 (at most pw - 1 before it): at
  // most kPlane positions
  p.rows = (kRowsBlock + 2 * p.pw + 2 + 2 * (p.pw - 1)) / p.pw;
  return p;
}

__global__ void __launch_bounds__(kConvThreads, 1)
gn_silu_conv_kernel(const __grid_constant__ CUtensorMap tx_map,
                    const __grid_constant__ CUtensorMap tw_map,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int height, int width, int cin, int cout, int tw, int pw,
                    int tiles, int rows, int csize) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle pattern repeats every 1024 bytes
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* w_s = base;                      // kStages weight tiles
  unsigned char* h_s = w_s + kStages * kWBytes;   // two halo buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + 2 * kHaloBytes);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;  // own planes' boxes, a halo buffer
  uint64_t* xpeer = xfull + 2;        // the peers' planes, a halo buffer
  uint64_t* hfree = xpeer + 2;  // the peers done reading it, a halo buffer

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the elected TMA thread is warpgroup 1's: a stage is refilled once
  // both warpgroups are done with it
  const bool producer = tid == 128;

  const int n0 = blockIdx.x * kNBlock;
  const int seg = blockIdx.y / tiles;
  const int v0 = (blockIdx.y - seg * tiles) * kRowsBlock;
  const int img = blockIdx.z;
  const int x0 = seg * tw;
  const int halo = kRowsBlock + 2 * pw + 2;
  const int chunks = (cin + kKChunk - 1) / kKChunk;
  const int tiles_w = 9 * chunks;
  // the input boxes start at the padded row that holds v0: halo position
  // p (virtual row v0 + p's tap (0, 0)) is box position off0 + p
  const int row0 = v0 / pw;
  const int off0 = v0 - row0 * pw;
  // the cluster: the csize blocks of this pixel tile's channel blocks
  // split the 8 planes, rank r activating planes r + csize i
  const int rank = (int)cluster_rank();
  const int nq = 8 / csize;
  const uint32_t xbytes = nq * rows * pw * 16;
  const uint32_t peer_bytes = (8 - nq) * halo * 16;

  // weight tile j: chunk j / 9, tap j % 9, this block's 160 channels
  // (channels past Cin and rows past Cout zero-filled)
  auto load_w = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(full + s, kWBytes);
    tma_load_3d(w_s + s * kWBytes, &tw_map, full + s, (j / 9) * kKChunk,
                j % 9, n0);
  };
  // chunk kc's input -> halo buffer buf: per 8-channel plane one box of
  // 8 channels x pw columns x rows image rows, from column x0 - 1 and
  // row row0 - 1, written densely (position r * pw + c at 16 bytes each);
  // pixels outside the image and channels past Cin read as 0
  auto load_x = [&](int kc, int buf) {
    mbar_expect_tx(xfull + buf, xbytes);
    for (int q = rank; q < 8; q += csize)
      tma_load_4d(h_s + buf * kHaloBytes + q * kPlaneBytes, &tx_map,
                  xfull + buf, kc * kKChunk + q * 8, x0 - 1, row0 - 1, img);
  };
  // this CTA's activated planes of buffer buf (the block's halo positions)
  // -> the same place in every peer, completion on the peer's xpeer[buf]
  auto send_planes = [&](int buf) {
    for (int q = rank; q < 8; q += csize)
      for (int d = 1; d < csize; ++d)
        copy_to_peer(h_s + buf * kHaloBytes + q * kPlaneBytes + off0 * 16,
                     xpeer + buf, halo * 16, (rank + d) % csize);
  };

  // ---- this thread's halo items (kItems above): bit k of `inside` says
  // the position is a pixel of the image (activated; the others stay
  // TMA's zeros, which must not be activated: silu(shift) is not 0)
  const int cg = rank + csize * ((tid >> 5) % nq);  // this thread's plane
  const int part = (tid >> 5) / nq;
  uint32_t inside = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = lane + 32 * (part + csize * k);
    const int q = off0 + p;
    const int r = q / pw;
    const int y = row0 + r - 1;
    const int xx = x0 + (q - r * pw) - 1;
    if (p < halo && y >= 0 && y < height && xx >= 0 && xx < width)
      inside |= 1u << k;
  }
  const float* scg = scale + (long long)img * cin + cg * 8;
  const float* shg = shift + (long long)img * cin + cg * 8;
  unsigned char* hst =
      h_s + cg * kPlaneBytes + (off0 + lane + 32 * part) * 16;
  const int item_stride = 512 * csize;
  // the tap whose products cover the sending of the next chunk's planes:
  // the one after the last activation slice (past 8: no peers)
  const int items = ((halo + 31) / 32 + csize - 1) / csize;
  const int send_tap =
      csize > 1 ? kActFirst + (items + kSlice - 1) / kSlice : 9;

  float sc[8], sh[8], ez[8], sz[8];
  auto load_affine = [&](int kc) {
    if (kc * kKChunk + cg * 8 < cin) {
#pragma unroll
      for (int j = 0; j < 8; j += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            scg + kc * kKChunk + j));
        const float4 b = __ldg(reinterpret_cast<const float4*>(
            shg + kc * kKChunk + j));
        sc[j] = a.x; sc[j + 1] = a.y; sc[j + 2] = a.z; sc[j + 3] = a.w;
        sh[j] = b.x; sh[j + 1] = b.y; sh[j + 2] = b.z; sh[j + 3] = b.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ez[j] = -sc[j] * kLog2e;
        sz[j] = -sh[j] * kLog2e;
      }
    }
  };
  // item k of chunk kc activated in place in buffer buf
  auto activate_item = [&](int k, int kc, int buf) {
    if (!((inside >> k) & 1) || kc * kKChunk + cg * 8 >= cin) return;
    uint4* p = reinterpret_cast<uint4*>(hst + buf * kHaloBytes +
                                        k * item_stride);
    *p = activate(*p, sc, sh, ez, sz);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(xfull + b, 1);
      mbar_init(xpeer + b, 1);
      mbar_init(hfree + b, csize > 1 ? csize - 1 : 1);
    }
    fence_barrier_init();
    // the peers' planes of chunks 0 and 1 are expected before any peer
    // can send them (after the cluster barrier below)
    if (csize > 1)
      for (int b = 0; b < 2 && b < chunks; ++b)
        mbar_expect_tx(xpeer + b, peer_bytes);
  }
  // no thread waits on a barrier, and no copy completes on one, before its
  // initialisation is visible to the cluster
  cluster_sync();
  if (producer) {
    load_x(0, 0);
    for (int j = 0; j < kStages && j < tiles_w; ++j) load_w(j);
  }
  __syncwarp();

  // ---- chunk 0's halo: this CTA's planes activated and sent, the
  // peers' received
  load_affine(0);
  mbar_wait(xfull, 0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) activate_item(k, 0, 0);
  fence_proxy_async();
  if (csize > 1) {
    named_sync(1, kConvThreads);
    if (tid == 0) send_planes(0);
    mbar_wait(xpeer, 0);
  }
  __syncthreads();

  float acc[2][kNBlock / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < kNBlock / 2; ++i) acc[m][i] = 0.0f;

  // the warpgroup's first virtual row in the halo buffer
  const uint32_t a_base = smem_u32(h_s) + (off0 + 128 * wg) * 16;
  const uint32_t w_base = smem_u32(w_s);
  // weight tile j's stage is free once all 8 warps are done with it; the
  // producer then refills it with tile j + kStages
  auto release = [&](int j) {
    const int s = j % kStages;
    if (lane == 0) mbar_arrive(empty + s);
    if (producer && j + kStages < tiles_w) {
      mbar_wait(empty + s, (j / kStages) & 1);
      load_w(j + kStages);
    }
    __syncwarp();
  };
  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc & 1;
    const bool more = kc + 1 < chunks;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int j = kc * 9 + tap;
      const int s = j % kStages;
      mbar_wait(full + s, (j / kStages) & 1);
      const uint32_t a = a_base + buf * kHaloBytes +
                         ((tap / 3) * pw + tap % 3) * 16;
      const uint32_t b = w_base + s * kWBytes;
      wgmma_fence();
      tap_step<0>(acc, a, b);
      tap_step<1>(acc, a, b);
      tap_step<2>(acc, a, b);
      tap_step<3>(acc, a, b);
      wgmma_commit();
      // the next chunk's input under this chunk's products: its boxes
      // requested under tap 0's (the buffer's last reader, chunk kc - 1,
      // is done), activated in place from tap kActFirst on
      if (more && tap == 0) {
        load_affine(kc + 1);
        if (producer) load_x(kc + 1, buf ^ 1);
        __syncwarp();
      }
      if (more && tap >= kActFirst) {
        if (tap == kActFirst) mbar_wait(xfull + (buf ^ 1), ((kc + 1) >> 1) & 1);
#pragma unroll
        for (int i = 0; i < kSlice; ++i)
          if ((tap - kActFirst) * kSlice + i < kItems)
            activate_item((tap - kActFirst) * kSlice + i, kc + 1, buf ^ 1);
      }
      if (more && tap == send_tap) {
        fence_proxy_async();
        named_sync(1, kConvThreads);
        if (tid == 0) {
          // the peers' last reads of that buffer (chunk kc - 1) are done
          if (kc > 0) mbar_wait(hfree + (buf ^ 1), ((kc - 1) >> 1) & 1);
          send_planes(buf ^ 1);
        }
      }
      // the previous tap's products done: its weight stage is free
      wgmma_wait<1>();
      if (tap > 0) release(j - 1);
    }
    wgmma_wait<0>();
    release(kc * 9 + 8);
    // the next chunk's halo written, this chunk's products done: buffer
    // buf may be written again, by the chunk after next; the peers, which
    // send into it, are told (after this CTA expects their planes)
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && csize > 1 && kc + 2 < chunks) {
      mbar_expect_tx(xpeer + buf, peer_bytes);
      for (int d = 1; d < csize; ++d)
        arrive_at_peer(hfree + buf, (rank + d) % csize);
    }
    if (more && csize > 1) mbar_wait(xpeer + (buf ^ 1), ((kc + 1) >> 1) & 1);
  }
  // no peer reads this CTA's shared memory (its sends) any more
  cluster_sync();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // ---- epilogue: + bias, rounded to bf16 and staged in the halo buffers
  // (free once the last chunk's products are done), rows kOutPitch bytes
  // apart; then each pixel's 160 channels stored as 16-byte pieces, 20
  // threads a row. Rows that are not pixels are not stored
  const long long img_pix = (long long)img * height * width;
  unsigned char* o_s = h_s;
  long long* row_off = reinterpret_cast<long long*>(o_s + kRowsBlock *
                                                    kOutPitch);
  {
    const int v = v0 + tid;
    const int y = v / pw;
    const int xv = v - y * pw;
    row_off[tid] = y < height && xv < tw && x0 + xv < width
                       ? (img_pix + (long long)y * width + x0 + xv) * cout
                       : -1;
  }
#pragma unroll
  for (int jj = 0; jj < kNBlock / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    const bool in = n0 + col < cout;
    const float b0 = in ? bias[n0 + col] : 0.0f;
    const float b1 = in ? bias[n0 + col + 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 128 * wg + 64 * m + warp * 16 + g + 8 * rr;
        *reinterpret_cast<uint32_t*>(o_s + row * kOutPitch + col * 2) =
            pack_bf16(acc[m][4 * jj + 2 * rr] + b0,
                      acc[m][4 * jj + 2 * rr + 1] + b1);
      }
  }
  __syncthreads();
  if (tid < kOutThreads) {
    const int piece = tid % (kNBlock / 8);
    const int col = n0 + piece * 8;
    if (col < cout)
      for (int row = tid / (kNBlock / 8); row < kRowsBlock;
           row += kOutThreads / (kNBlock / 8)) {
        const long long off = row_off[row];
        if (off >= 0)
          *reinterpret_cast<uint4*>(out + off + col) =
              *reinterpret_cast<const uint4*>(o_s + row * kOutPitch +
                                              piece * 16);
      }
  }
}

}  // namespace

// The kernel's tiling of an h x w image: out = {tw, pw, segments, tiles}.
extern "C" int vs_gn_silu_conv_plan(int h, int w, int* out) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(h, w);
  out[0] = p.tw;
  out[1] = p.pw;
  out[2] = p.segments;
  out[3] = p.tiles;
  return 0;
}

// Cin a multiple of 16, Cout a multiple of 8, every pointer 16-byte aligned;
// at most 65535 images and 65535 tiles an image (segments x tiles).
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_gn_silu_conv(const void* x, const void* scale,
                               const void* shift, const void* w,
                               const void* bias, void* out, int n, int height,
                               int width, int cin, int cout, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      cin % 16 != 0 || cout % 8 != 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(height, width);
  if ((long long)p.segments * p.tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  // x (N, H, W, Cin): boxes of 8 channels x pw columns x rows image rows,
  // no swizzle (the box is one plane of the halo), out-of-range zeros
  CUtensorMap x_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)width,
                                (cuuint64_t)height, (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin * 2,
                                   (cuuint64_t)cin * 2 * width,
                                   (cuuint64_t)cin * 2 * width * height};
  const cuuint32_t x_box[4] = {8, (cuuint32_t)p.pw, (cuuint32_t)p.rows, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), x_dims, x_strides, x_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the packed weight (Cout, 9, Cin): boxes of 64 channels x 1 tap x 160
  // output channels, 128-byte swizzle, out-of-range elements read as zero
  CUtensorMap w_map;
  const cuuint64_t w_dims[3] = {(cuuint64_t)cin, 9, (cuuint64_t)cout};
  const cuuint64_t w_strides[2] = {(cuuint64_t)cin * 2,
                                   (cuuint64_t)cin * 18};
  const cuuint32_t w_box[3] = {kKChunk, 1, kNBlock};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(w), w_dims, w_strides, w_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kConvSmem);
  if (err != cudaSuccess) return err;
  // clusters of two channel blocks of one pixel tile where their count is
  // even (clusters of 4 measured slower at Cout = 640 on the H100)
  const int nb = (cout + kNBlock - 1) / kNBlock;
  const int csize = nb % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, p.segments * p.tiles, n);
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = kConvSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_silu_conv_kernel, x_map, w_map,
                           static_cast<const float*>(scale),
                           static_cast<const float*>(shift),
                           static_cast<const float*>(bias),
                           static_cast<bf16*>(out), height, width, cin, cout,
                           p.tw, p.pw, p.tiles, p.rows, csize);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
