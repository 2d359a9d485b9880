// Fused GroupNorm affine -> SiLU -> 3x3 convolution for Hopper (sm_90a).
//
// Replaces: scripts/bench_resnet_fused.py, `fused_gn_silu_conv` / `_kernel`
// (the Pallas TPU kernel of the JAX package's fused-resnet experiment, never
// routed: XLA's convolution beat it at both U-Net levels on the TPU).
//
// x: (N, H, W, Cin) bf16 channels-last; scale, shift: (N, Cin) fp32, the
// GroupNorm statistics and affine folded per (image, channel) by the caller
// (per image, or one video's statistics repeated over its frames);
// w: (9 * Cin, Cout) bf16, row (ky * 3 + kx) * Cin + ci; bias: (Cout,) fp32;
// out: (N, H, W, Cout) bf16. Computes
//   a   = bf16(silu(x * scale + shift))     inside the image, 0 outside
//   out = bf16(bias + sum_{ky, kx, ci} a[y + ky - 1, x + kx - 1, ci] w[.., co])
// i.e. a stride-1 convolution with zero padding 1 applied to the activation.
// The TPU kernel pads x with the value whose affine image is 0 instead,
// which breaks for a channel with scale 0; this one writes the out-of-image
// taps as 0 after the activation.
//
// What bounds it on the H100: an implicit GEMM of M = N*H*W pixels,
// N = Cout and K = 9*Cin, 2*M*Cout*9*Cin flops on about 2*M*(Cin + Cout)
// bytes: at the SD level-0 shape (32 x 64 x 64, 320 -> 320) some 1400
// flops a byte, so the tensor cores bound it (0.24 ms at 989 TFLOP/s),
// with the affine and SiLU of every staged input as the CUDA cores' share.
//
// Design: one block of 4 warps owns 128 output pixels, a th x tw patch of
// one image (tw = 64, 32, 16 or 8, th = 128 / tw), and 64 output channels;
// each warp a 64 x 32 tile of mma.sync (m16n8k16, bf16 -> fp32) with the
// accumulators in registers. The K loop walks the input channels 16 at a
// time. For each step the block stages the patch's (th + 2) x (tw + 2)
// halo of x for those channels in shared memory, activated: each thread
// loads 16 bytes of x into registers, applies the affine and SiLU in fp32,
// rounds to bf16 and stores; out-of-image halo pixels are stored as 0. The
// nine taps then read shifted windows of that one staged halo (ldmatrix row
// addresses offset by dy * (tw + 2) + dx), so each input is activated about
// twice a step, not nine times. The matching 9 x 16 rows of the weight come
// in with cp.async. Two stages: the next step's x loads and weight copies
// are in flight while the tensor cores work on the current one. The
// epilogue adds the bias and stores bf16 pairs.

#include "common.cuh"

namespace {

using vs::bf16;

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBC = 16;       // input channels per K step (one k16 a tap)
constexpr int kThreads = 128; // 4 warps: 2 along pixels x 2 along channels
constexpr int kLDA = kBC + 8; // 48-byte halo rows: ldmatrix conflict-free
constexpr int kLDB = kBN + 8; // 144-byte weight rows: the same
constexpr int kHaloMax = 264; // (th + 2) * (tw + 2) at tw = 64; less below
constexpr int kAIters = (2 * kHaloMax + kThreads - 1) / kThreads;
constexpr int kBRows = 9 * kBC;
constexpr int kAStage = kHaloMax * kLDA;  // elements
constexpr int kBStage = kBRows * kLDB;

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte global -> shared copy; zero-filled when !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// y * sigmoid(y) = y / (1 + exp(-y)) with the approximate exp and division
// (a few fp32 ulps; the result is rounded to bf16). Below y = -87 the
// denominator overflows and the quotient is 0, where silu(y) > -1e-35.
__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

// eight bf16 of x -> bf16(silu(x * sc + sh)), fp32 in between
__device__ __forceinline__ uint4 activate(uint4 raw, const float sc[8],
                                          const float sh[8]) {
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 p;
    memcpy(&p, &w[j], 4);
    const float2 f = __bfloat1622float2(p);
    w[j] = vs::pack_bf16(silu(f.x * sc[2 * j] + sh[2 * j]),
                         silu(f.y * sc[2 * j + 1] + sh[2 * j + 1]));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kThreads, 3)
gn_silu_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const bf16* __restrict__ wt, const float* __restrict__ bias,
                    bf16* __restrict__ out, int height, int width, int cin,
                    int cout, int tw, int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // 2 stages of the halo
  bf16* b_s = a_s + 2 * kAStage;                   // 2 stages of weights

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp_m = warp >> 1;  // pixels [64 warp_m, +64)
  const int warp_n = warp & 1;   // channels [n0 + 32 warp_n, +32)

  const int th = kBM / tw;
  const int hw = tw + 2;             // halo width
  const int halo = (th + 2) * hw;    // halo pixels
  const int n0 = blockIdx.x * kBN;
  int tile = blockIdx.y;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int y0 = ty * th;
  const int x0 = tx * tw;

  // ---- this thread's halo pixels: the global offset of each (its 8
  // channels at K step 0), -1 outside the image (stored as 0), -2 past the
  // halo (nothing stored); the thread's channel half is tid & 1 throughout
  const int half = tid & 1;
  long long goff[kAIters];
#pragma unroll
  for (int it = 0; it < kAIters; ++it) {
    const int idx = it * kThreads + tid;
    goff[it] = -2;
    if (idx < 2 * halo) {
      const int pix = idx >> 1;
      const int hy = pix / hw;
      const int gy = y0 + hy - 1;
      const int gx = x0 + (pix - hy * hw) - 1;
      goff[it] = (gy >= 0 && gy < height && gx >= 0 && gx < width)
                     ? (((long long)img * height + gy) * width + gx) * cin +
                           half * 8
                     : -1;
    }
  }
  const float* sc_row = scale + (long long)img * cin + half * 8;
  const float* sh_row = shift + (long long)img * cin + half * 8;

  // ---- ldmatrix row of this lane in each of its warp's 4 m16 tiles: the
  // halo row of its pixel at tap (0, 0)
  int hrow[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int i = warp_m * 64 + mt * 16 + (lane & 15);
    const int py = i / tw;
    hrow[mt] = py * hw + (i - py * tw);
  }
  const int acol = (lane >> 4) * 8;

  uint4 xr[kAIters];
  float sc[8], sh[8];

  auto load_x = [&](int c0) {
#pragma unroll
    for (int it = 0; it < kAIters; ++it)
      xr[it] = goff[it] >= 0
                   ? __ldg(reinterpret_cast<const uint4*>(x + goff[it] + c0))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(sc_row + c0 + j));
      const float4 b = __ldg(reinterpret_cast<const float4*>(sh_row + c0 + j));
      sc[j] = a.x; sc[j + 1] = a.y; sc[j + 2] = a.z; sc[j + 3] = a.w;
      sh[j] = b.x; sh[j + 1] = b.y; sh[j + 2] = b.z; sh[j + 3] = b.w;
    }
  };
  auto store_a = [&](bf16* dst) {
#pragma unroll
    for (int it = 0; it < kAIters; ++it) {
      if (goff[it] == -2) continue;
      const int pix = (it * kThreads + tid) >> 1;
      const uint4 val = goff[it] >= 0 ? activate(xr[it], sc, sh)
                                      : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dst + pix * kLDA + half * 8) = val;
    }
  };
  auto load_b = [&](bf16* dst, int c0) {
    for (int i = tid; i < kBRows * (kBN / 8); i += kThreads) {
      const int r = i >> 3;
      const int col = (i & 7) * 8;
      const int tap = r / kBC;
      const bool ok = n0 + col < cout;
      const bf16* src =
          ok ? wt + ((long long)tap * cin + c0 + (r - tap * kBC)) * cout + n0 + col
             : wt;
      cp_async16(dst + r * kLDB + col, src, ok);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int steps = cin / kBC;
  load_b(b_s, 0);
  load_x(0);
  store_a(a_s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // this step's stage complete; the other one free
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) {
      load_b(b_s + (cur ^ 1) * kBStage, (step + 1) * kBC);
      load_x((step + 1) * kBC);
    }
    const bf16* as = a_s + cur * kAStage;
    const bf16* bs = b_s + cur * kBStage;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int off = dy * hw + (tap - dy * 3);
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], as + (hrow[mt] + off) * kLDA + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (tap * kBC + (lane & 15)) * kLDB +
                                 warp_n * 32 + np * 16 + acol);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) vs::mma_16816(acc[mt][nt], a[mt], b[nt]);
    }
    if (more) store_a(a_s + (cur ^ 1) * kAStage);
  }

  // ---- epilogue: + bias, bf16 pairs to the pixels inside the image
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int co = n0 + warp_n * 32 + nt * 8 + 2 * t;
    if (co >= cout) continue;
    const float b0 = bias[co];
    const float b1 = bias[co + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = warp_m * 64 + mt * 16 + g + hh * 8;
        const int py = i / tw;
        const int y = y0 + py;
        const int xx = x0 + (i - py * tw);
        if (y < height && xx < width)
          *reinterpret_cast<uint32_t*>(
              out + (((long long)img * height + y) * width + xx) * cout + co) =
              vs::pack_bf16(acc[mt][nt][2 * hh] + b0,
                            acc[mt][nt][2 * hh + 1] + b1);
      }
  }
}

}  // namespace

// Cin a multiple of 16, Cout a multiple of 8, every pointer 16-byte aligned.
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int vs_gn_silu_conv(const void* x, const void* scale,
                               const void* shift, const void* w,
                               const void* bias, void* out, int n, int height,
                               int width, int cin, int cout, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      cin % kBC != 0 || cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  int tw = 64;
  while (tw > 8 && tw > width) tw >>= 1;
  const int th = kBM / tw;
  const int tiles_x = (width + tw - 1) / tw;
  const int tiles_y = (height + th - 1) / th;
  const long long tiles = (long long)n * tiles_x * tiles_y;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (kAStage + kBStage) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((cout + kBN - 1) / kBN, (unsigned)tiles);
  gn_silu_conv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), height, width,
      cin, cout, tw, tiles_x, tiles_y);
  return cudaGetLastError();
}
