// Hopper warpgroup matrix products (wgmma, sm_90a), bf16 x bf16 -> fp32.
//
// wgmma_ss<N>: D(64 x N) (+)= A(64 x 16) B(16 x N), both operands read from
//   shared memory through descriptors, both K-major (A row-major, B stored
//   N rows of K). Used for S = Q.K^T, the backward's S and dP, and the
//   GEGLU feed-forward's and the fused temporal transformer's products.
// wgmma_rs<N>: the same with A taken from registers (four 32-bit registers a
//   thread, the mma.m16n8k16 A-fragment layout for the warp's 16 rows) and
//   B MN-major (stored K rows of N, the "transposed" flag set). Used for
//   O += P.V with P converted in registers from the S accumulator.
// wgmma_rs_k<N>: the register form with B K-major (stored N rows of K, as
//   wgmma_ss's B). Used for the GEGLU feed-forward's out += G.W2^T (in
//   csrc/geglu_ffn.cu and the fused temporal transformer's FFN tail), where
//   W2's rows are the output columns.
//
// scale_d = 0 overwrites D, 1 accumulates into it. Each accumulator register
// is its own asm operand, so every width N has its own wrapper, one line
// below each: N/2 fp32 registers a thread, laid out as the mma.m16n8k16 C
// fragment of each n8 column block (d[4j..4j+1] row g, d[4j+2..4j+3] row
// g + 8, columns 8j + 2t, 8j + 2t + 1 of the warp's 16 rows; g = lane / 4,
// t = lane % 4). The products are asynchronous: issue between wgmma_fence()
// and wgmma_commit(), and read D (or change rs's A registers) only after
// wgmma_wait<>() (attention_sm90.cuh).
//
// Operands: six come first (rs: the four A registers, the B descriptor and
// scale_d; ss: the two descriptors, scale_d and three unused words), so that
// the accumulators are %6 upward at every width and in both forms:
// VS_ACC<R>(M, M_) lists the operand numbers of R accumulators four at a
// time, M for the first four and M_ for each next four. Every operand is
// read-write ("+"), so rs's A operands are P's own registers, which the
// product reads after it is issued.
#pragma once

#include <stdint.h>

namespace vs {
namespace sm90 {

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, uint32_t* a, uint64_t db,
                                         int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float* d, uint32_t* a, uint64_t db,
                                           int scale_d);

// four accumulators: their numbers in the asm text, their operands
#define VS_S4(a, b, c, e) "%" #a ", %" #b ", %" #c ", %" #e
#define VS_S4_(a, b, c, e) ", " VS_S4(a, b, c, e)
#define VS_F4_(a, b, c, e) \
  , "+f"(d[a - 6]), "+f"(d[b - 6]), "+f"(d[c - 6]), "+f"(d[e - 6])

#define VS_ACC4(M, M_) M(6, 7, 8, 9)
#define VS_ACC8(M, M_) VS_ACC4(M, M_) M_(10, 11, 12, 13)
#define VS_ACC12(M, M_) VS_ACC8(M, M_) M_(14, 15, 16, 17)
#define VS_ACC16(M, M_) VS_ACC12(M, M_) M_(18, 19, 20, 21)
#define VS_ACC20(M, M_) VS_ACC16(M, M_) M_(22, 23, 24, 25)
#define VS_ACC24(M, M_) VS_ACC20(M, M_) M_(26, 27, 28, 29)
#define VS_ACC28(M, M_) VS_ACC24(M, M_) M_(30, 31, 32, 33)
#define VS_ACC32(M, M_) VS_ACC28(M, M_) M_(34, 35, 36, 37)
#define VS_ACC36(M, M_) VS_ACC32(M, M_) M_(38, 39, 40, 41)
#define VS_ACC40(M, M_) VS_ACC36(M, M_) M_(42, 43, 44, 45)
#define VS_ACC44(M, M_) VS_ACC40(M, M_) M_(46, 47, 48, 49)
#define VS_ACC48(M, M_) VS_ACC44(M, M_) M_(50, 51, 52, 53)
#define VS_ACC52(M, M_) VS_ACC48(M, M_) M_(54, 55, 56, 57)
#define VS_ACC56(M, M_) VS_ACC52(M, M_) M_(58, 59, 60, 61)
#define VS_ACC60(M, M_) VS_ACC56(M, M_) M_(62, 63, 64, 65)
#define VS_ACC64(M, M_) VS_ACC60(M, M_) M_(66, 67, 68, 69)
#define VS_ACC68(M, M_) VS_ACC64(M, M_) M_(70, 71, 72, 73)
#define VS_ACC72(M, M_) VS_ACC68(M, M_) M_(74, 75, 76, 77)
#define VS_ACC76(M, M_) VS_ACC72(M, M_) M_(78, 79, 80, 81)
#define VS_ACC80(M, M_) VS_ACC76(M, M_) M_(82, 83, 84, 85)

#define VS_WGMMA_SS(N, R)                                                     \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_ss<N>(float* d, uint64_t da,          \
                                              uint64_t db, int scale_d) {     \
    uint32_t unused0 = 0, unused1 = 0, unused2 = 0;                           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                 \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 VS_ACC##R(VS_S4, VS_S4_) "}, %0, %1, p, 1, 1, 0, 0;\n}\n"   \
                 : "+l"(da), "+l"(db), "+r"(scale_d), "+r"(unused0),          \
                   "+r"(unused1),                                             \
                   "+r"(unused2) VS_ACC##R(VS_F4_, VS_F4_));                  \
  }

// FN: wgmma_rs (B MN-major, the transpose flag set) or wgmma_rs_k (B
// K-major, stored N rows of K)
#define VS_WGMMA_RS_(FN, TNSP_B, N, R)                                        \
  template <>                                                                 \
  __device__ __forceinline__ void FN<N>(float* d, uint32_t* a, uint64_t db,   \
                                        int scale_d) {                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                 \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 VS_ACC##R(VS_S4, VS_S4_) "}, {%0, %1, %2, %3}, %4, p, 1, 1, " \
                 TNSP_B ";\n}\n"                                              \
                 : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(db),  \
                   "+r"(scale_d) VS_ACC##R(VS_F4_, VS_F4_));                  \
  }
#define VS_WGMMA_RS(N, R) VS_WGMMA_RS_(wgmma_rs, "1", N, R)
#define VS_WGMMA_RS_K(N, R) VS_WGMMA_RS_(wgmma_rs_k, "0", N, R)

// The same products with the 64-byte-swizzle descriptors (`desc_sw64`,
// rows of 64 bytes, 8-row groups 512 bytes apart) built inside the asm from
// a shared address and an immediate offset: Sw64<N>::ss<OA, OB>(d, a, b)
// takes A at a + OA and B at b + OB, Sw64<N>::rs_k<OB>(d, a_regs, b) B at
// b + OB. A caller that issues many products from one base then holds one
// register, not a 64-bit descriptor for each product, which ptxas would
// otherwise compute ahead of the first issue (the fused temporal kernel at
// C = 320 spills beside its 160 accumulators without this). The immediates
// are operands IA and IB, after the accumulators.
template <int N>
struct Sw64;

#define VS_SW64_DESC(REG, BASE, OFF)                                  \
  "add.u32 " REG ", " BASE ", " OFF ";\n"                             \
  "and.b32 " REG ", " REG ", 0x3FFFF;\n"                              \
  "shr.u32 " REG ", " REG ", 4;\n"                                    \
  "or.b32 " REG ", " REG ", 0x10000;\n"

#define VS_WGMMA_SW64(N, R, IA, IB)                                            \
  template <>                                                                  \
  struct Sw64<N> {                                                             \
    template <int OA, int OB>                                                  \
    __device__ __forceinline__ static void ss(float* d, uint32_t a,            \
                                              uint32_t b) {                    \
      uint32_t scale_d = 1, unused0 = 0, unused1 = 0, unused2 = 0;             \
      asm volatile("{\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"          \
                   ".reg .pred p;\n" VS_SW64_DESC("la", "%0", "%" #IA)        \
                   VS_SW64_DESC("lb", "%1", "%" #IB)                           \
                   "mov.b32 hi, 0x80000020;\nmov.b64 da, {la, hi};\n"         \
                   "mov.b64 db, {lb, hi};\nsetp.ne.b32 p, %2, 0;\n"           \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                   VS_ACC##R(VS_S4, VS_S4_) "}, da, db, p, 1, 1, 0, 0;\n}\n"   \
                   : "+r"(a), "+r"(b), "+r"(scale_d), "+r"(unused0),           \
                     "+r"(unused1), "+r"(unused2) VS_ACC##R(VS_F4_, VS_F4_)     \
                   : "n"(OA), "n"(OB));                                        \
    }                                                                          \
    template <int OB>                                                          \
    __device__ __forceinline__ static void rs_k(float* d, uint32_t* a,         \
                                                uint32_t b) {                  \
      uint32_t scale_d = 1;                                                    \
      asm volatile("{\n.reg .b32 lb, hi;\n.reg .b64 db;\n.reg .pred p;\n"   \
                   VS_SW64_DESC("lb", "%4", "%" #IA)                           \
                   "mov.b32 hi, 0x80000020;\nmov.b64 db, {lb, hi};\n"         \
                   "setp.ne.b32 p, %5, 0;\n"                                   \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                   VS_ACC##R(VS_S4, VS_S4_) "}, {%0, %1, %2, %3}, db, p, 1, 1, " \
                   "0;\n}\n"                                                  \
                   : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(b),  \
                     "+r"(scale_d) VS_ACC##R(VS_F4_, VS_F4_)                   \
                   : "n"(OB));                                                 \
    }                                                                          \
  };

// The product of a no-swizzle K-major A and a 128-byte-swizzle K-major B,
// both descriptors built inside the asm as Sw64's are:
// Halo<N>::ss<OA, OB, LBO>(d, a, b) takes A at a + OA and B at b + OB. A's
// core matrices are 8 rows of 16 bytes, the rows 16 bytes apart and the
// 8-row groups 128 bytes apart (SBO), the two 8-column halves of a k16 step
// LBO bytes apart: 64 consecutive rows at any 16-byte offset of a column
// plane, so that a window shifted by whole rows is one descriptor (the
// fused conv's taps over its staged halo, csrc/gn_silu_conv.cu). B is
// stored N rows of 128 bytes, 8-row groups 1024 bytes apart. The
// immediates are operands IA, IB and IL (LBO in A's descriptor), after the
// accumulators.
template <int N>
struct Halo;

#define VS_WGMMA_HALO(N, R, IA, IB, IL)                                        \
  template <>                                                                  \
  struct Halo<N> {                                                             \
    template <int OA, int OB, int LBO>                                         \
    __device__ __forceinline__ static void ss(float* d, uint32_t a,            \
                                              uint32_t b) {                    \
      uint32_t scale_d = 1, unused0 = 0, unused1 = 0, unused2 = 0;             \
      asm volatile("{\n.reg .b32 la, lb, ha, hb;\n.reg .b64 da, db;\n"        \
                   ".reg .pred p;\n"                                          \
                   "add.u32 la, %0, %" #IA ";\n"                              \
                   "and.b32 la, la, 0x3FFFF;\n"                               \
                   "shr.u32 la, la, 4;\n"                                     \
                   "or.b32 la, la, %" #IL ";\n"                               \
                   "add.u32 lb, %1, %" #IB ";\n"                              \
                   "and.b32 lb, lb, 0x3FFFF;\n"                               \
                   "shr.u32 lb, lb, 4;\n"                                     \
                   "or.b32 lb, lb, 0x10000;\n"                                \
                   "mov.b32 ha, 0x8;\nmov.b32 hb, 0x40000040;\n"              \
                   "mov.b64 da, {la, ha};\nmov.b64 db, {lb, hb};\n"           \
                   "setp.ne.b32 p, %2, 0;\n"                                  \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                   VS_ACC##R(VS_S4, VS_S4_) "}, da, db, p, 1, 1, 0, 0;\n}\n"   \
                   : "+r"(a), "+r"(b), "+r"(scale_d), "+r"(unused0),           \
                     "+r"(unused1), "+r"(unused2) VS_ACC##R(VS_F4_, VS_F4_)     \
                   : "n"(OA), "n"(OB), "n"((LBO >> 4) << 16));                 \
    }                                                                          \
  };

// (N, N / 2)
VS_WGMMA_SS(32, 16)
VS_WGMMA_SS(64, 32)
VS_WGMMA_SS(96, 48)
VS_WGMMA_SS(128, 64)
VS_WGMMA_SS(160, 80)
VS_WGMMA_RS(8, 4)
VS_WGMMA_RS(16, 8)
VS_WGMMA_RS(24, 12)
VS_WGMMA_RS(32, 16)
VS_WGMMA_RS(40, 20)
VS_WGMMA_RS(48, 24)
VS_WGMMA_RS(56, 28)
VS_WGMMA_RS(64, 32)
VS_WGMMA_RS(72, 36)
VS_WGMMA_RS(80, 40)
VS_WGMMA_RS(88, 44)
VS_WGMMA_RS(96, 48)
VS_WGMMA_RS(104, 52)
VS_WGMMA_RS(112, 56)
VS_WGMMA_RS(120, 60)
VS_WGMMA_RS(128, 64)
VS_WGMMA_RS(136, 68)
VS_WGMMA_RS(144, 72)
VS_WGMMA_RS(152, 76)
VS_WGMMA_RS(160, 80)
VS_WGMMA_RS_K(64, 32)
VS_WGMMA_RS_K(96, 48)
VS_WGMMA_RS_K(128, 64)
VS_WGMMA_RS_K(160, 80)
// (N, N / 2, N / 2 + 6, N / 2 + 7): the operand numbers of the immediates
VS_WGMMA_SW64(32, 16, 22, 23)
VS_WGMMA_SW64(64, 32, 38, 39)
VS_WGMMA_SW64(80, 40, 46, 47)
VS_WGMMA_SW64(96, 48, 54, 55)
VS_WGMMA_SW64(112, 56, 62, 63)
VS_WGMMA_SW64(128, 64, 70, 71)
VS_WGMMA_SW64(144, 72, 78, 79)
VS_WGMMA_SW64(160, 80, 86, 87)
// (N, N / 2, N / 2 + 6, N / 2 + 7, N / 2 + 8)
VS_WGMMA_HALO(160, 80, 86, 87, 88)

#undef VS_WGMMA_HALO
#undef VS_WGMMA_SW64
#undef VS_SW64_DESC
#undef VS_WGMMA_RS_K
#undef VS_WGMMA_RS
#undef VS_WGMMA_RS_
#undef VS_WGMMA_SS
#undef VS_ACC4
#undef VS_ACC8
#undef VS_ACC12
#undef VS_ACC16
#undef VS_ACC20
#undef VS_ACC24
#undef VS_ACC28
#undef VS_ACC32
#undef VS_ACC36
#undef VS_ACC40
#undef VS_ACC44
#undef VS_ACC48
#undef VS_ACC52
#undef VS_ACC56
#undef VS_ACC60
#undef VS_ACC64
#undef VS_ACC68
#undef VS_ACC72
#undef VS_ACC76
#undef VS_ACC80
#undef VS_F4_
#undef VS_S4_
#undef VS_S4

}  // namespace sm90
}  // namespace vs
