// The device residuals of a host-path frame (B7): dequantization and the
// 2-D inverse transform of every pending transform block [SPEC §7.12.3,
// §7.13.3], hand-written for Hopper (sm_90a), one launch for all the
// (tx_size, tx_type) buckets of a call.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled
// residual programs of the JAX package: av1dec_tpu/ops/kernels/itx.py:88
// (residual_bucket, one jit program per bucket, with dequant_batch :72 and
// inverse_transform_batch :38).  Its plain version is _residuals_plain in
// av1dec_tpu_torch/ops/kernels/itx.py (residual_bucket per bucket, eager
// torch, one op per butterfly stage); the two agree byte for byte.
//
// What bounds it: bytes on paper (each coded level read once, each
// residual written once as int32), a fraction of a microsecond for a
// 1080p host frame.  A frame has a few hundred blocks, under one wave of
// the card, so in practice the launch and the longest chain of dependent
// butterflies in one block set its time; the design shortens that chain.
//
// Design: the host splits each span of the descriptor table (the blocks
// of one (tx_size, tx_type) bucket, contiguous: itx.pack_buckets) into
// CTAs of kThreads threads, each CTA k blocks of the span, as many as
// its threads take with one thread a row in the row pass and one a
// column in the column pass (32 4x4 blocks, 16 8x8, ... one 64x64).  A
// 32- or 64-point row or column is split over two threads in two warps:
// one runs the even half (the DCT of half the length on the even
// inputs, or half the identity's points), the other the odd half's
// butterfly stages; the two halves meet through shared memory for the
// last stage.  So the longest chain is half a 64-point DCT, and no block
// sets the launch's time alone.  A CTA's blocks share one [h][w + 1]
// int32 tile each in dynamic shared memory, sized on the host to the
// call's largest group (k h (w + 1) words, 17 KB at most).  The CTA
// dequantizes its blocks' coded levels (adj_h x adj_w, 64 clipped to 32)
// into the tiles with ((|level| q) & 0xFFFFFF) >> Tx_Scale, the sign and
// the CoeffMin/Max clamp; scales by 1/sqrt2 (NEW_INV_SQRT2) when log2 w -
// log2 h is odd; clamps to the row range.  Then the row transforms (DCT,
// ADST or identity) of the adj_h coded rows, each rounded by the row
// shift and clamped to the column range, and the column transforms of
// the adj_h coded inputs, rounded by 4 and written as residuals, flipped
// for the FLIPADST types.  Rows and columns past 32 hold zeros, so the
// kernel neither stores nor reads them.  Every 1-D transform is compiled
// for its length and kind, fully unrolled, so its points live in
// registers (no stack); the butterflies are the spec model's
// (ops/spec/itx.py), stage for stage.
//
// int32 wrap: the plain version computes in torch's int32, which wraps.
// Signed overflow is undefined in C++, so every sum, difference and
// product is taken in uint32_t (the same ring) and cast back; only the
// rounding shifts (arithmetic, on the int32 value), the clamps and the
// dequantizer's mask leave the ring, exactly where the plain version's do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Columns of the descriptor table (ops/kernels/itx.py DESC_FIELDS).
enum Desc : int {
  D_LEV = 0,
  D_OUT = 1,
  D_TX_SIZE = 2,
  D_TX_TYPE = 3,
  D_DCQ = 4,
  D_ACQ = 5,
  kDescFields = 6
};

// The int64 parameter array (ops/kernels/itx.py _PARAMS); P_SPANS holds
// the number of spans, then each span's (tx_size, tx_type, first block,
// blocks) follow.
enum Param : int {
  P_OUT = 0,
  P_DESC = 1,
  P_LEVELS = 2,
  P_LEVELS_LEN = 3,
  P_BD = 4,
  P_SPANS = 5,
  kParams = 6
};

constexpr int kThreads = 128;
constexpr int kTxSizes = 19;
constexpr int kTxTypes = 16;
constexpr int kCosBit = 12;
constexpr int32_t kNewSqrt2 = 5793;
constexpr int32_t kNewInvSqrt2 = 2896;
// spans a call: every valid (tx_size, tx_type) is 185 of them
constexpr int kMaxSpans = 190;

// round(2^12 cos(i pi / 128)) and round(2^12 (2 sqrt2 / 3) sin(i pi / 9))
// (ops/spec/itx.py COSPI, SINPI)
__constant__ int32_t kCospi[64] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897,  799,  700,  601,  501,  401,  301,  201,  101};
__constant__ int32_t kSinpi[5] = {0, 1321, 2482, 3344, 3803};
// The host's tables, read when it lays out the spans:
// log2 of (w, h) per TxSize (ops/spec/itx.py TX_DIMS)
constexpr int8_t kLog2W[kTxSizes] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4,
                                     5, 5, 6, 2, 4, 3, 5, 4, 6};
constexpr int8_t kLog2H[kTxSizes] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5,
                                     4, 6, 5, 4, 2, 5, 3, 6, 4};
// row shift per TxSize (_ROW_SHIFT) and Tx_Scale of the dequantizer
// (_TX_SCALE: (pels > 256) + (pels > 1024))
constexpr int8_t kRowShift[kTxSizes] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                        1, 1, 1, 1, 1, 2, 2, 2, 2};
constexpr int8_t kTxScale[kTxSizes] = {0, 0, 0, 1, 2, 0, 0, 0, 0, 1,
                                       1, 2, 2, 0, 0, 0, 0, 1, 1};
// (column kind, row kind, up-down flip, left-right flip) per TxType;
// kind 0 DCT, 1 ADST, 2 identity (TX_1D)
constexpr int8_t kTx1d[kTxTypes][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {0, 1, 0, 0}, {1, 1, 0, 0},
    {1, 0, 1, 0}, {0, 1, 0, 1}, {1, 1, 1, 1}, {1, 1, 0, 1},
    {1, 1, 1, 0}, {2, 2, 0, 0}, {0, 2, 0, 0}, {2, 0, 0, 0},
    {1, 2, 0, 0}, {2, 1, 0, 0}, {1, 2, 1, 0}, {2, 1, 0, 1}};
enum Kind : int { kDct = 0, kAdst = 1, kIdentity = 2 };

using i32 = int32_t;
using u32 = uint32_t;

__device__ __forceinline__ i32 add(i32 a, i32 b) {
  return static_cast<i32>(static_cast<u32>(a) + static_cast<u32>(b));
}
__device__ __forceinline__ i32 sub(i32 a, i32 b) {
  return static_cast<i32>(static_cast<u32>(a) - static_cast<u32>(b));
}
__device__ __forceinline__ i32 mul(i32 a, i32 b) {
  return static_cast<i32>(static_cast<u32>(a) * static_cast<u32>(b));
}
__device__ __forceinline__ i32 neg(i32 a) {
  return static_cast<i32>(0u - static_cast<u32>(a));
}
// round_shift: (x + 2^(bit-1)) >> bit, the add wrapping
__device__ __forceinline__ i32 rshift(i32 x, int bit) {
  return bit == 0 ? x : add(x, 1 << (bit - 1)) >> bit;
}
__device__ __forceinline__ i32 clampi(i32 v, i32 lo, i32 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ i32 C(int i) { return kCospi[i]; }
// half_btf(w0, a, w1, b) = round_shift(w0 a + w1 b, 12)
__device__ __forceinline__ i32 btf(i32 w0, i32 a, i32 w1, i32 b) {
  return rshift(add(mul(w0, a), mul(w1, b)), kCosBit);
}


// ---- 1-D inverse DCT (ops/spec/itx.py idct4 .. idct64), in place ----

__device__ __forceinline__ void idct4(i32* io) {
  const i32 i0 = io[0], i1 = io[1], i2 = io[2], i3 = io[3];
  const i32 b0 = btf(C(32), i0, C(32), i2);
  const i32 b1 = btf(C(32), i0, -C(32), i2);
  const i32 b2 = btf(C(48), i1, -C(16), i3);
  const i32 b3 = btf(C(16), i1, C(48), i3);
  io[0] = add(b0, b3);
  io[1] = add(b1, b2);
  io[2] = sub(b1, b2);
  io[3] = sub(b0, b3);
}

__device__ __forceinline__ void idct8(i32* io) {
  i32 ev[4] = {io[0], io[2], io[4], io[6]};
  idct4(ev);
  const i32 b4 = btf(C(56), io[1], -C(8), io[7]);
  const i32 b7 = btf(C(8), io[1], C(56), io[7]);
  const i32 b5 = btf(C(24), io[5], -C(40), io[3]);
  const i32 b6 = btf(C(40), io[5], C(24), io[3]);
  const i32 s4 = add(b4, b5), s5 = sub(b4, b5);
  const i32 s6 = sub(b7, b6), s7 = add(b6, b7);
  const i32 t5 = btf(-C(32), s5, C(32), s6);
  const i32 t6 = btf(C(32), s5, C(32), s6);
  const i32 odd[4] = {s4, t5, t6, s7};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    io[k] = add(ev[k], odd[3 - k]);
    io[4 + k] = sub(ev[3 - k], odd[k]);
  }
}

__device__ __forceinline__ void idct16(i32* io) {
  i32 ev[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) ev[k] = io[2 * k];
  idct8(ev);
  const i32* i = io;
  const i32 b8 = btf(C(60), i[1], -C(4), i[15]);
  const i32 b15 = btf(C(4), i[1], C(60), i[15]);
  const i32 b9 = btf(C(28), i[9], -C(36), i[7]);
  const i32 b14 = btf(C(36), i[9], C(28), i[7]);
  const i32 b10 = btf(C(44), i[5], -C(20), i[11]);
  const i32 b13 = btf(C(20), i[5], C(44), i[11]);
  const i32 b11 = btf(C(12), i[13], -C(52), i[3]);
  const i32 b12 = btf(C(52), i[13], C(12), i[3]);
  // stage 3
  const i32 s8 = add(b8, b9), s9 = sub(b8, b9);
  const i32 s10 = sub(b11, b10), s11 = add(b10, b11);
  const i32 s12 = add(b12, b13), s13 = sub(b12, b13);
  const i32 s14 = sub(b15, b14), s15 = add(b14, b15);
  // stage 4
  const i32 t9 = btf(-C(16), s9, C(48), s14);
  const i32 t14 = btf(C(48), s9, C(16), s14);
  const i32 t10 = btf(-C(48), s10, -C(16), s13);
  const i32 t13 = btf(-C(16), s10, C(48), s13);
  // stage 5
  const i32 u8 = add(s8, s11), u11 = sub(s8, s11);
  const i32 u9 = add(t9, t10), u10 = sub(t9, t10);
  const i32 u12 = sub(s15, s12), u15 = add(s12, s15);
  const i32 u13 = sub(t14, t13), u14 = add(t13, t14);
  // stage 6
  const i32 v10 = btf(-C(32), u10, C(32), u13);
  const i32 v13 = btf(C(32), u10, C(32), u13);
  const i32 v11 = btf(-C(32), u11, C(32), u12);
  const i32 v12 = btf(C(32), u11, C(32), u12);
  const i32 odd[8] = {u8, u9, v10, v11, v12, v13, u14, u15};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    io[k] = add(ev[k], odd[7 - k]);
    io[8 + k] = sub(ev[7 - k], odd[k]);
  }
}

// stage 3 and 5 of idct32/idct64: butterflies within groups of 4
__device__ __forceinline__ void groups4_stage3(const i32* b, i32* s, int n) {
#pragma unroll
  for (int g = 0; g < n; g += 4) {
    s[g + 0] = add(b[g + 0], b[g + 1]);
    s[g + 1] = sub(b[g + 0], b[g + 1]);
    s[g + 2] = sub(b[g + 3], b[g + 2]);
    s[g + 3] = add(b[g + 2], b[g + 3]);
  }
}
__device__ __forceinline__ void groups4_stage5(const i32* t, i32* u, int n) {
#pragma unroll
  for (int gi = 0, g = 0; g < n; ++gi, g += 4) {
    if (gi % 2 == 0) {
      u[g + 0] = add(t[g + 0], t[g + 3]);
      u[g + 1] = add(t[g + 1], t[g + 2]);
      u[g + 2] = sub(t[g + 1], t[g + 2]);
      u[g + 3] = sub(t[g + 0], t[g + 3]);
    } else {
      u[g + 0] = sub(t[g + 3], t[g + 0]);
      u[g + 1] = sub(t[g + 2], t[g + 1]);
      u[g + 2] = add(t[g + 1], t[g + 2]);
      u[g + 3] = add(t[g + 0], t[g + 3]);
    }
  }
}

// the odd half of idct32: x[16] from the odd inputs io[1], io[3], ...
__device__ __forceinline__ void idct32_odd(const i32* io, i32* x) {
  constexpr int kOdd[16] = {1, 17, 9, 25, 5, 21, 13, 29,
                            3, 19, 11, 27, 7, 23, 15, 31};
  constexpr int kA[8] = {62, 30, 46, 14, 54, 22, 38, 6};
  i32 oi[16], b[16], s[16], t[16], u[16], v[16], w[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) oi[k] = io[kOdd[k]];
  // stage 2
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = kA[k];
    b[k] = btf(C(a), oi[k], -C(64 - a), oi[15 - k]);
    b[15 - k] = btf(C(64 - a), oi[k], C(a), oi[15 - k]);
  }
  groups4_stage3(b, s, 16);
  // stage 4 rotations (8/56, 40/24)
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = s[k];
  t[1] = btf(-C(8), s[1], C(56), s[14]);
  t[14] = btf(C(56), s[1], C(8), s[14]);
  t[2] = btf(-C(56), s[2], -C(8), s[13]);
  t[13] = btf(-C(8), s[2], C(56), s[13]);
  t[5] = btf(-C(40), s[5], C(24), s[10]);
  t[10] = btf(C(24), s[5], C(40), s[10]);
  t[6] = btf(-C(24), s[6], -C(40), s[9]);
  t[9] = btf(-C(40), s[6], C(24), s[9]);
  groups4_stage5(t, u, 16);
  // stage 6 rotations (16/48)
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = u[k];
  v[2] = btf(-C(16), u[2], C(48), u[13]);
  v[13] = btf(C(48), u[2], C(16), u[13]);
  v[3] = btf(-C(16), u[3], C(48), u[12]);
  v[12] = btf(C(48), u[3], C(16), u[12]);
  v[4] = btf(-C(48), u[4], -C(16), u[11]);
  v[11] = btf(-C(16), u[4], C(48), u[11]);
  v[5] = btf(-C(48), u[5], -C(16), u[10]);
  v[10] = btf(-C(16), u[5], C(48), u[10]);
  // stage 7: merge groups of 8
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = add(v[k], v[7 - k]);
    w[7 - k] = sub(v[k], v[7 - k]);
    w[8 + k] = sub(v[15 - k], v[8 + k]);
    w[15 - k] = add(v[8 + k], v[15 - k]);
  }
  // stage 8 rotations (32/32)
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = w[k];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x[4 + m] = btf(-C(32), w[4 + m], C(32), w[11 - m]);
    x[11 - m] = btf(C(32), w[4 + m], C(32), w[11 - m]);
  }
}

__device__ __forceinline__ void idct32(i32* io) {
  i32 ev[16], x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) ev[k] = io[2 * k];
  idct16(ev);
  idct32_odd(io, x);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    io[k] = add(ev[k], x[15 - k]);
    io[16 + k] = sub(ev[15 - k], x[k]);
  }
}

// the odd half of idct64: p[32] from the odd inputs io[1], io[3], ...
__device__ __forceinline__ void idct64_odd(const i32* io, i32* p) {
  constexpr int kOdd[32] = {1, 33, 17, 49, 9,  41, 25, 57, 5,  37, 21,
                            53, 13, 45, 29, 61, 3,  35, 19, 51, 11, 43,
                            27, 59, 7,  39, 23, 55, 15, 47, 31, 63};
  constexpr int kA[16] = {63, 31, 47, 15, 55, 23, 39, 7,
                          59, 27, 43, 11, 51, 19, 35, 3};
  i32 q[32];  // each stage reads p or q and writes the other
#pragma unroll
  for (int k = 0; k < 32; ++k) q[k] = io[kOdd[k]];
  // stage 2
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int a = kA[k];
    p[k] = btf(C(a), q[k], -C(64 - a), q[31 - k]);
    p[31 - k] = btf(C(64 - a), q[k], C(a), q[31 - k]);
  }
  groups4_stage3(p, q, 32);  // s = q
  // stage 4 rotations (4/60, 36/28, 20/44, 52/12)
#pragma unroll
  for (int k = 0; k < 32; ++k) p[k] = q[k];  // t = p
  constexpr int kQuad[4][2] = {{0, 4}, {4, 36}, {8, 20}, {12, 52}};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int g = kQuad[m][0], a = kQuad[m][1];
    p[g + 1] = btf(-C(a), q[g + 1], C(64 - a), q[30 - g]);
    p[30 - g] = btf(C(64 - a), q[g + 1], C(a), q[30 - g]);
    p[g + 2] = btf(-C(64 - a), q[g + 2], -C(a), q[29 - g]);
    p[29 - g] = btf(-C(a), q[g + 2], C(64 - a), q[29 - g]);
  }
  groups4_stage5(p, q, 32);  // u = q
  // stage 6 rotations (8/56 on lanes 2-5/26-29; 40/24 on 10-13/18-21)
#pragma unroll
  for (int k = 0; k < 32; ++k) p[k] = q[k];  // v = p
  constexpr int kSix[2][2] = {{0, 8}, {8, 40}};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int base = kSix[m][0], a = kSix[m][1];
    const i32* u = q;
    p[base + 2] = btf(-C(a), u[base + 2], C(64 - a), u[29 - base]);
    p[29 - base] = btf(C(64 - a), u[base + 2], C(a), u[29 - base]);
    p[base + 3] = btf(-C(a), u[base + 3], C(64 - a), u[28 - base]);
    p[28 - base] = btf(C(64 - a), u[base + 3], C(a), u[28 - base]);
    p[base + 4] = btf(-C(64 - a), u[base + 4], -C(a), u[27 - base]);
    p[27 - base] = btf(-C(a), u[base + 4], C(64 - a), u[27 - base]);
    p[base + 5] = btf(-C(64 - a), u[base + 5], -C(a), u[26 - base]);
    p[26 - base] = btf(-C(a), u[base + 5], C(64 - a), u[26 - base]);
  }
  // stage 7: merge groups of 8 (w = q)
#pragma unroll
  for (int gi = 0, g = 0; g < 32; ++gi, g += 8) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (gi % 2 == 0) {
        q[g + m] = add(p[g + m], p[g + 7 - m]);
        q[g + 7 - m] = sub(p[g + m], p[g + 7 - m]);
      } else {
        q[g + m] = sub(p[g + 7 - m], p[g + m]);
        q[g + 7 - m] = add(p[g + m], p[g + 7 - m]);
      }
    }
  }
  // stage 8: rotations 16/48 (x = p)
#pragma unroll
  for (int k = 0; k < 32; ++k) p[k] = q[k];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    p[4 + m] = btf(-C(16), q[4 + m], C(48), q[27 - m]);
    p[27 - m] = btf(C(48), q[4 + m], C(16), q[27 - m]);
    p[8 + m] = btf(-C(48), q[8 + m], -C(16), q[23 - m]);
    p[23 - m] = btf(-C(16), q[8 + m], C(48), q[23 - m]);
  }
  // stage 9: merge groups of 16 (y = q)
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    q[m] = add(p[m], p[15 - m]);
    q[15 - m] = sub(p[m], p[15 - m]);
    q[16 + m] = sub(p[31 - m], p[16 + m]);
    q[31 - m] = add(p[16 + m], p[31 - m]);
  }
  // stage 10: rotations 32/32 (z = p)
#pragma unroll
  for (int k = 0; k < 32; ++k) p[k] = q[k];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    p[8 + m] = btf(-C(32), q[8 + m], C(32), q[23 - m]);
    p[23 - m] = btf(C(32), q[8 + m], C(32), q[23 - m]);
  }
}

// ---- 1-D inverse ADST (iadst4, iadst8, iadst16), in place ----

__device__ __forceinline__ void iadst4(i32* io) {
  const i32 x0 = io[0], x1 = io[1], x2 = io[2], x3 = io[3];
  const i32* s = kSinpi;
  i32 s0 = mul(s[1], x0);
  i32 s1 = mul(s[2], x0);
  i32 s2 = mul(s[3], x1);
  i32 s3 = mul(s[4], x2);
  const i32 s4 = mul(s[1], x2);
  const i32 s5 = mul(s[2], x3);
  const i32 s6 = mul(s[4], x3);
  const i32 s7 = add(sub(x0, x2), x3);
  s0 = add(s0, s3);
  s1 = sub(s1, s4);
  s3 = s2;
  s2 = mul(s[3], s7);
  s0 = add(s0, s5);
  s1 = sub(s1, s6);
  io[0] = rshift(add(s0, s3), kCosBit);
  io[1] = rshift(add(s1, s3), kCosBit);
  io[2] = rshift(s2, kCosBit);
  io[3] = rshift(sub(add(s0, s1), s3), kCosBit);
}

__device__ __forceinline__ void iadst8(i32* io) {
  const i32* i = io;
  i32 s[8] = {i[7], i[0], i[5], i[2], i[3], i[4], i[1], i[6]};
  i32 b[8];
  b[0] = btf(C(4), s[0], C(60), s[1]);
  b[1] = btf(C(60), s[0], -C(4), s[1]);
  b[2] = btf(C(20), s[2], C(44), s[3]);
  b[3] = btf(C(44), s[2], -C(20), s[3]);
  b[4] = btf(C(36), s[4], C(28), s[5]);
  b[5] = btf(C(28), s[4], -C(36), s[5]);
  b[6] = btf(C(52), s[6], C(12), s[7]);
  b[7] = btf(C(12), s[6], -C(52), s[7]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = add(b[k], b[k + 4]);
    s[k + 4] = sub(b[k], b[k + 4]);
  }
  b[0] = s[0];
  b[1] = s[1];
  b[2] = s[2];
  b[3] = s[3];
  b[4] = btf(C(16), s[4], C(48), s[5]);
  b[5] = btf(C(48), s[4], -C(16), s[5]);
  b[6] = btf(-C(48), s[6], C(16), s[7]);
  b[7] = btf(C(16), s[6], C(48), s[7]);
  s[0] = add(b[0], b[2]);
  s[1] = add(b[1], b[3]);
  s[2] = sub(b[0], b[2]);
  s[3] = sub(b[1], b[3]);
  s[4] = add(b[4], b[6]);
  s[5] = add(b[5], b[7]);
  s[6] = sub(b[4], b[6]);
  s[7] = sub(b[5], b[7]);
  b[0] = s[0];
  b[1] = s[1];
  b[2] = btf(C(32), s[2], C(32), s[3]);
  b[3] = btf(C(32), s[2], -C(32), s[3]);
  b[4] = s[4];
  b[5] = s[5];
  b[6] = btf(C(32), s[6], C(32), s[7]);
  b[7] = btf(C(32), s[6], -C(32), s[7]);
  io[0] = b[0];
  io[1] = neg(b[4]);
  io[2] = b[6];
  io[3] = neg(b[2]);
  io[4] = b[3];
  io[5] = neg(b[7]);
  io[6] = b[5];
  io[7] = neg(b[1]);
}

__device__ __forceinline__ void iadst16(i32* io) {
  const i32* i = io;
  i32 s[16] = {i[15], i[0], i[13], i[2], i[11], i[4], i[9], i[6],
               i[7],  i[8], i[5],  i[10], i[3], i[12], i[1], i[14]};
  i32 b[16];
  constexpr int kA[8] = {2, 10, 18, 26, 34, 42, 50, 58};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = kA[k];
    b[2 * k] = btf(C(a), s[2 * k], C(64 - a), s[2 * k + 1]);
    b[2 * k + 1] = btf(C(64 - a), s[2 * k], -C(a), s[2 * k + 1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = add(b[k], b[k + 8]);
    s[k + 8] = sub(b[k], b[k + 8]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = s[k];
  b[8] = btf(C(8), s[8], C(56), s[9]);
  b[9] = btf(C(56), s[8], -C(8), s[9]);
  b[10] = btf(C(40), s[10], C(24), s[11]);
  b[11] = btf(C(24), s[10], -C(40), s[11]);
  b[12] = btf(-C(56), s[12], C(8), s[13]);
  b[13] = btf(C(8), s[12], C(56), s[13]);
  b[14] = btf(-C(24), s[14], C(40), s[15]);
  b[15] = btf(C(40), s[14], C(24), s[15]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = add(b[k], b[k + 4]);
    s[k + 4] = sub(b[k], b[k + 4]);
    s[k + 8] = add(b[k + 8], b[k + 12]);
    s[k + 12] = sub(b[k + 8], b[k + 12]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b[k] = s[k];
    b[k + 8] = s[k + 8];
  }
#pragma unroll
  for (int g = 4; g < 16; g += 8) {
    b[g] = btf(C(16), s[g], C(48), s[g + 1]);
    b[g + 1] = btf(C(48), s[g], -C(16), s[g + 1]);
    b[g + 2] = btf(-C(48), s[g + 2], C(16), s[g + 3]);
    b[g + 3] = btf(C(16), s[g + 2], C(48), s[g + 3]);
  }
#pragma unroll
  for (int g = 0; g < 16; g += 4) {
    s[g] = add(b[g], b[g + 2]);
    s[g + 1] = add(b[g + 1], b[g + 3]);
    s[g + 2] = sub(b[g], b[g + 2]);
    s[g + 3] = sub(b[g + 1], b[g + 3]);
  }
#pragma unroll
  for (int g = 0; g < 16; g += 4) {
    b[g] = s[g];
    b[g + 1] = s[g + 1];
    b[g + 2] = btf(C(32), s[g + 2], C(32), s[g + 3]);
    b[g + 3] = btf(C(32), s[g + 2], -C(32), s[g + 3]);
  }
  constexpr int kOut[16] = {0, 8, 12, 4, 6, 14, 10, 2,
                            3, 11, 15, 7, 5, 13, 9, 1};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    io[k] = k % 2 ? neg(b[kOut[k]]) : b[kOut[k]];
}

// ---- identity (iidentity) of one n-point value ----

template <int N>
__device__ __forceinline__ i32 iidentity(i32 v) {
  if constexpr (N == 4) return rshift(mul(v, kNewSqrt2), kCosBit);
  if constexpr (N == 8) return mul(v, 2);
  if constexpr (N == 16) return rshift(mul(mul(v, 2), kNewSqrt2), kCosBit);
  return mul(v, 4);
}

// ---- a 1-D transform of length N and kind Kind, in place, and its
// halves for N = 32 and 64 ----

template <int N, int Kind>
__device__ __forceinline__ void tx1d(i32 (&x)[N]) {
  if constexpr (Kind == kIdentity) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = iidentity<N>(x[k]);
  } else if constexpr (Kind == kAdst) {
    if constexpr (N == 4) iadst4(x);
    if constexpr (N == 8) iadst8(x);
    if constexpr (N == 16) iadst16(x);
  } else {
    if constexpr (N == 4) idct4(x);
    if constexpr (N == 8) idct8(x);
    if constexpr (N == 16) idct16(x);
    if constexpr (N == 32) idct32(x);
  }
}

// The even half of an N-point DCT (N = 32, 64): the N/2-point DCT of the
// even inputs x[0], x[2], ...
template <int N>
__device__ __forceinline__ void dct_even(const i32 (&x)[N],
                                         i32 (&h)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) h[k] = x[2 * k];
  tx1d<N / 2, kDct>(h);
}

// The odd half: the odd inputs' butterfly stages.
template <int N>
__device__ __forceinline__ void dct_odd(const i32 (&x)[N], i32 (&h)[N / 2]) {
  if constexpr (N == 32) idct32_odd(x, h);
  if constexpr (N == 64) idct64_odd(x, h);
}

// Spans of the call, one CTA group after the other (laid out on the host).
struct Span {
  int first;  // first block (descriptor row)
  int count;  // blocks
  int cta;    // first CTA
  int8_t lw, lh;        // log2 of the blocks' w and h
  int8_t k;             // blocks a CTA
  int8_t shift, scale;  // row shift, Tx_Scale
  int8_t ck, rk;        // column and row kinds
  int8_t flip;          // 1: up-down, 2: left-right
};

struct ItxArgs {
  int32_t* out;
  const int32_t* desc;
  const int32_t* levels;
  int levels_len;
  int bd;
  int nspans;
  Span s[kMaxSpans];
};

// The CTA's tiles: block b's row r at tile + (b h + r) (w + 1).
struct Tiles {
  int32_t* t;
  int w, h, pitch;
  __device__ int32_t* row(int b, int r) const {
    return t + (b * h + r) * pitch;
  }
};

// Whether a pass of N points splits each row or column over two threads.
template <int N>
constexpr bool kSplit = N >= 32;

// The row pass: the N-point (N = w) row transform of each of the adj_h
// coded rows of the CTA's nb blocks, rounded by the row shift and clamped
// to the column range, back into the row.  Inputs past 32 are zeros.
template <int N, int Kind>
__device__ __forceinline__ void row_pass(const Span& sp, const Tiles& T,
                                         int nb, i32 col_hi) {
  constexpr int kNz = N < 32 ? N : 32;
  const int ah = T.h < 32 ? T.h : 32;
  const int tid = static_cast<int>(threadIdx.x);
  auto done = [&](i32 v) {
    return clampi(rshift(v, sp.shift), -col_hi - 1, col_hi);
  };
  if constexpr (!kSplit<N>) {
    if (tid >= nb * ah) return;
    i32* row = T.row(tid / ah, tid % ah);
    i32 x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = row[j];
    tx1d<N, Kind>(x);
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = done(x[j]);
  } else {
    // threads [0, U) the even halves, [U, 2U) the odd ones (U a multiple
    // of 32: whole warps)
    constexpr int H = N / 2;
    const int U = sp.k * ah, half = tid / U, u = tid % U;
    const bool on = half < 2 && u < nb * ah;
    i32* row = T.row(u / ah, u % ah);
    if constexpr (Kind == kIdentity) {
      if (!on) return;
#pragma unroll
      for (int m = 0; m < H; ++m)
        row[half * H + m] = done(iidentity<N>(row[half * H + m]));
      return;
    } else {
      i32 mine[H], got[H];
      if (on) {
        i32 x[N];
#pragma unroll
        for (int j = 0; j < N; ++j) x[j] = 0;
        if (half == 0) {
#pragma unroll
          for (int j = 0; j < kNz; j += 2) x[j] = row[j];
          dct_even<N>(x, mine);
        } else {
#pragma unroll
          for (int j = 1; j < kNz; j += 2) x[j] = row[j];
          dct_odd<N>(x, mine);
        }
      }
      __syncthreads();  // every row read
      if (on) {
#pragma unroll
        for (int m = 0; m < H; ++m) row[half * H + m] = mine[m];
      }
      __syncthreads();  // both halves in the row
      if (on) {
        // out[k] = even[k] + odd[H-1-k], out[H+k] = even[H-1-k] - odd[k]
#pragma unroll
        for (int k = 0; k < H; ++k)
          got[k] = half == 0 ? add(mine[k], row[N - 1 - k])
                             : sub(row[H - 1 - k], mine[k]);
      }
      __syncthreads();  // both halves read
      if (on) {
#pragma unroll
        for (int k = 0; k < H; ++k) row[half * H + k] = done(got[k]);
      }
    }
  }
}

// The column pass: the N-point (N = h) column transform of each of the
// w columns of the CTA's nb blocks, from its adj_h coded inputs, rounded
// by 4 into the block's residuals, flipped as the type says.
template <int N, int Kind>
__device__ __forceinline__ void col_pass(const ItxArgs& a, const Span& sp,
                                         const Tiles& T, int b0, int nb) {
  constexpr int kNz = N < 32 ? N : 32;
  const int w = T.w;
  const int tid = static_cast<int>(threadIdx.x);
  const bool ud = sp.flip & 1, lr = sp.flip & 2;
  // column c of block b's residuals, and its row i
  auto column = [&](int b, int c) {
    return a.out + __ldg(a.desc + (b0 + b) * kDescFields + D_OUT) +
           (lr ? w - 1 - c : c);
  };
  auto put = [&](int32_t* col, int i, i32 v) {
    col[(ud ? N - 1 - i : i) * w] = rshift(v, 4);
  };
  if constexpr (!kSplit<N>) {
    if (tid >= nb * w) return;
    const int b = tid / w, c = tid % w;
    i32 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = T.row(b, i)[c];
    tx1d<N, Kind>(x);
    int32_t* col = column(b, c);
#pragma unroll
    for (int i = 0; i < N; ++i) put(col, i, x[i]);
  } else {
    constexpr int H = N / 2;
    const int U = sp.k * w, half = tid / U, u = tid % U;
    const bool on = half < 2 && u < nb * w;
    const int b = u / w, c = u % w;
    if constexpr (Kind == kIdentity) {
      if (!on) return;
      int32_t* col = column(b, c);
#pragma unroll
      for (int m = 0; m < H; ++m)
        put(col, half * H + m, iidentity<N>(T.row(b, half * H + m)[c]));
      return;
    } else {
      i32 mine[H];
      if (on) {
        i32 x[N];
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = 0;
        if (half == 0) {
#pragma unroll
          for (int i = 0; i < kNz; i += 2) x[i] = T.row(b, i)[c];
          dct_even<N>(x, mine);
        } else {
#pragma unroll
          for (int i = 1; i < kNz; i += 2) x[i] = T.row(b, i)[c];
          dct_odd<N>(x, mine);
        }
      }
      __syncthreads();  // every column read
      if (on) {
#pragma unroll
        for (int m = 0; m < H; ++m) T.row(b, half * H + m)[c] = mine[m];
      }
      __syncthreads();  // both halves in the column
      if (on) {
        int32_t* col = column(b, c);
#pragma unroll
        for (int k = 0; k < H; ++k)
          put(col, half * H + k,
              half == 0 ? add(mine[k], T.row(b, N - 1 - k)[c])
                        : sub(T.row(b, H - 1 - k)[c], mine[k]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) itx_kernel(const ItxArgs a) {
#ifdef CUDA_CPU_SHIM
  int32_t* const smem = static_cast<int32_t*>(cuda_cpu_shim_dynamic_smem());
#else
  extern __shared__ __align__(16) int32_t smem[];
#endif
  const int cta = static_cast<int>(blockIdx.x);
  // the CTA's span: the last one that starts at or before it
  int lo = 0, hi = a.nspans - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.s[mid].cta <= cta)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Span& sp = a.s[lo];
  const int b0 = sp.first + (cta - sp.cta) * sp.k;
  const int nb = min(static_cast<int>(sp.k), sp.first + sp.count - b0);
  const int lw = sp.lw, lh = sp.lh;
  const int w = 1 << lw, h = 1 << lh;
  const Tiles T{smem, w, h, w + 1};
  const int law = lw < 5 ? lw : 5, lah = lh < 5 ? lh : 5;
  const i32 coef_hi = (1 << (7 + a.bd)) - 1;
  const i32 row_hi = (1 << (a.bd + 7)) - 1;
  const int cb = a.bd + 6 > 16 ? a.bd + 6 : 16;
  const i32 col_hi = (1 << (cb - 1)) - 1;
  const bool rect = ((lw - lh) & 1) != 0;

  // dequantize the coded levels into the tiles; the rectangular scale;
  // the row clamp
  for (int p = static_cast<int>(threadIdx.x); p < nb << (law + lah);
       p += kThreads) {
    const int b = p >> (law + lah), k = p & ((1 << (law + lah)) - 1);
    const int32_t* d = a.desc + (b0 + b) * kDescFields;
    const i32 level = __ldg(a.levels + min(__ldg(d + D_LEV) + k,
                                           a.levels_len - 1));
    const u32 q = static_cast<u32>(__ldg(d + (k == 0 ? D_DCQ : D_ACQ)));
    const u32 mag_in =
        level < 0 ? 0u - static_cast<u32>(level) : static_cast<u32>(level);
    const i32 mag = static_cast<i32>(((mag_in * q) & 0xFFFFFFu) >> sp.scale);
    i32 v = clampi(level < 0 ? -mag : mag, -coef_hi - 1, coef_hi);
    if (rect) v = rshift(mul(v, kNewInvSqrt2), kCosBit);
    T.row(b, k >> law)[k & ((1 << law) - 1)] =
        clampi(v, -row_hi - 1, row_hi);
  }
  __syncthreads();

  switch (sp.rk * 8 + lw) {
    case kDct * 8 + 2: row_pass<4, kDct>(sp, T, nb, col_hi); break;
    case kDct * 8 + 3: row_pass<8, kDct>(sp, T, nb, col_hi); break;
    case kDct * 8 + 4: row_pass<16, kDct>(sp, T, nb, col_hi); break;
    case kDct * 8 + 5: row_pass<32, kDct>(sp, T, nb, col_hi); break;
    case kDct * 8 + 6: row_pass<64, kDct>(sp, T, nb, col_hi); break;
    case kAdst * 8 + 2: row_pass<4, kAdst>(sp, T, nb, col_hi); break;
    case kAdst * 8 + 3: row_pass<8, kAdst>(sp, T, nb, col_hi); break;
    case kAdst * 8 + 4: row_pass<16, kAdst>(sp, T, nb, col_hi); break;
    case kIdentity * 8 + 2: row_pass<4, kIdentity>(sp, T, nb, col_hi); break;
    case kIdentity * 8 + 3: row_pass<8, kIdentity>(sp, T, nb, col_hi); break;
    case kIdentity * 8 + 4:
      row_pass<16, kIdentity>(sp, T, nb, col_hi);
      break;
    default: row_pass<32, kIdentity>(sp, T, nb, col_hi); break;
  }
  __syncthreads();

  switch (sp.ck * 8 + lh) {
    case kDct * 8 + 2: col_pass<4, kDct>(a, sp, T, b0, nb); break;
    case kDct * 8 + 3: col_pass<8, kDct>(a, sp, T, b0, nb); break;
    case kDct * 8 + 4: col_pass<16, kDct>(a, sp, T, b0, nb); break;
    case kDct * 8 + 5: col_pass<32, kDct>(a, sp, T, b0, nb); break;
    case kDct * 8 + 6: col_pass<64, kDct>(a, sp, T, b0, nb); break;
    case kAdst * 8 + 2: col_pass<4, kAdst>(a, sp, T, b0, nb); break;
    case kAdst * 8 + 3: col_pass<8, kAdst>(a, sp, T, b0, nb); break;
    case kAdst * 8 + 4: col_pass<16, kAdst>(a, sp, T, b0, nb); break;
    case kIdentity * 8 + 2: col_pass<4, kIdentity>(a, sp, T, b0, nb); break;
    case kIdentity * 8 + 3: col_pass<8, kIdentity>(a, sp, T, b0, nb); break;
    case kIdentity * 8 + 4:
      col_pass<16, kIdentity>(a, sp, T, b0, nb);
      break;
    default: col_pass<32, kIdentity>(a, sp, T, b0, nb); break;
  }
}

}  // namespace

// Runs the residuals of the `blocks` transform blocks of the descriptor
// table in one launch on `stream`.  `params`: kParams int64 in Param
// order, then 4 a span: (tx_size, tx_type, first block, blocks), the
// spans covering the `blocks` blocks of the table once.  Returns the
// launch's error code (0: launched, or nothing to launch).
extern "C" int itx_residuals(const long long* params, int blocks,
                             void* stream) {
  ItxArgs a;
  a.out = reinterpret_cast<int32_t*>(params[P_OUT]);
  a.desc = reinterpret_cast<const int32_t*>(params[P_DESC]);
  a.levels = reinterpret_cast<const int32_t*>(params[P_LEVELS]);
  a.levels_len = static_cast<int>(params[P_LEVELS_LEN]);
  a.bd = static_cast<int>(params[P_BD]);
  a.nspans = static_cast<int>(params[P_SPANS]);
  if (blocks < 0 || a.levels_len < 1 || a.nspans < 0 ||
      a.nspans > kMaxSpans || (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  long long covered = 0, ctas = 0, words = 0;
  for (int i = 0; i < a.nspans; ++i) {
    const long long* q = params + kParams + 4 * i;
    if (q[0] < 0 || q[0] >= kTxSizes || q[1] < 0 || q[1] >= kTxTypes ||
        q[2] < 0 || q[3] < 0 || q[2] + q[3] > blocks)
      return cudaErrorInvalidValue;
    const int tsz = static_cast<int>(q[0]), tt = static_cast<int>(q[1]);
    const int lw = kLog2W[tsz], lh = kLog2H[tsz];
    const int ck = kTx1d[tt][0], rk = kTx1d[tt][1];
    // the kernel's transforms: ADST up to 16 points, 64 points DCT only
    if ((rk == kAdst && lw > 4) || (ck == kAdst && lh > 4) ||
        ((lw == 6 || lh == 6) && tt != 0))
      return cudaErrorInvalidValue;
    // threads a block: a row (two past 16 points) for each coded row,
    // and a column (two) for each column
    const int rows = (lh < 5 ? 1 << lh : 32) * (lw >= 5 ? 2 : 1);
    const int cols = (1 << lw) * (lh >= 5 ? 2 : 1);
    const int k = kThreads / (rows > cols ? rows : cols);
    Span& sp = a.s[i];
    sp.first = static_cast<int>(q[2]);
    sp.count = static_cast<int>(q[3]);
    sp.cta = static_cast<int>(ctas);
    sp.lw = static_cast<int8_t>(lw);
    sp.lh = static_cast<int8_t>(lh);
    sp.k = static_cast<int8_t>(k);
    sp.shift = kRowShift[tsz];
    sp.scale = kTxScale[tsz];
    sp.ck = static_cast<int8_t>(ck);
    sp.rk = static_cast<int8_t>(rk);
    sp.flip = static_cast<int8_t>(kTx1d[tt][2] | kTx1d[tt][3] << 1);
    covered += q[3];
    ctas += (q[3] + k - 1) / k;
    if (q[3] > 0) {
      const long long need = static_cast<long long>(k) << lh;
      words = need * ((1 << lw) + 1) > words ? need * ((1 << lw) + 1)
                                             : words;
    }
  }
  if (covered != blocks || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(words) * sizeof(int32_t);
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, itx_kernel, a);
}
