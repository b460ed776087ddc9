// CDEF [SPEC §7.15] of 64-column regions, every plane in one launch,
// hand-written for Hopper (sm_90a): the one source of the direction
// search, the gating and the filter of both CDEF kernels.
//
// - cdef_frame.cu: a whole frame; positions outside the plane read
//   CDEF_VERY_LARGE (kBorder 0).
// - cdef_filter.cu: one column shard; every position comes from the
//   shard's bordered copy [H+4, W+4], whose border columns hold the
//   neighbouring shards' pixels (CDEF_VERY_LARGE at the frame's edges)
//   (kBorder 2).  That is the only difference between the two.
//
// Inputs: the int32 planes (luma; U and V unless mono) or their bordered
// copies, rows of any pitch, and the four per-8x8-luma-unit gated
// strengths y_pri, y_sec, uv_pri, uv_sec as [H/8, W/8] int32.  No
// per-pixel parameter map exists: each block derives a unit's parameters
// from its four strengths and its direction, in shared memory and
// registers.
//
// What bounds it on the H100: integer operations.  The bytes the function
// must move are the planes in and out (8 bytes a pixel, 24.9 MB for a
// 1080p 4:2:0 frame, 7.4 us at 3.35 TB/s) plus the strengths.  A pixel
// whose primary and secondary taps are all on costs some 150 int32
// operations; at 64 int32 results per clock per SM (compute capability
// 9.0), 132 SMs and about 1.98 GHz, a 1080p frame of such pixels needs
// about 28 us.  Taps with strength 0 and units with nothing to apply cost
// no operation, so the bound depends on the data.
//
// Design:
// - One block of 256 threads (8 warps) owns a region of 64 luma columns
//   and kRows rows (kRows / 8 x 8 units) and the co-located chroma
//   regions; each kernel file picks kRows for its launches.
// - The block stages its regions, each with its halo (2 rows; 2 columns
//   on each side, and 2 more on the left of a frame's region so that
//   rows start 16-byte aligned: a bordered copy is already shifted by 2),
//   in shared memory with 16-byte cp.async copies (the wrappers hand over
//   planes whose base and row pitch are multiples of 16 bytes).
//   Positions outside the source read CDEF_VERY_LARGE, written by the
//   block itself.  Every input pixel is read from device memory about
//   once (1.1 times with the halos).
// - Direction search, when a unit of the region has a luma or chroma
//   primary strength > 0: the units' luma, shifted to 8 bits and
//   centred, is copied as int8 into a unit-major array; warp w computes
//   the 15 partial sums of direction w for 16 units at a time as one
//   int8 product on the tensor cores (mma.sync m16n8k32, exact in int32)
//   with the direction's one-hot projection, the JAX reference's matmul,
//   and the cost from them (int32: costs stay below 2^30).  One thread
//   per unit then takes the first maximum, the variance and every
//   parameter of the unit.
// - Filtering: warp w takes units w, w + 8, ...; each warp works on one
//   unit at a time (its luma, two pixels a lane, then its U and V
//   together), so the direction, the tap offsets and the strengths are
//   warp-uniform: the tap offsets come from one broadcast constant read,
//   and a tap family with strength 0 is skipped for the whole warp.  A
//   tap is selects, not branches, so a pixel's 12 taps interleave; a
//   region whose taps stay inside its planes skips the CDEF_VERY_LARGE
//   test.  The lane-to-pixel mapping (8 rows x 4 columns a step) and the
//   row pitches (76 and 44 words, 12 modulo 32) keep the tap reads free
//   of bank conflicts.
//
// Each .cu that includes this header defines its own __global__ kernel
// around `cdef_region` and a plain C entry around `cdef_launch`, loaded
// with ctypes; a launch runs on the caller's stream and returns
// cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 30000;  // CDEF_VERY_LARGE
constexpr int kThreads = 256;
constexpr int kRegionW = 64;     // luma columns a block owns
constexpr int kLumaPitch = 76;   // >= the staged columns, 12 modulo 32
constexpr int kXsPitch = 80;     // bytes a unit's int8 luma row takes
constexpr int kParams = 12;      // ints a unit
constexpr int kMaxDevices = 64;

// per-unit parameter slots
enum {
  P_VALID, P_NEED, P_YPRI, P_YSEC, P_YDIR, P_YPSH, P_YSSH,
  P_CPRI, P_CSEC, P_CDIR, P_CPSH, P_CSSH
};

// Cdef_Directions[dir][k] as (dy, dx)
__constant__ int c_dir[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},
};
__constant__ int c_div[8] = {840, 420, 280, 210, 168, 140, 120, 105};
__constant__ int c_uv_dir_422[8] = {7, 0, 2, 4, 5, 6, 6, 6};

// src[p]: plane p (kBorder 0) or its bordered copy (kBorder 2), rows
// pitch[p] ints apart; H, W: the luma plane's (not the copy's) size.
struct CdefArgs {
  const int32_t* src[3];
  int pitch[3];
  int32_t* dst[3];
  const int32_t* gate[4];  // y_pri, y_sec, uv_pri, uv_sec: [H/8, W/8]
  int H, W, nplanes, coeff_shift, damping, subx, suby;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copy rows [y0, y0 + rows) x columns [x0, x0 + cols) of a source into
// `tile` (row pitch `tp`), CDEF_VERY_LARGE outside [0, H) x [0, W).  x0,
// cols, W, the pitches and the bases are multiples of 4 ints (16 bytes),
// so a 4-int chunk lies wholly inside or outside the source.
__device__ void stage(int* tile, int tp, int rows, int cols,
                      const int32_t* src, int sp, int H, int W, int y0,
                      int x0) {
  const int nc = cols >> 2;
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc, c = (i - r * nc) << 2;
    const int y = y0 + r, x = x0 + c;
    int* d = tile + r * tp + c;
    if (y >= 0 && y < H && x >= 0 && x < W)
      cp_async16(d, src + (size_t)y * sp + x);
    else
      *reinterpret_cast<int4*>(d) =
          make_int4(kVeryLarge, kVeryLarge, kVeryLarge, kVeryLarge);
  }
}

// The line of pixel (i, j) of an 8x8 block along direction d is
// f + ci * i + hi * (i >> 1) + cj * j + hj * (j >> 1) with these
// coefficients {f, ci, hi, cj, hj}.
__constant__ int c_line[8][5] = {
    {0, 1, 0, 1, 0},  {0, 1, 0, 0, 1},  {0, 1, 0, 0, 0},
    {3, 1, 0, 0, -1}, {7, 1, 0, -1, 0}, {3, 0, -1, 1, 0},
    {0, 0, 0, 1, 0},  {0, 0, 1, 1, 0},
};

// Weight of line l of direction d in the direction's cost [SPEC 7.15.2]:
// 105 for a line of 8 pixels, 840 / n for a line of n pixels, and 0 for
// lines that direction does not have.
__device__ __forceinline__ int line_weight(int d, int l) {
  if (d == 2 || d == 6) return l < 8 ? 105 : 0;
  if (d == 0 || d == 4) return l < 15 ? c_div[min(l, 14 - l)] : 0;
  if (l >= 3 && l <= 7) return 105;
  if (l < 3) return c_div[2 * l + 1];
  return l <= 10 ? c_div[2 * (10 - l) + 1] : 0;
}

// 4 int8 of column n of the projection of direction d: byte b is 1
// where pixel (i, j0 + b) of the 8x8 unit lies on line n.  The 4 pixels'
// lines are computed in the 4 bytes of one word (each in 0..14: no byte
// carries into the next) and compared with n at once.
__device__ __forceinline__ unsigned projection(int d, int i, int j0, int n) {
  const unsigned ones = 0x01010101u;
  const unsigned j4 = j0 * ones + 0x03020100u;         // j0 + b
  const unsigned h4 = (j0 >> 1) * ones + 0x01010000u;  // (j0 + b) >> 1
  const unsigned lines =
      (c_line[d][0] + c_line[d][1] * i + c_line[d][2] * (i >> 1)) * ones +
      c_line[d][3] * j4 + c_line[d][4] * h4;
  return __vcmpeq4(lines, n * ones) & ones;
}

// c += a * b on the tensor cores: a 16x32 int8 (row-major), b 32x8 int8
// (column-major), c 16x8 int32, in the registers of one warp.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a lane needs of the projection of direction d: its fragments of
// the one-hot projection [64 pixels x 16 lines] (1 where a pixel lies on
// a line) and the weights of the 4 lines it holds in the product.
struct Projection {
  unsigned b[2][2][2];  // [pixels 32 s..][lines 8 t..][register]
  int w[2][2];          // lines 8 t + 2 (lane & 3) + c
};

__device__ __forceinline__ Projection projection_of(int d, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  Projection p;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        p.b[s][t][r] = projection(d, 4 * s + 2 * r + (tg >> 1),
                                  (tg & 1) << 2, 8 * t + g);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      p.w[t][c] = line_weight(d, 8 * t + 2 * tg + c);
  return p;
}

// Cost of direction d (the warp's, projection pj) for units [0, units)
// whose centred luma is in xs (int8, a unit's 64 pixels row-major,
// kXsPitch bytes apart), written to cost[u * 8 + d].  The partial sums of
// the direction's 15 lines are one product on the tensor cores, exact in
// int8 x int8 -> int32: xs [units x 64] times the projection [64 x 16],
// 16 units at a time; a lane then holds 4 lines of 2 units and the cost
// is their weighted squares, summed over the unit's 4 lanes.
__device__ __forceinline__ void direction_costs(const Projection& pj,
                                                const uint8_t* xs, int units,
                                                int* cost, int d,
                                                int lane) {
  const int g = lane >> 2, tg = lane & 3;
  for (int m = 0; m < units; m += 16) {
    int acc[2][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint8_t* row = xs + (m + g) * kXsPitch + 32 * s + 4 * tg;
      const unsigned a[4] = {
          *reinterpret_cast<const unsigned*>(row),
          *reinterpret_cast<const unsigned*>(row + 8 * kXsPitch),
          *reinterpret_cast<const unsigned*>(row + 16),
          *reinterpret_cast<const unsigned*>(row + 8 * kXsPitch + 16)};
#pragma unroll
      for (int t = 0; t < 2; ++t)
        mma_s8(acc[t], a, pj.b[s][t][0], pj.b[s][t][1]);
    }
    int c0 = 0, c1 = 0;  // units m + g and m + g + 8
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      c0 += pj.w[t][0] * acc[t][0] * acc[t][0] +
            pj.w[t][1] * acc[t][1] * acc[t][1];
      c1 += pj.w[t][0] * acc[t][2] * acc[t][2] +
            pj.w[t][1] * acc[t][3] * acc[t][3];
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, x);
      c1 += __shfl_xor_sync(0xffffffffu, c1, x);
    }
    if (tg == 0 && m + g < units) cost[(m + g) * 8 + d] = c0;
    if (tg == 0 && m + g + 8 < units) cost[(m + g + 8) * 8 + d] = c1;
  }
}

// floor(log2(max(v, 1))), at most 12: _ilog2 of the plain version
__device__ __forceinline__ int ilog2_12(int v) {
  return v < 2 ? 0 : min(12, 31 - __clz(v));
}

__device__ __forceinline__ int shift_for(int strength, int damping) {
  return max(0, damping - ilog2_12(max(strength, 1)));
}

// One tap p of pixel x: its constrained difference, weighted, added to
// `total`, and p into the taps' max and min, unless p is CDEF_VERY_LARGE
// (kVL: the tile may hold it).  Selects, not a branch, so that the
// compiler interleaves a pixel's taps and their shared-memory loads.  The
// constrained difference is sign(d) * min(|d|, t) = clamp(d, -t, t) with
// t = max(strength - (|d| >> shift), 0); a CDEF_VERY_LARGE tap never
// lowers the min (every pixel is below it), so the min needs no select.
template <bool kVL>
__device__ __forceinline__ void tap(int p, int x, int strength, int shift,
                                    int weight, int& total, int& mx,
                                    int& mn) {
  const bool in = !kVL || p != kVeryLarge;
  const int d = p - x;
  const int t = in ? max(strength - (abs(d) >> shift), 0) : 0;
  total += weight * min(max(d, -t), t);
  mx = max(mx, in ? p : x);
  mn = min(mn, p);
}

// The taps of a unit: offsets (in a tile of row pitch tp) of the primary
// taps +-po[k] and secondary taps +-so[2k], +-so[2k + 1], their strengths,
// damping shifts and primary weights.
struct Taps {
  int po[2], so[4], pri, sec, psh, ssh, pw0, pw1;
};

__device__ __forceinline__ Taps unit_taps(int tp, int pri, int sec, int dir,
                                          int psh, int ssh,
                                          int coeff_shift) {
  Taps k;
  const int d2 = (dir + 2) & 7, d6 = (dir + 6) & 7;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    k.po[j] = c_dir[dir][j][0] * tp + c_dir[dir][j][1];
    k.so[2 * j] = c_dir[d2][j][0] * tp + c_dir[d2][j][1];
    k.so[2 * j + 1] = c_dir[d6][j][0] * tp + c_dir[d6][j][1];
  }
  const int odd = (pri >> coeff_shift) & 1;
  k.pri = pri;
  k.sec = sec;
  k.psh = psh;
  k.ssh = ssh;
  k.pw0 = odd ? 3 : 4;
  k.pw1 = odd ? 3 : 2;
  return k;
}

// Filter kN pixels of one lane, 4 columns apart: t[4 i] in the staged
// tile, written to o[4 i].  The family of taps with strength 0 is skipped
// (warp-uniform).
template <bool kVL, int kN>
__device__ __forceinline__ void filter_px(const int* t, int32_t* o,
                                          const Taps& k) {
  int x[kN], total[kN], mx[kN], mn[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = t[4 * i];
    total[i] = 0;
    mx[i] = mn[i] = x[i];
  }
  if (k.pri > 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int w = j ? k.pw1 : k.pw0;
        tap<kVL>(t[4 * i + k.po[j]], x[i], k.pri, k.psh, w, total[i],
                 mx[i], mn[i]);
        tap<kVL>(t[4 * i - k.po[j]], x[i], k.pri, k.psh, w, total[i],
                 mx[i], mn[i]);
      }
  }
  if (k.sec > 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int w = j < 2 ? 2 : 1;
        tap<kVL>(t[4 * i + k.so[j]], x[i], k.sec, k.ssh, w, total[i],
                 mx[i], mn[i]);
        tap<kVL>(t[4 * i - k.so[j]], x[i], k.sec, k.ssh, w, total[i],
                 mx[i], mn[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int y = x[i] + ((8 + total[i] - (total[i] < 0 ? 1 : 0)) >> 4);
    o[4 * i] = min(max(y, mn[i]), mx[i]);
  }
}

// Filter one unit of `np` planes (the same parameters for each), ry x rx
// pixels a plane; one warp, every argument but `lane` warp-uniform.
// tileP + t0 is the unit's top-left pixel in plane P's staged tile (row
// pitch tp); outP + o0 the same pixel in the output (row pitch op).  A
// lane takes 8 rows x 4 columns a step (conflict-free with a pitch of 12
// modulo 32); an 8x8 unit of one plane, both of its 4-column halves.
template <bool kVL>
__device__ void filter_unit(const int* tile0, const int* tile1, int tp,
                            int t0, int32_t* out0, int32_t* out1, int op,
                            size_t o0, int np, int lry, int rx,
                            const Taps& k, int lane) {
  if (np == 1 && lry == 3 && rx == 8) {
    const int row = lane >> 2, col = lane & 3;
    filter_px<kVL, 2>(tile0 + t0 + row * tp + col,
                      out0 + o0 + (size_t)row * op + col, k);
    return;
  }
  const int ry = 1 << lry, npx = ry * rx;
  for (int q0 = lane; q0 < np * npx; q0 += 32) {
    const int p = q0 >= npx ? 1 : 0;
    const int q = q0 - p * npx;
    const int row = (q >> 2) & (ry - 1);
    const int col = (q & 3) + 4 * (q >> (2 + lry));
    filter_px<kVL, 1>((p ? tile1 : tile0) + t0 + row * tp + col,
                      (p ? out1 : out0) + o0 + (size_t)row * op + col, k);
  }
}

// Whether the taps of a region of rows [y0, y0 + h) x columns [x0, x0 + w)
// of an H x W plane may read CDEF_VERY_LARGE: whether they reach outside
// the plane (a plane's pixels are all below it; a bordered copy holds it,
// or a neighbour's pixels, only outside).
__device__ __forceinline__ bool reaches_out(int y0, int x0, int h, int w,
                                            int H, int W) {
  return y0 < 2 || x0 < 2 || y0 + h + 2 > H || x0 + w + 2 > W;
}

// Staged columns left of a region's first column: 4 in a plane (2 for
// the taps, 2 so that rows start 16-byte aligned), 2 in a bordered copy
// (its column 0 is the plane's column -2).
template <int kBorder>
__host__ __device__ constexpr int left_cols() { return 4 - kBorder; }

// Staged columns of a region `w` wide: the left ones, w, 2 on the right,
// rounded up to whole 16-byte chunks.
template <int kBorder>
__host__ __device__ constexpr int staged_cols(int w) {
  return (left_cols<kBorder>() + w + 5) & ~3;
}

template <int kRows>
size_t smem_bytes(int nplanes, int subx, int suby) {
  constexpr int kUnits = kRows / 8 * (kRegionW / 8);
  size_t ints = (kRows + 4) * kLumaPitch + kUnits * kParams + kUnits * 8 +
                (kUnits + 15) / 16 * 16 * kXsPitch / 4;
  if (nplanes > 1)
    ints += 2 * (size_t)((kRows >> suby) + 4) * ((kRegionW >> subx) + 12);
  return ints * sizeof(int);
}

// Step 5 of `cdef_region`: warp w filters units w, w + 8, ... of the
// block's region, luma then U and V, from the staged tiles and the
// units' parameters `prm`.
template <bool kVL, int kRows>
__device__ __forceinline__ void filter_units(const CdefArgs& a,
                                             const int* ty, const int* tu,
                                             const int* tv, int cpitch,
                                             const int* prm, int left,
                                             int warp, int lane) {
  constexpr int kUnits = kRows / 8 * (kRegionW / 8);
  const int bx = blockIdx.x, by = blockIdx.y;
  const int cw = kRegionW >> a.subx, ch = kRows >> a.suby;
  const int cry = 8 >> a.suby, crx = 8 >> a.subx;
  const int Wc = a.W >> a.subx;
  for (int u = warp; u < kUnits; u += kThreads / 32) {
    const int* p = prm + u * kParams;
    if (!p[P_VALID]) continue;
    const int uy = u >> 3, ux = u & 7;
    filter_unit<kVL>(
        ty, ty, kLumaPitch, (2 + 8 * uy) * kLumaPitch + left + 8 * ux,
        a.dst[0], a.dst[0], a.W,
        (size_t)(by * kRows + 8 * uy) * a.W + bx * kRegionW + 8 * ux, 1, 3,
        8,
        unit_taps(kLumaPitch, p[P_YPRI], p[P_YSEC], p[P_YDIR], p[P_YPSH],
                  p[P_YSSH], a.coeff_shift),
        lane);
    if (a.nplanes > 1)
      filter_unit<kVL>(
          tu, tv, cpitch, (2 + cry * uy) * cpitch + left + crx * ux,
          a.dst[1], a.dst[2], Wc,
          (size_t)(by * ch + cry * uy) * Wc + bx * cw + crx * ux, 2,
          3 - a.suby, crx,
          unit_taps(cpitch, p[P_CPRI], p[P_CSEC], p[P_CDIR], p[P_CPSH],
                    p[P_CSSH], a.coeff_shift),
          lane);
  }
}

// The block (blockIdx.x, blockIdx.y) of a launch of `cdef_launch`: CDEF
// of luma rows [by * kRows, +kRows) x columns [bx * 64, +64) and the
// co-located chroma.  kBorder: 0 when src holds the planes (positions
// outside a plane read CDEF_VERY_LARGE), 2 when it holds bordered copies
// [H + 4, W + 4] of them (every tap reads the copy).
template <int kBorder, int kRows>
__device__ __forceinline__ void cdef_region(const CdefArgs& a) {
  constexpr int kUnits = kRows / 8 * (kRegionW / 8);
  constexpr int kLeft = left_cols<kBorder>();
  static_assert(kRows % 8 == 0 && kUnits <= 64, "kRows: 8 to 64");
  static_assert(staged_cols<kBorder>(kRegionW) <= kLumaPitch, "pitch");
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x, by = blockIdx.y;
  const bool chroma = a.nplanes > 1;
  const int cw = kRegionW >> a.subx, ch = kRows >> a.suby;
  const int cpitch = cw + 12, crows = ch + 4;  // pitch 12 modulo 32

  int* ty = smem;
  int* tu = ty + (kRows + 4) * kLumaPitch;
  int* tv = tu + (chroma ? crows * cpitch : 0);
  int* prm = tv + (chroma ? crows * cpitch : 0);
  int* cost = prm + kUnits * kParams;
  uint8_t* xs = reinterpret_cast<uint8_t*>(cost + kUnits * 8);

  // 1. stage the regions (asynchronous); row r, column c of a tile is
  // the plane's (y0 - 2 + r, x0 - kLeft + c), which a bordered copy
  // holds at (y0 + r - 2 + kBorder, x0 + c - kLeft + kBorder)
  stage(ty, kLumaPitch, kRows + 4, staged_cols<kBorder>(kRegionW),
        a.src[0], a.pitch[0], a.H + 2 * kBorder, a.W + 2 * kBorder,
        by * kRows - 2 + kBorder, bx * kRegionW - kLeft + kBorder);
  if (chroma) {
    const int Hc = a.H >> a.suby, Wc = a.W >> a.subx;
    for (int p = 1; p < 3; ++p)
      stage(p == 1 ? tu : tv, cpitch, crows, staged_cols<kBorder>(cw),
            a.src[p], a.pitch[p], Hc + 2 * kBorder, Wc + 2 * kBorder,
            by * ch - 2 + kBorder, bx * cw - kLeft + kBorder);
  }

  // 2. the units' strengths, while the copies run
  const int uH = a.H >> 3, uW = a.W >> 3;
  int need = 0;
  if (tid < kUnits) {
    const int gy = by * (kRows / 8) + (tid >> 3), gx = bx * 8 + (tid & 7);
    int* u = prm + tid * kParams;
    const bool valid = gy < uH && gx < uW;
    int ypri = 0, ysec = 0, cpri = 0, csec = 0;
    if (valid) {
      const size_t g = (size_t)gy * uW + gx;
      ypri = a.gate[0][g];
      ysec = a.gate[1][g];
      if (chroma) {
        cpri = a.gate[2][g];
        csec = a.gate[3][g];
      }
    }
    need = valid && (ypri > 0 || cpri > 0);
    u[P_VALID] = valid;
    u[P_NEED] = need;
    u[P_YPRI] = ypri;
    u[P_YSEC] = ysec;
    u[P_CPRI] = cpri;
    u[P_CSEC] = csec;
  }
  const Projection pj = projection_of(warp, lane);  // needs no pixel
  cp_async_wait_all();
  const int any_need = __syncthreads_or(need);

  // 3. direction search of the units that need it
  if (any_need) {
    // the luma as int8: (v >> coeff_shift) - 128 is the low byte of
    // v >> coeff_shift with its top bit flipped; four pixels a thread and
    // step (two 8-byte loads, one 4-byte store, conflict-free)
    for (int i = tid; i < kRows * kRegionW / 4; i += kThreads) {
      const int r = i >> 4, c = (i & 15) << 2;
      const int* src = ty + (r + 2) * kLumaPitch + c + kLeft;
      const int2 v0 = *reinterpret_cast<const int2*>(src);
      const int2 v1 = *reinterpret_cast<const int2*>(src + 2);
      const int cs = a.coeff_shift;
      const unsigned lo = __byte_perm(v0.x >> cs, v0.y >> cs, 0x0040);
      const unsigned hi = __byte_perm(v1.x >> cs, v1.y >> cs, 0x0040);
      *reinterpret_cast<unsigned*>(
          xs + ((r >> 3) * 8 + (c >> 3)) * kXsPitch + (r & 7) * 8 + (c & 7)) =
          __byte_perm(lo, hi, 0x5410) ^ 0x80808080u;
    }
    __syncthreads();
    direction_costs(pj, xs, kUnits, cost, warp, lane);
    __syncthreads();
  }

  // 4. every parameter of a unit, from its strengths and direction
  if (tid < kUnits) {
    int* u = prm + tid * kParams;
    int dir = 0, var = 0;
    if (u[P_NEED]) {
      const int* c = cost + tid * 8;
      int best = c[0];
      for (int d = 1; d < 8; ++d)
        if (c[d] > best) {
          best = c[d];
          dir = d;
        }
      var = (best - c[(dir + 4) & 7]) >> 10;
    }
    const int ypri = u[P_YPRI];
    int pri_adj = 0;
    if (ypri > 0 && var != 0)
      pri_adj = (ypri * (4 + ilog2_12(var >> 6)) + 8) >> 4;
    u[P_YPRI] = pri_adj;
    u[P_YDIR] = ypri > 0 ? dir : 0;
    u[P_YPSH] = shift_for(pri_adj, a.damping);
    u[P_YSSH] = shift_for(u[P_YSEC], a.damping);
    const int cpri = u[P_CPRI];
    const bool remap = a.subx != a.suby && a.subx;
    u[P_CDIR] = cpri > 0 ? (remap ? c_uv_dir_422[dir] : dir) : 0;
    u[P_CPSH] = shift_for(cpri, a.damping - 1);
    u[P_CSSH] = shift_for(u[P_CSEC], a.damping - 1);
  }
  __syncthreads();

  // 5. filter, one unit a warp at a time; a region whose taps stay inside
  // its planes (most of them) filters without the CDEF_VERY_LARGE test
  const bool vl =
      reaches_out(by * kRows, bx * kRegionW, kRows, kRegionW, a.H, a.W) ||
      (chroma && reaches_out(by * ch, bx * cw, ch, cw, a.H >> a.suby,
                             a.W >> a.subx));
  if (vl)
    filter_units<true, kRows>(a, ty, tu, tv, cpitch, prm, kLeft, warp, lane);
  else
    filter_units<false, kRows>(a, ty, tu, tv, cpitch, prm, kLeft, warp,
                               lane);
}

bool aligned16(const void* p, int pitch) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (pitch & 3) == 0;
}

// Check the arguments, raise `kernel`'s shared-memory limit once per
// device and size (`allowed`, the kernel's own record), and launch it on
// `stream` over the luma plane's H x W.  Returns a cudaError_t.
template <int kRows>
int cdef_launch(void (*kernel)(CdefArgs), size_t (&allowed)[kMaxDevices],
                CdefArgs a, int bd, void* stream) {
  if (a.H <= 0 || a.W <= 0) return 0;
  if ((a.H & 7) || (a.W & 7) || (a.nplanes != 1 && a.nplanes != 3) ||
      a.subx < 0 || a.subx > 1 || a.suby < 0 || a.suby > 1)
    return (int)cudaErrorInvalidValue;
  a.coeff_shift = bd - 8;
  if (a.nplanes == 1) a.subx = a.suby = 0;
  for (int p = 0; p < a.nplanes; ++p)
    if (!aligned16(a.src[p], a.pitch[p]))
      return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes<kRows>(a.nplanes, a.subx, a.suby);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  dim3 grid((a.W + kRegionW - 1) / kRegionW, (a.H + kRows - 1) / kRows);
  void* params[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                         dim3(kThreads), params, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
