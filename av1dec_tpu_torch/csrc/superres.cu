// The superres upscale of every plane of a frame [SPEC §7.16], the final
// planes and, when loop restoration reads them, the pre-CDEF planes,
// hand-written for Hopper (sm_90a), one launch a frame.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled
// superres program of the JAX package: av1dec_tpu/pipeline/device_recon.py:84
// (_superres_dev).  Its plain version is _superres_plain in
// av1dec_tpu_torch/ops/kernels/superres.py (a gather and 8 multiply-adds
// a plane, eager torch); the two agree byte for byte.
//
// What bounds it: bytes (each source plane read once, each output written
// once, the [dw, 8] column and tap tables of each plane read once); 8
// multiply-adds a pixel.
//
// Design: a block owns a strip of kStripW output columns times a band of
// kBandH output rows of one plane; a table of first blocks maps a block
// to its plane, and one 32-bit division of the block's index by the
// plane's strips (the same for all its threads) to its band and strip.
// Thread t owns output column x = strip * kStripW + t: it reads that
// column's 8 source columns and 8 taps from the host's tables once, as
// two 16-byte loads each where the tables are 16-byte aligned, clamps
// the columns to the source row [0, w - 1] and keeps all 16 in registers
// for the whole band.  The block's columns span source columns lo .. hi
// (their least and greatest, a warp shuffle and a shared-memory step
// apart): for a superres table that is at most kStripW * 8 / 9 + 8 of
// them.  The block copies each band row's span into shared memory with
// cp.async (__pipeline_memcpy_async), as the aligned 16-byte chunks that
// cover it (each holds at least one byte of the row, so they lie in its
// pages; the row's offset in its first chunk, from its address, places
// it), kGroup rows a stage and kStages stages in flight, one barrier a
// stage: while it filters one group of rows the next ones arrive.  Each
// thread then sums the 8 staged pixels times its taps for every row of
// the group, Round2 by 7 (FILTER_BITS), clips to [0, 2^bd - 1] and
// stores: a warp's 32 outputs of a row are one coalesced run.  Where a
// block's span does not fit its staged row (tables the host's arithmetic
// never builds), it reads the source rows through the cache instead, by
// the same clamped columns.  All index arithmetic is 32-bit but the row
// addresses; values stay far inside int32 (12-bit pixels, 8 taps of at
// most 128).  (Measured and left out, PERF.md: copies started before the
// tables arrive, from a span estimated from w / dw, with 2 to 8 stages,
// 8-row groups and 16- to 64-row bands; tap addresses computed once a
// group where the row stride is a multiple of 4 words.)

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxPlanes = 6;  // the final planes and the pre-CDEF planes
constexpr int kTaps = 8;
// output columns a block, one a thread, and output rows a block
constexpr int kStripW = 128;
constexpr int kThreads = kStripW;
constexpr int kBandH = 32;
// rows a stage and stages a block: kStages - 1 groups of rows in flight
// while one is filtered
constexpr int kGroup = 4;
constexpr int kStages = 4;
// words of a staged row: the span, its offset in its first 16-byte chunk
// (0 to 3 words) and slack; whole chunks
constexpr int kPitch = kStripW + 16;
constexpr int kChunks = kPitch / 4;

// The int64 parameter array (ops/kernels/superres.py _PARAMS): the ints,
// then per plane (up to kMaxPlanes) the source (pointer, row stride),
// its height and width, the output (contiguous [H, DW]) and its width
// DW, and the [DW, 8] int32 column and tap tables; a plane the call does
// not have is 0 throughout.
enum Param : int {
  P_BD = 0,
  P_NPLANES = 1,
  P_SRC0 = 2,
  P_SRC_STRIDE0 = 8,
  P_H0 = 14,
  P_W0 = 20,
  P_OUT0 = 26,
  P_DW0 = 32,
  P_COLS0 = 38,
  P_TAPS0 = 44,
  kParams = 50
};

struct Plane {
  const int32_t* src;
  int32_t* out;
  const int32_t* cols;
  const int32_t* taps;
  long long stride;
  int h, w, dw, strips;
  unsigned first;  // the plane's first block
};

struct Frame {
  Plane p[kMaxPlanes];
  int np, bd;
};

// The address of source row y's column c.
__device__ __forceinline__ const int32_t* src_at(const Plane& pl, int y,
                                                 int c) {
  return pl.src + y * pl.stride + c;
}

// Starts the copies of group g's rows (band rows g * kGroup ..) into
// stage g % kStages: the aligned chunks that cover columns lo .. lo +
// span - 1 of each row the band has.
__device__ __forceinline__ void stage(const Plane& pl, int y0, int rows,
                                      int lo, int span, int g,
                                      int32_t (*buf)[kPitch]) {
  for (int i = threadIdx.x; i < kGroup * kChunks; i += kThreads) {
    const int r = i / kChunks, k = i - r * kChunks;
    const int row = g * kGroup + r;
    if (row >= rows) continue;
    const uintptr_t first =
        reinterpret_cast<uintptr_t>(src_at(pl, y0 + row, lo));
    const int off = static_cast<int>(first & 15);
    if (16 * k < off + 4 * span)
      __pipeline_memcpy_async(
          &buf[r][4 * k],
          reinterpret_cast<const void*>((first & ~uintptr_t{15}) + 16 * k),
          16);
  }
}

// Round2(acc, 7) clipped to [0, hi].
__device__ __forceinline__ int32_t finish(int acc, int hi) {
  const int v = (acc + 64) >> 7;
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) superres_kernel(const Frame a) {
  __shared__ __align__(16) int32_t rows_s[kStages][kGroup][kPitch];
  __shared__ int span_s[2][kThreads / 32];
  int pi = 0;
  while (pi + 1 < a.np && blockIdx.x >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const unsigned b = blockIdx.x - pl.first;
  const unsigned band = b / static_cast<unsigned>(pl.strips);
  const int x = static_cast<int>(b - band * pl.strips) * kStripW +
                static_cast<int>(threadIdx.x);
  const int y0 = static_cast<int>(band) * kBandH;
  const int rows = min(kBandH, pl.h - y0);
  const bool live = x < pl.dw;
  const int hi_px = (1 << a.bd) - 1;

  // this column's source columns (clamped) and taps, and their range
  int c[kTaps], t[kTaps];
  int lo = INT_MAX, hi = -1;
  if (live) {
    const int32_t* cp = pl.cols + x * kTaps;
    const int32_t* tp = pl.taps + x * kTaps;
    if (((reinterpret_cast<uintptr_t>(pl.cols) |
          reinterpret_cast<uintptr_t>(pl.taps)) & 15) == 0) {
      const int4* c4 = reinterpret_cast<const int4*>(cp);
      const int4* t4 = reinterpret_cast<const int4*>(tp);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int4 cv = __ldg(c4 + q), tv = __ldg(t4 + q);
        c[4 * q] = cv.x;
        c[4 * q + 1] = cv.y;
        c[4 * q + 2] = cv.z;
        c[4 * q + 3] = cv.w;
        t[4 * q] = tv.x;
        t[4 * q + 1] = tv.y;
        t[4 * q + 2] = tv.z;
        t[4 * q + 3] = tv.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        c[j] = __ldg(cp + j);
        t[j] = __ldg(tp + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      c[j] = c[j] < 0 ? 0 : (c[j] >= pl.w ? pl.w - 1 : c[j]);
      lo = min(lo, c[j]);
      hi = max(hi, c[j]);
    }
  }
  for (int m = 16; m > 0; m >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
  }
  if ((threadIdx.x & 31) == 0) {
    span_s[0][threadIdx.x >> 5] = lo;
    span_s[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, span_s[0][w]);
    hi = max(hi, span_s[1][w]);
  }
  const int span = hi - lo + 1;

  if (span + 3 > kPitch) {  // the rows through the cache
    if (!live) return;
    for (int r = 0; r < rows; ++r) {
      const int32_t* src = src_at(pl, y0 + r, 0);
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) acc += __ldg(src + c[j]) * t[j];
      pl.out[static_cast<long long>(y0 + r) * pl.dw + x] = finish(acc, hi_px);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kTaps; ++j) c[j] -= lo;
  const int groups = (rows + kGroup - 1) / kGroup;
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < groups) stage(pl, y0, rows, lo, span, g, rows_s[g]);
    __pipeline_commit();
  }
  for (int g = 0; g < groups; ++g) {
    // group g has landed for every thread, and every thread is done with
    // group g - 1, whose stage the next copies fill
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    if (g + kStages - 1 < groups)
      stage(pl, y0, rows, lo, span, g + kStages - 1,
            rows_s[(g + kStages - 1) % kStages]);
    __pipeline_commit();
    if (!live) continue;
    for (int r = 0; r < kGroup; ++r) {
      const int y = y0 + g * kGroup + r;
      if (y >= y0 + rows) break;
      const int off = static_cast<int>(
          (reinterpret_cast<uintptr_t>(src_at(pl, y, lo)) & 15) >> 2);
      const int32_t* s = rows_s[g % kStages][r] + off;
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) acc += s[c[j]] * t[j];
      pl.out[static_cast<long long>(y) * pl.dw + x] = finish(acc, hi_px);
    }
  }
}

}  // namespace

// Upscales the `nplanes` planes (1 to kMaxPlanes) in one launch on
// `stream`.  `params`: kParams int64 in Param order.  Returns the
// launch's error code (0: launched).
extern "C" int superres_frame(const long long* params, int nplanes,
                              void* stream) {
  Frame a = {};
  a.np = nplanes;
  a.bd = static_cast<int>(params[P_BD]);
  if (nplanes < 1 || nplanes > kMaxPlanes || params[P_NPLANES] != nplanes ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  unsigned blocks = 0;
  for (int i = 0; i < nplanes; ++i) {
    Plane& pl = a.p[i];
    const long long h = params[P_H0 + i], w = params[P_W0 + i];
    const long long dw = params[P_DW0 + i];
    pl.src = reinterpret_cast<const int32_t*>(params[P_SRC0 + i]);
    pl.out = reinterpret_cast<int32_t*>(params[P_OUT0 + i]);
    pl.cols = reinterpret_cast<const int32_t*>(params[P_COLS0 + i]);
    pl.taps = reinterpret_cast<const int32_t*>(params[P_TAPS0 + i]);
    pl.stride = params[P_SRC_STRIDE0 + i];
    if (h < 1 || w < 1 || dw < 1 || h > (1 << 16) || w > (1 << 16) ||
        dw > (1 << 16) || pl.stride < w || !pl.src || !pl.out || !pl.cols ||
        !pl.taps)
      return cudaErrorInvalidValue;
    pl.h = static_cast<int>(h);
    pl.w = static_cast<int>(w);
    pl.dw = static_cast<int>(dw);
    pl.strips = (pl.dw + kStripW - 1) / kStripW;
    pl.first = blocks;
    blocks += static_cast<unsigned>(pl.strips) * ((pl.h + kBandH - 1) / kBandH);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, superres_kernel, a);
}
