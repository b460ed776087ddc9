// The Wiener loop-restoration filter of every Wiener plane of a frame
// [SPEC §7.17.4], hand-written for Hopper (sm_90a), one launch a frame.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled Wiener
// program of the JAX package: av1dec_tpu/ops/kernels/lr.py:29
// (wiener_plane, all planes in lr_wiener_planes :69).  Its plain version
// is _wiener_plain in av1dec_tpu_torch/ops/kernels/lr.py (wiener_plane a
// plane, eager torch); the two agree byte for byte.  Like the plain
// version, and unlike the JAX pass, it filters the source row of each
// vertical tap with the horizontal taps of the output pixel's unit, the
// spec's rule (ROADMAP, queue 3 item 1).
//
// What bounds it: bytes.  Each output pixel is written once; the
// post-CDEF plane is read once, and the pre-CDEF plane only on the rows
// that cross a stripe boundary.  The filter is 49 multiply-adds a pixel.
//
// Design: one thread an output pixel (y, x), x fastest, every plane of
// the frame in the one launch.  Its unit (uy[y], ux[x]) gives its 7
// vertical and 7 horizontal taps and whether the unit is on; a unit that
// is off (or the sentinel row and column past the crop) copies the
// post-CDEF pixel.  For each vertical tap k the thread reads the source
// row vr[k, y] from the post-CDEF plane where inside[k, y] holds, else
// from the pre-CDEF plane, filters it horizontally at columns x - 3 ..
// x + 3 clamped to [0, W - 1] (the plain version's edge-replicate
// padding), from 2^(bd + 6), rounds by r0 and clamps to [0, 2^(bd + 1 +
// 7 - r0) - 1]; then sums the 7 rows with the vertical taps from
// -2^(bd + r1 - 1), rounds by r1 and clips to [0, 2^bd - 1].  The plain
// version filters each distinct (plane, source row, unit row) once and
// gathers; recomputing each row a pixel gives the same integers.  Neighbour
// threads read the same rows, so the loads coalesce and hit L1.  Indices
// from the host are clamped to their arrays; on the host's arguments the
// clamps change nothing.  All sums stay inside int32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kTaps = 7;

// The int64 parameter array (ops/kernels/lr.py _PARAMS): the ints, then
// per plane (up to kMaxPlanes) the post-CDEF and pre-CDEF planes
// (pointer, row stride), the output (contiguous [H, W]), H, W, the
// per-pixel unit indices uy [H] and ux [W], the unit taps tv and th [UR,
// UC, 7], the unit flags act [UR, UC] (int32), the source rows vr [7, H]
// (int32), inside [7, H] (bool) and UR, UC; a plane the frame does not
// have is 0 throughout.
enum Param : int {
  P_BD = 0,
  P_NPLANES = 1,
  P_CDEF0 = 2,
  P_CDEF_STRIDE0 = 5,
  P_PRE0 = 8,
  P_PRE_STRIDE0 = 11,
  P_OUT0 = 14,
  P_H0 = 17,
  P_W0 = 20,
  P_UY0 = 23,
  P_UX0 = 26,
  P_TV0 = 29,
  P_TH0 = 32,
  P_ACT0 = 35,
  P_VR0 = 38,
  P_INSIDE0 = 41,
  P_UR0 = 44,
  P_UC0 = 47,
  kParams = 50
};

struct Plane {
  const int32_t* cdef;
  const int32_t* pre;
  int32_t* out;
  const int32_t* uy;
  const int32_t* ux;
  const int32_t* tv;
  const int32_t* th;
  const int32_t* act;
  const int32_t* vr;
  const uint8_t* inside;
  long long cdef_stride, pre_stride, first;
  int h, w, ur, uc;
};

struct Frame {
  Plane p[kMaxPlanes];
  long long total;
  int np, bd;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) wiener_kernel(const Frame a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.total) return;
  int pi = 0;
  while (pi + 1 < a.np && t >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const long long u = t - pl.first;
  const int y = static_cast<int>(u / pl.w);
  const int x = static_cast<int>(u - static_cast<long long>(y) * pl.w);
  const int unit = clampi(pl.uy[y], 0, pl.ur - 1) * pl.uc +
                   clampi(pl.ux[x], 0, pl.uc - 1);
  int32_t& out = pl.out[static_cast<long long>(y) * pl.w + x];
  if (pl.act[unit] == 0) {
    out = pl.cdef[y * pl.cdef_stride + x];
    return;
  }
  const int bd = a.bd;
  const int r0 = bd == 12 ? 5 : 3;
  const int r1 = bd == 12 ? 9 : 11;
  const int lim = (1 << (bd + 1 + 7 - r0)) - 1;
  int th[kTaps], cols[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    th[j] = pl.th[unit * kTaps + j];
    cols[j] = clampi(x + j - 3, 0, pl.w - 1);
  }
  int acc = -(1 << (bd + r1 - 1));
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const long long at = static_cast<long long>(k) * pl.h + y;
    const int row = clampi(pl.vr[at], 0, pl.h - 1);
    const int32_t* src = pl.inside[at] ? pl.cdef + row * pl.cdef_stride
                                       : pl.pre + row * pl.pre_stride;
    int h = 1 << (bd + 6);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) h += th[j] * src[cols[j]];
    h = clampi((h + (1 << (r0 - 1))) >> r0, 0, lim);
    acc += pl.tv[unit * kTaps + k] * h;
  }
  out = clampi((acc + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1);
}

}  // namespace

// Runs the Wiener filter of the `nplanes` planes (1 to kMaxPlanes) in one
// launch on `stream`.  `params`: kParams int64 in Param order.  Returns
// the launch's error code (0: launched).
extern "C" int wiener_frame(const long long* params, int nplanes,
                            void* stream) {
  Frame a = {};
  a.np = nplanes;
  a.bd = static_cast<int>(params[P_BD]);
  if (nplanes < 1 || nplanes > kMaxPlanes || params[P_NPLANES] != nplanes ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  long long total = 0;
  for (int i = 0; i < nplanes; ++i) {
    Plane& pl = a.p[i];
    const long long h = params[P_H0 + i], w = params[P_W0 + i];
    const long long ur = params[P_UR0 + i], uc = params[P_UC0 + i];
    pl.cdef = reinterpret_cast<const int32_t*>(params[P_CDEF0 + i]);
    pl.pre = reinterpret_cast<const int32_t*>(params[P_PRE0 + i]);
    pl.out = reinterpret_cast<int32_t*>(params[P_OUT0 + i]);
    pl.uy = reinterpret_cast<const int32_t*>(params[P_UY0 + i]);
    pl.ux = reinterpret_cast<const int32_t*>(params[P_UX0 + i]);
    pl.tv = reinterpret_cast<const int32_t*>(params[P_TV0 + i]);
    pl.th = reinterpret_cast<const int32_t*>(params[P_TH0 + i]);
    pl.act = reinterpret_cast<const int32_t*>(params[P_ACT0 + i]);
    pl.vr = reinterpret_cast<const int32_t*>(params[P_VR0 + i]);
    pl.inside = reinterpret_cast<const uint8_t*>(params[P_INSIDE0 + i]);
    pl.cdef_stride = params[P_CDEF_STRIDE0 + i];
    pl.pre_stride = params[P_PRE_STRIDE0 + i];
    if (h < 1 || w < 1 || h > (1 << 16) || w > (1 << 16) || ur < 1 ||
        uc < 1 || ur * uc > (1 << 20) || pl.cdef_stride < w ||
        pl.pre_stride < w || !pl.cdef || !pl.pre || !pl.out || !pl.uy ||
        !pl.ux || !pl.tv || !pl.th || !pl.act || !pl.vr || !pl.inside)
      return cudaErrorInvalidValue;
    pl.h = static_cast<int>(h);
    pl.w = static_cast<int>(w);
    pl.ur = static_cast<int>(ur);
    pl.uc = static_cast<int>(uc);
    pl.first = total;
    total += h * w;
  }
  a.total = total;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, wiener_kernel, a);
}
