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
// Design: one thread an output pixel (y, x), x fastest, every plane in the
// one launch.  The host builds, per plane, the 8 source columns of each
// output column (the 64-phase position, its taps centred on it and
// clamped to the source row) and their 8 taps (_superres_args); the
// thread sums src[y, cols[x, j]] * taps[x, j] over j, then Round2 by 7
// (FILTER_BITS) and clips to [0, 2^bd - 1].  Neighbour threads read
// neighbour source columns of one row, which coalesce.  A column index
// is clamped to the source row, which changes nothing on the host's
// tables.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 6;  // the final planes and the pre-CDEF planes
constexpr int kThreads = 256;
constexpr int kTaps = 8;

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
  long long stride, first;
  int w, dw;
};

struct Frame {
  Plane p[kMaxPlanes];
  long long total;
  int np, bd;
};

__global__ void __launch_bounds__(kThreads) superres_kernel(const Frame a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.total) return;
  int pi = 0;
  while (pi + 1 < a.np && t >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const long long u = t - pl.first;
  const int y = static_cast<int>(u / pl.dw);
  const int x = static_cast<int>(u - static_cast<long long>(y) * pl.dw);
  const int32_t* row = pl.src + y * pl.stride;
  int acc = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    int c = pl.cols[x * kTaps + j];
    c = c < 0 ? 0 : (c >= pl.w ? pl.w - 1 : c);
    acc += row[c] * pl.taps[x * kTaps + j];
  }
  const int v = (acc + 64) >> 7;
  const int hi = (1 << a.bd) - 1;
  pl.out[static_cast<long long>(y) * pl.dw + x] = v < 0 ? 0 : (v > hi ? hi : v);
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
  long long total = 0;
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
    pl.w = static_cast<int>(w);
    pl.dw = static_cast<int>(dw);
    pl.first = total;
    total += h * dw;
  }
  a.total = total;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, superres_kernel, a);
}
