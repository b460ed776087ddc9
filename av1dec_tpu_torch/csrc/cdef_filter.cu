// CDEF of one column shard of a frame [SPEC §7.15], every plane in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces, on the column-sharded paths of av1dec_tpu_torch
// (parallel/sharded_cdef.py: cdef_sharded across ranks, cdef_local over
// the cards of a process):
// - the Pallas plane filter av1dec_tpu/ops/kernels/cdef.py:342
//   (_filter_plane_pallas, body _cdef_tile_kernel at :280), which the
//   JAX package's sharded CDEF runs on a bordered copy of each plane;
// - the XLA-compiled direction search (:44 _directions) and the variance
//   gating, damping shifts and per-pixel parameter maps of :139 _cdef_core.
// Its plain version is _cdef_shard_core in
// av1dec_tpu_torch/ops/kernels/cdef.py (_cdef_core of the shard's planes,
// every tap read from their bordered copies); the two agree byte for byte.
//
// What bounds it on the H100: integer operations, as for a frame
// (cdef_common.cuh): the bytes are the bordered copies in, the planes out
// and the strengths, about 8 bytes a pixel.  A shard is a half or a
// quarter of a frame, and the blocks of a launch run in one wave, a few
// to an SM, whose busiest SM sets the time: with the frame's 64x64
// regions a 1080p quarter shard is 136 blocks, one SM in 33 gets two and
// every other SM holds 8 warps.  Here a block owns 64 luma columns and
// 32 or 24 rows, whichever leaves the busiest SM fewer rows (a 1080p half
// shard: 510 blocks of 32 rows; a quarter: 360 of 24, 3 on an SM at
// most).
//
// The design is cdef_frame.cu's, from the one source cdef_common.cuh; a
// block's out-of-shard columns come from the bordered copy (the
// neighbouring shards' pixels, or CDEF_VERY_LARGE at the frame's edges)
// instead of CDEF_VERY_LARGE.  A bordered copy's column 0 is the plane's
// column -2, so its rows start 16-byte aligned 2 columns left of a
// region without the 2 extra columns a plane needs.

#include "cdef_common.cuh"

namespace {

// luma rows a block owns: either, as `rows_for` picks
constexpr int kRowsA = 32, kRowsB = 24;

template <int kRows>
__global__ void __launch_bounds__(kThreads)
    cdef_shard_kernel(const CdefArgs a) {
  cdef_region<2, kRows>(a);
}

// The blocks of a launch run in one wave (a few per SM), so the busiest
// SM sets its time: take the rows a block owns whose busiest SM, with the
// blocks spread evenly, has the fewer rows (kRowsA on a tie).
int rows_for(int H, int W, int sms) {
  const int cols = (W + kRegionW - 1) / kRegionW;
  auto busiest = [&](int rows) {
    const int blocks = cols * ((H + rows - 1) / rows);
    return rows * ((blocks + sms - 1) / sms);
  };
  return busiest(kRowsB) < busiest(kRowsA) ? kRowsB : kRowsA;
}

}  // namespace

// y, u, v: contiguous int32 bordered copies [Hp + 4, Wp + 4] of the
// shard's planes (Hp x Wp: H x W for luma, (H >> suby) x (W >> subx) for
// chroma), bases multiples of 16 bytes (u, v null when nplanes == 1);
// oy, ou, ov: contiguous int32 outputs [Hp, Wp]; y_pri .. uv_sec:
// contiguous int32 [H/8, W/8].  H and W are multiples of 8.
extern "C" int cdef_shard(const void* y, const void* u, const void* v,
                          void* oy, void* ou, void* ov, const void* y_pri,
                          const void* y_sec, const void* uv_pri,
                          const void* uv_sec, int H, int W, int nplanes,
                          int bd, int damping, int subx, int suby,
                          void* stream) {
  static size_t allowed_a[kMaxDevices] = {}, allowed_b[kMaxDevices] = {};
  const int cw = nplanes > 1 ? (W >> subx) + 4 : 0;
  const CdefArgs a = {{(const int32_t*)y, (const int32_t*)u,
                       (const int32_t*)v},
                      {W + 4, cw, cw},
                      {(int32_t*)oy, (int32_t*)ou, (int32_t*)ov},
                      {(const int32_t*)y_pri, (const int32_t*)y_sec,
                       (const int32_t*)uv_pri, (const int32_t*)uv_sec},
                      H, W, nplanes, 0, damping, subx, suby};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (rows_for(H, W, sms) == kRowsB)
    return cdef_launch<kRowsB>(cdef_shard_kernel<kRowsB>, allowed_b, a, bd,
                               stream);
  return cdef_launch<kRowsA>(cdef_shard_kernel<kRowsA>, allowed_a, a, bd,
                             stream);
}
