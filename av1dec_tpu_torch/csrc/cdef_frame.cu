// CDEF of one frame [SPEC §7.15], every plane in one launch, hand-written
// for Hopper (sm_90a).
//
// Replaces, on the CUDA path of av1dec_tpu_torch:
// - the Pallas plane filter av1dec_tpu/ops/kernels/cdef.py:342
//   (_filter_plane_pallas, body _cdef_tile_kernel at :280);
// - the XLA-compiled direction search (:44 _directions) and the variance
//   gating, damping shifts and per-pixel parameter maps of :139 _cdef_core.
// Its plain version is _cdef_core in av1dec_tpu_torch/ops/kernels/cdef.py;
// the two agree byte for byte.
//
// What bounds it (integer operations) and the design are those of
// cdef_common.cuh, which it shares with cdef_filter.cu: here each block
// owns a 64x64 luma region (8x8 units) and the co-located chroma regions,
// 510 blocks for 1080p, one wave on 132 SMs at 4:2:0 (44 KB of shared
// memory a block), and positions outside a plane read CDEF_VERY_LARGE.

#include "cdef_common.cuh"

namespace {

constexpr int kRows = 64;

__global__ void __launch_bounds__(kThreads)
    cdef_frame_kernel(const CdefArgs a) {
  cdef_region<0, kRows>(a);
}

}  // namespace

// y, u, v: int32 planes with rows `pitch_*` ints apart, base and pitch
// multiples of 16 bytes (u, v null when nplanes == 1); oy, ou, ov:
// contiguous int32 outputs of the same shapes;
// y_pri .. uv_sec: contiguous int32 [H/8, W/8].  H and W are multiples of
// 8; the chroma planes are (H >> suby) x (W >> subx).
extern "C" int cdef_frame(const void* y, const void* u, const void* v,
                          int pitch_y, int pitch_u, int pitch_v, void* oy,
                          void* ou, void* ov, const void* y_pri,
                          const void* y_sec, const void* uv_pri,
                          const void* uv_sec, int H, int W, int nplanes,
                          int bd, int damping, int subx, int suby,
                          void* stream) {
  static size_t allowed[kMaxDevices] = {};
  const CdefArgs a = {{(const int32_t*)y, (const int32_t*)u,
                       (const int32_t*)v},
                      {pitch_y, pitch_u, pitch_v},
                      {(int32_t*)oy, (int32_t*)ou, (int32_t*)ov},
                      {(const int32_t*)y_pri, (const int32_t*)y_sec,
                       (const int32_t*)uv_pri, (const int32_t*)uv_sec},
                      H, W, nplanes, 0, damping, subx, suby};
  return cdef_launch<kRows>(cdef_frame_kernel, allowed, a, bd, stream);
}
