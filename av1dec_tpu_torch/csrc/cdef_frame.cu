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
// Inputs: the int32 planes (luma; U and V unless mono), rows of any pitch,
// and the four per-8x8-luma-unit gated strengths y_pri, y_sec, uv_pri,
// uv_sec as [H/8, W/8] int32.  No per-pixel parameter map exists: each
// block derives a unit's parameters from its four strengths and its
// direction, in shared memory and registers.
//
// What bounds it on the H100: integer operations.  The bytes the function
// must move are the planes in and out (8 bytes a pixel, 24.9 MB for a
// 1080p 4:2:0 frame, 7.4 us at 3.35 TB/s) plus 0.5 MB of strengths.  A
// pixel whose primary and secondary taps are all on costs some 150 int32
// operations; at 64 int32 results per clock per SM (compute capability
// 9.0), 132 SMs and about 1.98 GHz, a 1080p frame of such pixels needs
// about 28 us.  Taps with strength 0 and units with nothing to apply cost
// no operation, so the bound depends on the data.
//
// Design:
// - One block of 256 threads (8 warps) owns a 64x64 luma region (8x8
//   units) and the co-located chroma regions: 510 blocks for 1080p, one
//   wave on 132 SMs at 4:2:0 (47 KB of shared memory a block).
// - The block stages its regions, each with its halo (2 rows, 4 columns
//   on the left so that rows start 16-byte aligned, 2 on the right), in
//   shared memory with 16-byte cp.async copies (the wrapper hands over
//   planes whose base and row pitch are multiples of 16 bytes).
//   Positions outside the plane read CDEF_VERY_LARGE, written by the
//   block itself.  Every input pixel is read from device memory
//   about once (1.1 times with the halos).
// - Direction search, only for units whose luma or chroma primary
//   strength is > 0: the unit's 64 luma values are copied, shifted to
//   8 bits and centred, into a unit-major int16 array, so that a warp
//   reads 32 units' values without bank conflicts.  Warp w computes the
//   partial sums and cost of direction w for 32 units at a time, with
//   the line of each pixel known at compile time (int32 costs: they stay
//   below 2^30).  One thread per unit then takes the first maximum,
//   the variance and every parameter of the unit.
// - Filtering: warp w takes units w, w + 8, ...; each warp works on one
//   unit at a time (its luma, then its U and V together), so the
//   direction, the tap offsets and the strengths are warp-uniform: the
//   tap offsets come from one broadcast constant read, a unit with
//   nothing to apply is a copy, and a tap family with strength 0 is
//   skipped for the whole warp.  The lane-to-pixel mapping (8 rows x 4
//   columns a step) and the row pitches (76 and 44 words, 12 modulo 32)
//   keep the 12 tap reads free of bank conflicts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 30000;  // CDEF_VERY_LARGE
constexpr int kThreads = 256;
constexpr int kRegion = 64;        // luma pixels a block owns, per side
constexpr int kUnits = 64;         // 8x8 luma units a block owns
constexpr int kLumaRows = kRegion + 4;
constexpr int kLumaCols = kRegion + 8;  // 4 left, 2 right, rounded to 4
constexpr int kLumaPitch = 76;          // >= kLumaCols, 12 modulo 32
constexpr int kXsPitch = 66;            // int16 values a unit, 33 words
constexpr int kParams = 12;             // ints a unit

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

struct FrameArgs {
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

// Copy rows [y0, y0 + rows) x columns [x0, x0 + cols) of a plane into
// `tile` (row pitch `tp`), CDEF_VERY_LARGE outside [0, H) x [0, W).  x0,
// cols, W, the pitches and the bases are multiples of 4 ints (16 bytes),
// so a 4-int chunk lies wholly inside or outside the plane.
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

// Line of pixel (i, j) of an 8x8 block along direction D.
template <int D>
__device__ __forceinline__ constexpr int line(int i, int j) {
  return D == 0 ? i + j
       : D == 1 ? i + (j >> 1)
       : D == 2 ? i
       : D == 3 ? 3 + i - (j >> 1)
       : D == 4 ? 7 + i - j
       : D == 5 ? 3 - (i >> 1) + j
       : D == 6 ? j
                : (i >> 1) + j;
}

// Cost of direction D for one unit's 64 centred values (row-major).
template <int D>
__device__ __forceinline__ int dir_cost(const int16_t* xu) {
  int part[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) part[k] = 0;
  const short2* x2 = reinterpret_cast<const short2*>(xu);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const short2 v = x2[(i * 8 + j) >> 1];
      part[line<D>(i, j)] += v.x;
      part[line<D>(i, j + 1)] += v.y;
    }
  }
  int c = 0;
  if (D == 2 || D == 6) {
#pragma unroll
    for (int k = 0; k < 8; ++k) c += part[k] * part[k];
    c *= 105;
  } else if (D == 0 || D == 4) {
#pragma unroll
    for (int k = 0; k < 7; ++k)
      c += (part[k] * part[k] + part[14 - k] * part[14 - k]) * c_div[k];
    c += part[7] * part[7] * 105;
  } else {
#pragma unroll
    for (int k = 3; k < 8; ++k) c += part[k] * part[k];
    c *= 105;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      c += (part[m] * part[m] + part[10 - m] * part[10 - m]) *
           c_div[2 * m + 1];
  }
  return c;
}

__device__ __forceinline__ int unit_cost(int d, const int16_t* xu) {
  switch (d) {  // warp-uniform
    case 0: return dir_cost<0>(xu);
    case 1: return dir_cost<1>(xu);
    case 2: return dir_cost<2>(xu);
    case 3: return dir_cost<3>(xu);
    case 4: return dir_cost<4>(xu);
    case 5: return dir_cost<5>(xu);
    case 6: return dir_cost<6>(xu);
    default: return dir_cost<7>(xu);
  }
}

// floor(log2(max(v, 1))), at most 12: _ilog2 of the plain version
__device__ __forceinline__ int ilog2_12(int v) {
  return v < 2 ? 0 : min(12, 31 - __clz(v));
}

__device__ __forceinline__ int shift_for(int strength, int damping) {
  return max(0, damping - ilog2_12(max(strength, 1)));
}

__device__ __forceinline__ int constrain(int diff, int strength, int shift) {
  const int ad = diff < 0 ? -diff : diff;
  const int m = min(ad, max(strength - (ad >> shift), 0));
  return diff < 0 ? -m : m;
}

__device__ __forceinline__ void tap(int p, int x, int strength, int shift,
                                    int weight, int& total, int& mx,
                                    int& mn) {
  if (p != kVeryLarge) {
    total += weight * constrain(p - x, strength, shift);
    mx = max(mx, p);
    mn = min(mn, p);
  }
}

// Filter one unit of `np` planes (the same parameters for each), ry x rx
// pixels a plane; one warp, every argument but `lane` warp-uniform.
// tileP + t0 is the unit's top-left pixel in plane P's staged tile (row
// pitch tp); outP + o0 the same pixel in the output (row pitch op).
__device__ void filter_unit(const int* tile0, const int* tile1, int tp,
                            int t0, int32_t* out0, int32_t* out1, int op,
                            size_t o0, int np, int lry, int rx, int pri,
                            int sec, int dir, int psh, int ssh,
                            int coeff_shift, int lane) {
  const int ry = 1 << lry, npx = ry * rx;
  const bool apply = pri > 0 || sec > 0;
  const int odd = (pri >> coeff_shift) & 1;
  const int pw0 = odd ? 3 : 4, pw1 = odd ? 3 : 2;
  int po[2], so[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    po[k] = c_dir[dir][k][0] * tp + c_dir[dir][k][1];
    const int d2 = (dir + 2) & 7, d6 = (dir + 6) & 7;
    so[2 * k] = c_dir[d2][k][0] * tp + c_dir[d2][k][1];
    so[2 * k + 1] = c_dir[d6][k][0] * tp + c_dir[d6][k][1];
  }
  for (int q0 = lane; q0 < np * npx; q0 += 32) {
    const int p = q0 >= npx ? 1 : 0;
    const int q = q0 - p * npx;
    // 8 rows x 4 columns a step: conflict-free with a pitch of 12 mod 32
    const int row = (q >> 2) & (ry - 1);
    const int col = (q & 3) + 4 * (q >> (2 + lry));
    const int* t = (p ? tile1 : tile0) + t0 + row * tp + col;
    const int x = t[0];
    int y = x;
    if (apply) {
      int total = 0, mx = x, mn = x;
      if (pri > 0) {
        tap(t[po[0]], x, pri, psh, pw0, total, mx, mn);
        tap(t[-po[0]], x, pri, psh, pw0, total, mx, mn);
        tap(t[po[1]], x, pri, psh, pw1, total, mx, mn);
        tap(t[-po[1]], x, pri, psh, pw1, total, mx, mn);
      }
      if (sec > 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int w = k == 0 ? 2 : 1;
          tap(t[so[2 * k]], x, sec, ssh, w, total, mx, mn);
          tap(t[-so[2 * k]], x, sec, ssh, w, total, mx, mn);
          tap(t[so[2 * k + 1]], x, sec, ssh, w, total, mx, mn);
          tap(t[-so[2 * k + 1]], x, sec, ssh, w, total, mx, mn);
        }
      }
      y = x + ((8 + total - (total < 0 ? 1 : 0)) >> 4);
      y = min(max(y, mn), mx);
    }
    (p ? out1 : out0)[o0 + (size_t)row * op + col] = y;
  }
}

__global__ void __launch_bounds__(kThreads)
    cdef_frame_kernel(const FrameArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x, by = blockIdx.y;
  const bool chroma = a.nplanes > 1;
  const int cw = kRegion >> a.subx, ch = kRegion >> a.suby;
  const int cpitch = cw + 12, crows = ch + 4;  // pitch 12 modulo 32

  int* ty = smem;
  int* tu = ty + kLumaRows * kLumaPitch;
  int* tv = tu + (chroma ? crows * cpitch : 0);
  int* prm = tv + (chroma ? crows * cpitch : 0);
  int* cost = prm + kUnits * kParams;
  int16_t* xs = reinterpret_cast<int16_t*>(cost + kUnits * 8);

  // 1. stage the regions (asynchronous)
  stage(ty, kLumaPitch, kLumaRows, kLumaCols, a.src[0], a.pitch[0], a.H,
        a.W, by * kRegion - 2, bx * kRegion - 4);
  if (chroma) {
    const int Hc = a.H >> a.suby, Wc = a.W >> a.subx;
    for (int p = 1; p < 3; ++p)
      stage(p == 1 ? tu : tv, cpitch, crows, cw + 8, a.src[p], a.pitch[p],
            Hc, Wc, by * ch - 2, bx * cw - 4);
  }

  // 2. the units' strengths, while the copies run
  const int uH = a.H >> 3, uW = a.W >> 3;
  int need = 0;
  if (tid < kUnits) {
    const int gy = by * 8 + (tid >> 3), gx = bx * 8 + (tid & 7);
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
  cp_async_wait_all();
  const int any_need = __syncthreads_or(need);

  // 3. direction search of the units that need it
  if (any_need) {
    for (int i = tid; i < kRegion * kRegion; i += kThreads) {
      const int r = i >> 6, c = i & 63;
      const int u = (r >> 3) * 8 + (c >> 3);
      const int v = ty[(r + 2) * kLumaPitch + c + 4];
      xs[u * kXsPitch + (r & 7) * 8 + (c & 7)] =
          static_cast<int16_t>((v >> a.coeff_shift) - 128);
    }
    __syncthreads();
    for (int u = lane; u < kUnits; u += 32)
      if (prm[u * kParams + P_NEED])
        cost[u * 8 + warp] = unit_cost(warp, xs + u * kXsPitch);
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

  // 5. filter, one unit a warp at a time
  const int cry = 8 >> a.suby, crx = 8 >> a.subx;
  const int Wc = a.W >> a.subx;
  for (int u = warp; u < kUnits; u += kThreads / 32) {
    const int* p = prm + u * kParams;
    if (!p[P_VALID]) continue;
    const int uy = u >> 3, ux = u & 7;
    filter_unit(ty, ty, kLumaPitch, (2 + 8 * uy) * kLumaPitch + 4 + 8 * ux,
                a.dst[0], a.dst[0], a.W,
                (size_t)(by * kRegion + 8 * uy) * a.W + bx * kRegion + 8 * ux,
                1, 3, 8, p[P_YPRI], p[P_YSEC], p[P_YDIR], p[P_YPSH],
                p[P_YSSH], a.coeff_shift, lane);
    if (chroma)
      filter_unit(tu, tv, cpitch, (2 + cry * uy) * cpitch + 4 + crx * ux,
                  a.dst[1], a.dst[2], Wc,
                  (size_t)(by * ch + cry * uy) * Wc + bx * cw + crx * ux, 2,
                  3 - a.suby, crx, p[P_CPRI], p[P_CSEC], p[P_CDIR],
                  p[P_CPSH], p[P_CSSH], a.coeff_shift, lane);
  }
}

size_t smem_bytes(int nplanes, int subx, int suby) {
  size_t ints = kLumaRows * kLumaPitch + kUnits * kParams + kUnits * 8 +
                kUnits * kXsPitch / 2;
  if (nplanes > 1)
    ints += 2 * (size_t)((kRegion >> suby) + 4) * ((kRegion >> subx) + 12);
  return ints * sizeof(int);
}

bool aligned16(const void* p, int pitch) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (pitch & 3) == 0;
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
  if (H <= 0 || W <= 0) return 0;
  if ((H & 7) || (W & 7) || (nplanes != 1 && nplanes != 3) || subx < 0 ||
      subx > 1 || suby < 0 || suby > 1)
    return (int)cudaErrorInvalidValue;
  FrameArgs a;
  a.src[0] = (const int32_t*)y;
  a.src[1] = (const int32_t*)u;
  a.src[2] = (const int32_t*)v;
  a.pitch[0] = pitch_y;
  a.pitch[1] = pitch_u;
  a.pitch[2] = pitch_v;
  a.dst[0] = (int32_t*)oy;
  a.dst[1] = (int32_t*)ou;
  a.dst[2] = (int32_t*)ov;
  a.gate[0] = (const int32_t*)y_pri;
  a.gate[1] = (const int32_t*)y_sec;
  a.gate[2] = (const int32_t*)uv_pri;
  a.gate[3] = (const int32_t*)uv_sec;
  a.H = H;
  a.W = W;
  a.nplanes = nplanes;
  a.coeff_shift = bd - 8;
  a.damping = damping;
  a.subx = nplanes > 1 ? subx : 0;
  a.suby = nplanes > 1 ? suby : 0;
  if (!aligned16(y, pitch_y) ||
      (nplanes > 1 && (!aligned16(u, pitch_u) || !aligned16(v, pitch_v))))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(nplanes, a.subx, a.suby);
  // raise the block's shared-memory limit once per device and size, so
  // that a warm launch makes no call but the launch itself
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(cdef_frame_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  dim3 grid((W + kRegion - 1) / kRegion, (H + kRegion - 1) / kRegion);
  cdef_frame_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
