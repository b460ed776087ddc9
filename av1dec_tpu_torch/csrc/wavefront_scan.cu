// One wavefront level of the intra reconstruction scan [SPEC §7.11.2],
// hand-written for Hopper (sm_90a).
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled window
// scan of the JAX package: av1dec_tpu/ops/kernels/wavefront.py:343
// (_apply_bucket, under lax.scan in run_wavefront_chunk :465).  Its plain
// version is _scan_plain in av1dec_tpu_torch/ops/kernels/wavefront.py (the
// eager window loop over _apply_bucket); the two agree byte for byte.
//
// What bounds it: the chain of levels.  A level holds tens of lanes (one
// transform block each); every lane's prediction reads pixels written at
// strictly earlier levels (pipeline/wavefront.py), so the lanes of one
// level, across all shape buckets, are independent, and one launch runs
// them all.  The bytes (lane rows, residuals, palettes, the frame written
// once) and the integer operations are far below what a few hundred
// dependent launches cost; the launch chain sets the time.
//
// Design: one thread block per lane.  The block gathers the lane's
// above/left edges and corner into shared memory with the clamps of
// _gather_edges, computes only its own mode family (the plain version
// computes every cheap family and selects), adds the residual, clips and
// writes its w x h pixels; nothing else of the frame is written.
// Filter-intra runs its 4x2 patches in anti-diagonal order in a shared
// (w+1) x (h+1) buffer (a patch reads only its left, above and above-left
// patches, so the patches of one diagonal are independent).  Every index
// is clamped as the plain version clamps it, so the kept pixels read the
// same values.  A left shift of a value that may be negative is written as
// a multiply (undefined in C++17); >> on signed ints is arithmetic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Lane row fields, in _DEV_FIELDS order (ops/kernels/wavefront.py).
enum Field : int {
  F_X = 0,
  F_Y = 1,
  F_PLANE = 2,
  F_BASE = 3,
  F_STRIDE = 4,
  F_MODE_FAMILY = 5,
  F_P_ANGLE = 6,
  F_ABOVE_CASE = 7,
  F_ABOVE_LIM = 8,
  F_LEFT_CASE = 9,
  F_LEFT_LIM = 10,
  F_CORNER_CASE = 11,
  F_STR_ABOVE = 12,
  F_STR_LEFT = 13,
  F_UP_ABOVE = 14,
  F_UP_LEFT = 15,
  F_NPX_ABOVE = 16,
  F_NPX_LEFT = 17,
  F_CORNER_FILT = 18,
  F_DX = 19,
  F_DY = 20,
  F_HAVE_ABOVE = 21,
  F_HAVE_LEFT = 22,
  F_RES_IDX = 23,
  F_PAL_IDX = 24,
  F_FI_MODE = 25,
  F_CFL_ALPHA = 26,
  F_CFL_MAXX = 27,
  F_CFL_MAXY = 28,
  F_DC_CASE = 29,
  F_W = 30,
  F_H = 31,
  F_LW = 32,
  F_LH = 33,
  F_LBASE = 34,
  kFields = 35
};

// Mode families (pipeline/wavefront.py MF_*).
enum ModeFamily : int {
  MF_DC = 0,
  MF_V = 1,
  MF_H = 2,
  MF_DIR = 3,
  MF_SMOOTH = 4,
  MF_SMOOTH_V = 5,
  MF_SMOOTH_H = 6,
  MF_PAETH = 7,
  MF_PAL = 8,
  MF_FI = 9,
  MF_INTER = 10
};

// The wrapper's int64 parameter array, in _PARAMS order
// (ops/kernels/wavefront.py): pointers, then ints.
enum Param : int {
  P_FRAME = 0,
  P_RES = 1,
  P_ROWS0 = 2,
  P_ROWS1 = 3,
  P_ROWS2 = 4,
  P_PAL0 = 5,
  P_PAL1 = 6,
  P_PAL2 = 7,
  P_LEVELS = 8,
  P_KERN = 9,
  P_SM = 10,
  P_FI_TAPS = 11,
  P_N = 12,
  P_RES_LEN = 13,
  P_RES_BYTES = 14,
  P_SM_LEN = 15,
  P_NB = 16,
  P_T0 = 17,
  P_T1 = 18,
  P_T2 = 19,
  P_BD = 20,
  P_SUB_X = 21,
  P_SUB_Y = 22,
  P_EEF = 23,
  kParams = 24
};

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 3;
constexpr int kMaxT = 64;
constexpr int kEdge = 2 * kMaxT + 1;  // corner + 2T edge pixels
constexpr int kLut = 4 * kMaxT + 3;   // directional LUT, indices 0..4T+2
constexpr int kFiBuf = 33 * 33;       // filter-intra blocks are <= 32x32

struct ScanArgs {
  int32_t* frame;  // [n + 1]; slot n is the plain version's trash slot
  const void* res;
  const int32_t* rows[kMaxBuckets];  // [N_b, kFields]
  const int32_t* pal[kMaxBuckets];   // [P_b, T_b, T_b]
  const int32_t* levels;             // [L, nb, 2]: (start, count)
  const int32_t* kern;               // [4, 5]
  const int32_t* sm;                 // [sm_len]
  const int32_t* fi_taps;            // [5, 8, 7]
  int n, res_len, sm_len, nb;
  int ts[kMaxBuckets];
  int bd, sub_x, sub_y, eef;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Sum of v over the block; every thread gets it.  `red` holds
// kThreads / 32 + 1 ints.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int k = 0; k < kThreads / 32; ++k) s += red[k];
    red[kThreads / 32] = s;
  }
  __syncthreads();
  const int s = red[kThreads / 32];
  __syncthreads();
  return s;
}

// Intra edge filter of one edge pixel [SPEC §7.11.2.12] (_edge_filter):
// reads the unfiltered edge e (2T + 1 pixels).
__device__ __forceinline__ int edge_filter_px(const int* e, int i, int npx,
                                              int strength, int last,
                                              const int32_t* kern) {
  if (!(strength > 0 && i >= 1 && i < npx)) return e[i];
  const int* kv = kern + 5 * clampi(strength, 0, 3);
  const int hi = min(max(npx, 1) - 1, last);
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) acc += kv[j] * e[min(max(i - 2 + j, 0), hi)];
  return (acc + 8) >> 4;
}

// Entry k of the directional LUT of one edge (_dir_lut over _upsample):
// e is the (filtered) edge of 2T + 1 pixels, npx its upsample extent.
__device__ __forceinline__ int lut_entry(const int* e, int k, int T, int up,
                                         int npx, int maxv) {
  const int size = 2 * T;
  if (up <= 0) return e[clampi(k - 1, 0, size)];
  if (k >= 2 * npx + 2) return e[min(npx + 1, size)];
  const int kk = min(k, 2 * size + 1);
  // inb(m) = e[min(max(m - 1, 0), npx)]
  auto inb = [&](int m) { return e[min(max(m - 1, 0), npx)]; };
  if (kk == 0) return inb(0);
  if (kk == 2 * size + 1) return 0;
  if (kk & 1) {
    const int i = kk >> 1;
    const int s = -inb(i) + 9 * inb(i + 1) + 9 * inb(i + 2) - inb(i + 3);
    return clampi((s + 8) >> 4, 0, maxv);
  }
  return inb((kk >> 1) + 1);
}

// Directional prediction of pixel (i, j) [SPEC §7.11.2.4] (_predict_dir).
__device__ __forceinline__ int dir_px(const int* lutA, const int* lutL,
                                      int i, int j, int w, int h, int T,
                                      int p_angle, int dx, int dy, int ua,
                                      int ul) {
  const int lutmax = 4 * T + 2;
  const int size_l = w + h;
  auto lerp = [&](const int* lut, int b, int shift) {
    return lut[clampi(b + 2, 0, lutmax)] * (32 - shift) +
           lut[clampi(b + 3, 0, lutmax)] * shift;
  };
  if (p_angle < 90) {
    const int idx1 = (i + 1) * dx;
    const int base1 = (idx1 >> (6 - ua)) + j * (1 << ua);
    const int max_base_x = (size_l - 1) * (1 << ua);
    const int shift1 = ((idx1 * (1 << ua)) >> 1) & 0x1F;
    if (base1 < max_base_x)
      return (lerp(lutA, min(base1, max_base_x), shift1) + 16) >> 5;
    return lutA[min(max_base_x + 2, lutmax)];
  }
  if (p_angle < 180) {
    const int idx2 = j * 64 - (i + 1) * dx;
    const int base2 = idx2 >> (6 - ua);
    if (base2 >= -(1 << ua)) {
      const int shift2 = ((idx2 * (1 << ua)) >> 1) & 0x1F;
      return (lerp(lutA, min(max(base2, -2), size_l * 2), shift2) + 16) >>
             5;
    }
    const int idx2l = i * 64 - (j + 1) * dy;
    const int base2l = idx2l >> (6 - ul);
    const int shift2l = ((idx2l * (1 << ul)) >> 1) & 0x1F;
    return (lerp(lutL, min(max(base2l, -2), size_l * 2), shift2l) + 16) >> 5;
  }
  const int idx3 = (j + 1) * dy;
  const int base3 = (idx3 >> (6 - ul)) + i * (1 << ul);
  const int max_base_y = (size_l - 1) * (1 << ul);
  const int shift3 = ((idx3 * (1 << ul)) >> 1) & 0x1F;
  if (base3 < max_base_y)
    return (lerp(lutL, min(base3, max_base_y), shift3) + 16) >> 5;
  return lutL[min(max_base_y + 2, lutmax)];
}

template <typename Res>
__global__ void __launch_bounds__(kThreads)
    wavefront_level_kernel(const ScanArgs a, int level) {
  __shared__ int row[kFields];
  __shared__ int above[kEdge], left[kEdge];
  __shared__ int filt[2][kEdge];
  __shared__ int lut[2][kLut];
  __shared__ int fibuf[kFiBuf];
  __shared__ int red[kThreads / 32 + 1];
  __shared__ int dc_sum[2];
  __shared__ int corner_v;

  const int tid = threadIdx.x;
  // this block's lane: buckets in order, each its run of the level
  const int32_t* lv = a.levels + level * a.nb * 2;
  int b = blockIdx.x, bucket = 0;
  for (; bucket < a.nb - 1; ++bucket) {
    const int c = lv[2 * bucket + 1];
    if (b < c) break;
    b -= c;
  }
  const int T = a.ts[bucket];
  const int32_t* src = a.rows[bucket] + (size_t)(lv[2 * bucket] + b) * kFields;
  if (tid < kFields) row[tid] = src[tid];
  __syncthreads();

  int32_t* frame = a.frame;
  const int n = a.n, bd = a.bd;
  const int maxv = (1 << bd) - 1;
  const int x = row[F_X], y = row[F_Y];
  const int base = row[F_BASE], stride = row[F_STRIDE];
  const int mf = row[F_MODE_FAMILY];
  const int w = row[F_W], h = row[F_H], lw = row[F_LW];
  auto at = [&](int idx) { return frame[clampi(idx, 0, n - 1)]; };

  // edges: AboveRow / LeftCol with the corner at index 0 (_gather_edges)
  const int size = 2 * T;
  if (mf != MF_INTER && mf != MF_PAL) {
    const int above_case = row[F_ABOVE_CASE], left_case = row[F_LEFT_CASE];
    const int above_lim = row[F_ABOVE_LIM], left_lim = row[F_LEFT_LIM];
    for (int k = tid; k < 2 * size; k += kThreads) {
      if (k < size) {
        int v;
        if (above_case == 2) {
          v = (1 << (bd - 1)) - 1;
        } else {
          const int idx = above_case == 1
                              ? base + y * stride + (x - 1)
                              : base + (y - 1) * stride + min(x + k, above_lim);
          v = at(idx);
        }
        above[1 + k] = v;
      } else {
        const int i = k - size;
        int v;
        if (left_case == 2) {
          v = (1 << (bd - 1)) + 1;
        } else {
          const int idx = left_case == 1
                              ? base + (y - 1) * stride + x
                              : base + min(y + i, left_lim) * stride + (x - 1);
          v = at(idx);
        }
        left[1 + i] = v;
      }
    }
    if (tid == 0) {
      const int cc = row[F_CORNER_CASE];
      int corner;
      if (cc == 3) {
        corner = 1 << (bd - 1);
      } else {
        const int idx = cc == 0   ? base + (y - 1) * stride + (x - 1)
                        : cc == 1 ? base + (y - 1) * stride + x
                                  : base + y * stride + (x - 1);
        corner = at(idx);
      }
      above[0] = corner;
      left[0] = corner;
    }
    __syncthreads();
  }

  // per-family set-up; pred(i, j) below reads what it leaves
  int dc = 0, cfl_avg = 0;
  const bool cfl = mf == MF_DC && row[F_CFL_MAXX] > 0;
  const int* eA = above;
  const int* eL = left;
  if (mf == MF_DC) {
    // masked sums of above[1..w] and left[1..h]
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
      const int* e = warp ? left : above;
      const int cnt = warp ? h : w;
      int s = 0;
      for (int k = lane; k < cnt; k += 32) s += e[1 + k];
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) dc_sum[warp] = s;
    }
    __syncthreads();
    const int s_a = dc_sum[0], s_l = dc_sum[1];
    const int dc_case = row[F_DC_CASE];
    const int size_l = w + h;
    dc = dc_case == 0   ? (s_a + s_l + (size_l >> 1)) / size_l
         : dc_case == 1 ? (s_a + (w >> 1)) >> row[F_LW]
         : dc_case == 2 ? (s_l + (h >> 1)) >> row[F_LH]
                        : 1 << (bd - 1);
  } else if (mf == MF_DIR) {
    if (a.eef) {
      // corner filter, then the edge filter of both edges
      if (tid == 0) {
        corner_v = row[F_CORNER_FILT] > 0
                       ? (left[1] * 5 + above[0] * 6 + above[1] * 5 + 8) >> 4
                       : above[0];
        above[0] = corner_v;
        left[0] = corner_v;
      }
      __syncthreads();
      for (int k = tid; k < 2 * (size + 1); k += kThreads) {
        const int side = k > size;
        const int i = side ? k - size - 1 : k;
        filt[side][i] =
            side ? edge_filter_px(left, i, row[F_NPX_LEFT], row[F_STR_LEFT],
                                  size, a.kern)
                 : edge_filter_px(above, i, row[F_NPX_ABOVE],
                                  row[F_STR_ABOVE], size, a.kern);
      }
      __syncthreads();
      eA = filt[0];
      eL = filt[1];
    }
    const int p_angle = row[F_P_ANGLE];
    const int npx_a = w + (p_angle < 90 ? h : 0);
    const int npx_l = h + (p_angle > 180 ? w : 0);
    const int lutlen = 4 * T + 3;
    for (int k = tid; k < 2 * lutlen; k += kThreads) {
      const int side = k >= lutlen;
      const int kk = side ? k - lutlen : k;
      lut[side][kk] = side ? lut_entry(eL, kk, T, row[F_UP_LEFT], npx_l, maxv)
                           : lut_entry(eA, kk, T, row[F_UP_ABOVE], npx_a, maxv);
    }
    __syncthreads();
  } else if (mf == MF_FI) {
    // serial 4x2 patch recursion [SPEC §7.11.2.3], by anti-diagonals
    const int W1 = w + 1;
    for (int k = tid; k < (h + 1) * W1; k += kThreads) {
      const int r = k / W1, c = k - r * W1;
      fibuf[k] = r == 0 ? above[c] : c == 0 ? left[r] : 0;
    }
    __syncthreads();
    const int nc = w >> 2, nr = h >> 1;
    const int32_t* tv = a.fi_taps + 56 * clampi(row[F_FI_MODE], 0, 4);
    for (int d = 0; d < nr + nc - 1; ++d) {
      for (int t = tid; t < nc * 8; t += kThreads) {
        const int sj = t >> 3, k = t & 7, si = d - sj;
        if (si < 0 || si >= nr) continue;
        const int i = 1 + 2 * si, j = 1 + 4 * sj;
        const int o = (i - 1) * W1 + (j - 1);
        const int pv[7] = {fibuf[o],     fibuf[o + 1],  fibuf[o + 2],
                           fibuf[o + 3], fibuf[o + 4],  fibuf[o + W1],
                           fibuf[o + 2 * W1]};
        int s = 0;
#pragma unroll
        for (int m = 0; m < 7; ++m) s += tv[k * 7 + m] * pv[m];
        const int v = s >= 0 ? (s + 8) >> 4 : -((-s + 8) >> 4);
        fibuf[i * W1 + j + (k & 3) + (k >> 2) * W1] = clampi(v, 0, maxv);
      }
      __syncthreads();
    }
  }

  // CfL [SPEC §7.11.5] (_cfl_adjust): subsampled co-located luma
  const int sub_x = a.sub_x, sub_y = a.sub_y;
  const int lstride = stride << sub_x;
  auto cfl_t = [&](int i, int j) {
    const int ly = min((y + i) << sub_y, row[F_CFL_MAXY]);
    const int lx = min((x + j) << sub_x, row[F_CFL_MAXX]);
    const int bb = max(row[F_LBASE] + ly * lstride + lx, 0);
    auto lat = [&](int idx) { return frame[min(idx, n - 1)]; };
    if (sub_x && sub_y)
      return (lat(bb) + lat(bb + 1) + lat(bb + lstride) +
              lat(bb + lstride + 1))
             << 1;
    if (sub_x) return (lat(bb) + lat(bb + 1)) << 2;
    return lat(bb) << 3;
  };
  const int npix = w * h;
  if (cfl) {
    int s = 0;
    for (int p = tid; p < npix; p += kThreads) s += cfl_t(p >> lw, p & (w - 1));
    const int tot = block_sum(s, red);
    const int shift = row[F_LW] + row[F_LH];
    cfl_avg = (tot + (1 << max(shift - 1, 0))) >> shift;
  }

  // predict, add the residual, clip, write the w x h pixels
  const int res_idx = row[F_RES_IDX];
  const int sm_top = a.sm_len - 1;
  for (int p = tid; p < npix; p += kThreads) {
    const int i = p >> lw, j = p & (w - 1);
    const int fidx = base + (y + i) * stride + x + j;
    int v;
    switch (mf) {
      case MF_DC:
        v = dc;
        if (cfl) {
          const int sc = row[F_CFL_ALPHA] * (cfl_t(i, j) - cfl_avg);
          const int scaled = sc >= 0 ? (sc + 32) >> 6 : -((-sc + 32) >> 6);
          v = clampi(v + scaled, 0, maxv);
        }
        break;
      case MF_V:
        v = above[1 + j];
        break;
      case MF_H:
        v = left[1 + i];
        break;
      case MF_PAETH: {
        const int av = above[1 + j], lv2 = left[1 + i], tl = above[0];
        const int pb = av + lv2 - tl;
        const int pa = abs(pb - av), pl = abs(pb - lv2), ptl = abs(pb - tl);
        v = (pa <= pl && pa <= ptl) ? av : (pl <= ptl ? lv2 : tl);
        break;
      }
      case MF_DIR:
        v = dir_px(lut[0], lut[1], i, j, w, h, T, row[F_P_ANGLE], row[F_DX],
                   row[F_DY], row[F_UP_ABOVE], row[F_UP_LEFT]);
        break;
      case MF_PAL:
        v = a.pal[bucket][(size_t)max(row[F_PAL_IDX], 0) * T * T + i * T +
                          j];
        break;
      case MF_FI:
        v = fibuf[(i + 1) * (w + 1) + (j + 1)];
        break;
      case MF_INTER:
        // the MC pass wrote this block's prediction into the frame
        v = at(fidx);
        break;
      default: {
        // the smooth modes [SPEC §7.11.2.6] (_smooth_all)
        const int sw_w = a.sm[clampi(w + j, 0, sm_top)];
        const int sw_h = a.sm[clampi(h + i, 0, sm_top)];
        const int av = above[1 + j], lv2 = left[1 + i];
        const int right = above[w], bottom = left[h];
        if (mf == MF_SMOOTH)
          v = (sw_h * av + (256 - sw_h) * bottom + sw_w * lv2 +
               (256 - sw_w) * right + 256) >>
              9;
        else if (mf == MF_SMOOTH_V)
          v = (sw_h * av + (256 - sw_h) * bottom + 128) >> 8;
        else
          v = (sw_w * lv2 + (256 - sw_w) * right + 128) >> 8;
      }
    }
    if (res_idx >= 0) {
      const int r = static_cast<int>(static_cast<const Res*>(
          a.res)[clampi(res_idx + i * w + j, 0, a.res_len - 1)]);
      v = clampi(v + r, 0, maxv);
    }
    if (fidx >= 0 && fidx < n) frame[fidx] = v;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Launches the lanes of wavefront level `level` (`lanes` of them, all
// buckets) on `stream`.  `params`: kParams int64 in Param order.  Returns
// cudaGetLastError() after the launch.
extern "C" int wavefront_level(const long long* params, int level, int lanes,
                               void* stream) {
  ScanArgs a;
  a.frame = reinterpret_cast<int32_t*>(params[P_FRAME]);
  a.res = reinterpret_cast<const void*>(params[P_RES]);
  for (int k = 0; k < kMaxBuckets; ++k) {
    a.rows[k] = reinterpret_cast<const int32_t*>(params[P_ROWS0 + k]);
    a.pal[k] = reinterpret_cast<const int32_t*>(params[P_PAL0 + k]);
    a.ts[k] = static_cast<int>(params[P_T0 + k]);
  }
  a.levels = reinterpret_cast<const int32_t*>(params[P_LEVELS]);
  a.kern = reinterpret_cast<const int32_t*>(params[P_KERN]);
  a.sm = reinterpret_cast<const int32_t*>(params[P_SM]);
  a.fi_taps = reinterpret_cast<const int32_t*>(params[P_FI_TAPS]);
  a.n = static_cast<int>(params[P_N]);
  a.res_len = static_cast<int>(params[P_RES_LEN]);
  a.sm_len = static_cast<int>(params[P_SM_LEN]);
  a.nb = static_cast<int>(params[P_NB]);
  a.bd = static_cast<int>(params[P_BD]);
  a.sub_x = static_cast<int>(params[P_SUB_X]);
  a.sub_y = static_cast<int>(params[P_SUB_Y]);
  a.eef = static_cast<int>(params[P_EEF]);
  if (lanes <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (params[P_RES_BYTES] == 2)
    wavefront_level_kernel<int16_t><<<lanes, kThreads, 0, s>>>(a, level);
  else if (params[P_RES_BYTES] == 4)
    wavefront_level_kernel<int32_t><<<lanes, kThreads, 0, s>>>(a, level);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// Launches `count` empty kernels back to back on `stream`: what one link
// of a chain of dependent launches costs the card, the floor a level
// pays (the chain term of the scan's bound).  Returns cudaGetLastError().
extern "C" int wavefront_empty_launches(int count, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < count; ++k) empty_kernel<<<1, 32, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
