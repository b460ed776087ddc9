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
// that cross a stripe boundary.  The filter is 49 multiply-adds a pixel
// as the spec writes it, 14 when each filtered row is computed once.
//
// Design: a block owns a kTileH x kTileW tile of output pixels of one
// plane, every plane of the frame in the one launch (a table of first
// blocks maps a block to its plane and tile).  The block reads its rows'
// unit rows uy and their 7 x kTileH (vr, inside) entries and forms the
// distinct keys (source row, post- or pre-CDEF, unit row of the output
// row) in a shared hash table (each entry inserts its key with a
// compare-and-swap; the threads that insert a key number it, one shared
// atomic add a warp): kTileH + 6
// inside one stripe and one unit row, at most 7 x kTileH on any arguments
// the wrapper takes.  It takes the keys kChunk at a time (one chunk
// inside a stripe): it loads each key's row segment [x0 - 3, x0 + kTileW
// + 3), clamped to [0, W - 1] (the plain version's edge-replicate
// padding), once, in row loads with kBatch loads in flight a thread, into
// shared memory as int16 (pixels have at most 12 bits); filters it
// horizontally once a column with that column's unit taps for the key's
// unit row, from 2^(bd + 6), rounds by r0 and clamps to [0, 2^(bd + 1 +
// 7 - r0) - 1] (at most 2^15 - 1, so int16 holds it), into shared
// memory; then each output pixel adds the chunk's rows among its 7 with
// its unit's vertical taps to a sum in registers that starts at -2^(bd +
// r1 - 1).  Last, each pixel rounds by r1 and clips to [0, 2^bd - 1], or,
// in a unit that is off (or the sentinel row and column past the crop),
// copies the post-CDEF pixel.  A thread owns one column of the tile
// (kTileH / 4 of its rows), so its unit column and, while the unit row
// stays, its taps stay in registers.  This is the plain version's
// computation (each distinct (plane, source row, unit row) filtered once,
// then gathered) on the tile's keys.  Indices from the host are clamped
// to their arrays; on the host's arguments the clamps change nothing.
// All sums stay inside int32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kTaps = 7;
// output pixels a block; a thread owns a column and kTileH / kRowStep of
// its rows
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kRowStep = kThreads / kTileW;
constexpr int kOwned = kTileH / kRowStep;
// (tap, row) entries of a tile: the most keys it can have
constexpr int kEntries = kTaps * kTileH;
// keys whose rows are in shared memory at once, and a key's staged row
// segment: the tile's columns and 3 on each side
constexpr int kChunk = 64;
constexpr int kSegW = kTileW + kTaps - 1;
// the hash table of keys (a power of two, at least twice kEntries)
constexpr int kTableBits = 9;
constexpr int kTable = 1 << kTableBits;
constexpr unsigned long long kEmpty = ~0ull;
// staged loads in flight a thread
constexpr int kBatch = 6;
static_assert(kEntries <= kThreads && kThreads % kTileW == 0 &&
                  kTileH % kRowStep == 0 && kTable >= 2 * kEntries,
              "an entry a thread; whole columns; a sparse table");

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
  long long cdef_stride, pre_stride;
  int h, w, ur, uc;
  int tiles_x, first;  // tiles a row of the plane, its first block
};

struct Frame {
  Plane p[kMaxPlanes];
  int np, bd;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) wiener_kernel(const Frame a) {
  // the hash table: a key (unit row << 18 | from the pre-CDEF plane << 17
  // | source row), or kEmpty, and its number
  __shared__ unsigned long long table[kTable];
  __shared__ int16_t table_key[kTable];
  // entry k * kTileH + r (tap k of tile row r): its place in the table,
  // then its key's number (-1 past the plane)
  __shared__ int16_t place[kEntries], key_of[kEntries];
  // per key: source row, unit row, whether from the pre-CDEF plane
  __shared__ int krow[kEntries], kur[kEntries];
  __shared__ uint8_t kpre[kEntries];
  __shared__ int uyc[kTileH], uxc[kTileW], nkeys;
  // per key of a chunk: its row segment, then its horizontally filtered
  // row
  __shared__ int16_t seg[kChunk * kSegW];
  __shared__ int16_t hf[kChunk * kTileW];

  const int b = blockIdx.x;
  int pi = 0;
  while (pi + 1 < a.np && b >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const int tile = b - pl.first;
  const int ty = tile / pl.tiles_x;
  const int y0 = ty * kTileH, x0 = (tile - ty * pl.tiles_x) * kTileW;
  const int rows = min(kTileH, pl.h - y0), cols = min(kTileW, pl.w - x0);
  const int t = threadIdx.x;

  for (int i = t; i < kTable; i += kThreads) table[i] = kEmpty;
  if (t < kTileH) uyc[t] = t < rows ? clampi(pl.uy[y0 + t], 0, pl.ur - 1) : 0;
  if (t < kTileW) uxc[t] = t < cols ? clampi(pl.ux[x0 + t], 0, pl.uc - 1) : 0;
  if (t == 0) nkeys = 0;
  // this thread's entry's key, loaded while the table is cleared
  const int ek = t / kTileH, er = t - ek * kTileH;
  const bool entry = t < kEntries && er < rows;
  unsigned long long key = 0;
  if (entry) {
    const int e = ek * pl.h + y0 + er;
    key = static_cast<unsigned long long>(
              clampi(pl.uy[y0 + er], 0, pl.ur - 1)) << 18 |
          (pl.inside[e] ? 0u : 1u << 17) |
          static_cast<unsigned>(clampi(pl.vr[e], 0, pl.h - 1));
  }
  __syncthreads();
  // this thread's column of the tile and its first row; the vertical taps
  // and the unit flags of its rows, loaded while the keys are formed
  const int c = t % kTileW, r_first = t / kTileW;
  const bool col_in = c < cols;
  int vtaps[kTaps], vunit = -1;
  unsigned on_rows = 0;  // bit j: row r_first + j * kRowStep's unit is on
  if (col_in) {
    vunit = uyc[r_first] * pl.uc + uxc[c];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) vtaps[k] = __ldg(pl.tv + vunit * kTaps + k);
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int r = r_first + j * kRowStep;
      if (r < rows && __ldg(pl.act + uyc[r] * pl.uc + uxc[c]) != 0)
        on_rows |= 1u << j;
    }
  }
  int at = -1;
  bool inserted = false;
  if (entry) {
    at = static_cast<int>((key * 0x9E3779B97F4A7C15ull) >> (64 - kTableBits));
    for (;;) {
      const unsigned long long old = atomicCAS(&table[at], kEmpty, key);
      inserted = old == kEmpty;
      if (inserted || old == key) break;
      at = (at + 1) & (kTable - 1);
    }
  }
  // number the keys this warp inserted
  const int lane = t & 31;
  const unsigned mine = __ballot_sync(0xffffffffu, inserted);
  int n = 0;
  if (lane == 0 && mine) n = atomicAdd(&nkeys, __popc(mine));
  n = __shfl_sync(0xffffffffu, n, 0) + __popc(mine & ((1u << lane) - 1));
  if (inserted) {
    table_key[at] = static_cast<int16_t>(n);
    krow[n] = static_cast<int>(key & 0xffff);
    kpre[n] = static_cast<uint8_t>(key >> 17 & 1);
    kur[n] = static_cast<int>(key >> 18);
  }
  if (t < kEntries) place[t] = static_cast<int16_t>(at);
  __syncthreads();
  if (t < kEntries) key_of[t] = place[t] < 0 ? -1 : table_key[place[t]];
  const int nk = nkeys;

  const int bd = a.bd;
  const int r0 = bd == 12 ? 5 : 3;
  const int r1 = bd == 12 ? 9 : 11;
  const int lim = (1 << (bd + 1 + 7 - r0)) - 1;
  int acc[kOwned];
#pragma unroll
  for (int j = 0; j < kOwned; ++j) acc[j] = -(1 << (bd + r1 - 1));
  for (int c0 = 0; c0 < nk; c0 += kChunk) {
    const int n = min(kChunk, nk - c0);
    __syncthreads();  // the previous chunk's rows are used up
    // the horizontal taps of this thread's first key, loaded while the
    // rows are staged
    int htaps[kTaps], hunit = -1;
    if (col_in && r_first < n) {
      hunit = kur[c0 + r_first];
      const int32_t* th = pl.th + (hunit * pl.uc + uxc[c]) * kTaps;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) htaps[j] = __ldg(th + j);
    }
    for (int i0 = t; i0 < n * kSegW; i0 += kBatch * kThreads) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int s = i / kSegW, key = c0 + s;
        v[u] = 0;
        if (i < n * kSegW) {
          const int32_t* src =
              kpre[key] ? pl.pre + krow[key] * pl.pre_stride
                        : pl.cdef + krow[key] * pl.cdef_stride;
          v[u] = __ldg(src + clampi(x0 - 3 + i - s * kSegW, 0, pl.w - 1));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n * kSegW) seg[i] = static_cast<int16_t>(v[u]);
      }
    }
    __syncthreads();
    if (col_in) {
      for (int s = r_first; s < n; s += kRowStep) {
        if (kur[c0 + s] != hunit) {
          hunit = kur[c0 + s];
          const int32_t* th = pl.th + (hunit * pl.uc + uxc[c]) * kTaps;
#pragma unroll
          for (int j = 0; j < kTaps; ++j) htaps[j] = __ldg(th + j);
        }
        const int16_t* row = seg + s * kSegW + c;
        int h = 1 << (bd + 6);
#pragma unroll
        for (int j = 0; j < kTaps; ++j) h += htaps[j] * row[j];
        hf[s * kTileW + c] =
            static_cast<int16_t>(clampi((h + (1 << (r0 - 1))) >> r0, 0, lim));
      }
    }
    __syncthreads();
    if (col_in) {
#pragma unroll
      for (int j = 0; j < kOwned; ++j) {
        const int r = r_first + j * kRowStep;
        if (!(on_rows >> j & 1)) continue;
        const int u = uyc[r] * pl.uc + uxc[c];
        if (u != vunit) {
          vunit = u;
#pragma unroll
          for (int k = 0; k < kTaps; ++k)
            vtaps[k] = __ldg(pl.tv + u * kTaps + k);
        }
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const unsigned s = key_of[k * kTileH + r] - c0;
          if (s < static_cast<unsigned>(n))
            acc[j] += vtaps[k] * hf[s * kTileW + c];
        }
      }
    }
  }
  if (!col_in) return;
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int r = r_first + j * kRowStep;
    if (r >= rows) break;
    const int y = y0 + r, x = x0 + c;
    pl.out[static_cast<long long>(y) * pl.w + x] =
        on_rows >> j & 1
            ? clampi((acc[j] + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)
            : pl.cdef[y * pl.cdef_stride + x];
  }
}

}  // namespace

// Runs the Wiener filter of the `nplanes` planes (1 to kMaxPlanes) in one
// launch on `stream`.  `params`: kParams int64 in Param order.  The
// planes must hold pixels of `bd` bits (the kernel keeps them as int16).
// Returns the launch's error code (0: launched).
extern "C" int wiener_frame(const long long* params, int nplanes,
                            void* stream) {
  Frame a = {};
  a.np = nplanes;
  a.bd = static_cast<int>(params[P_BD]);
  if (nplanes < 1 || nplanes > kMaxPlanes || params[P_NPLANES] != nplanes ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  long long blocks = 0;
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
    pl.tiles_x = static_cast<int>((w + kTileW - 1) / kTileW);
    pl.first = static_cast<int>(blocks);
    blocks += pl.tiles_x * ((h + kTileH - 1) / kTileH);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, wiener_kernel, a);
}
