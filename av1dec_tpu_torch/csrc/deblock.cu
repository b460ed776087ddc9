// Both passes of the deblocking loop filter over every plane of a frame
// [SPEC §7.14]: the vertical edges (between columns), then the horizontal
// edges (between rows), hand-written for Hopper (sm_90a), one launch a
// frame.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled deblock
// program of the JAX package: av1dec_tpu/ops/kernels/deblock.py:219
// (deblock_planes; jit deblock_all :232, pass _pass_axis1 :160, filters
// _filter_edges :57, thresholds _thresholds :35).  Its plain version is
// _deblock_plain in av1dec_tpu_torch/ops/kernels/deblock.py (eager torch
// over the whole [H, W/4] edge lattice); the two agree byte for byte.
//
// What bounds it: bytes.  Each plane is read once and written once
// (int32), and the four int32 per-4x4-cell maps are read once; the
// filters are a few dozen integer operations on the few edges a block
// boundary has.
//
// Design: a block owns a kTileH x kTileW tile of output pixels of one
// plane (a table of first blocks maps a block to its plane and tile).
// An edge k of a line lies between positions 4k - 1 and 4k, reads
// positions 4k - 7 .. 4k + 6 (0 outside the plane, as the plain version's
// zero padding) and writes at most 4k - 6 .. 4k + 5; so the output of a
// 4-pixel cell k comes from edges k - 1 .. k + 2, which read 4k - 11 ..
// 4k + 14.  The block stages its tile's source pixels with a kHalo = 11
// pixel halo on every side into shared memory as int16 (pixels have at
// most 12 bits), in row loads through the plane's row stride, kBatch
// loads in flight a thread, and the cell maps of the edges it runs.  It
// runs the vertical edges of the tile's columns on every staged row (the
// tile's and the halo's), each edge line evaluated once by one thread,
// in place; then the horizontal edges of the tile's columns the same
// way, in place; then it writes the tile once, in row stores, to the
// contiguous output planes.  The intermediate plane never reaches device
// memory; the halo rows' vertical edges are run again by the
// neighbouring tile (22 of every 86 rows).  In place is exact: a pass's
// edges read and write only their own line, and a round's threads have
// all read before any writes.
//
// Within a pass every edge reads only the pass's input, and a pixel's
// value is that of the last of its writers in the plain version's order
// (_pass_axis1's recombination): the pixel itself, then edge k as q_j,
// then edge k + 1 as p_(3-j), then edge k - 1 as q_(4+j) (j < 2) or edge
// k + 2 as p_(7-j) (j >= 2), the last two only when their 13-tap wide
// filter runs.  On a stream's maps at most one of them writes (the
// lengths follow the transform sizes); the plain version also defines
// the result on maps where several do (every length beside every
// other).  So each thread keeps its edge's filtered taps in registers
// and writes them in three phases, a barrier apart, in that order:
// q0..q3, then p0..p3, then q4, q5 and p4, p5 (edge k - 1 and edge k + 2
// write different pixels of cell k); within a phase no two edges write
// one pixel.  Only the edge lines with a length take a thread: a pass
// first lists them, line by line (a bit mask of a line's edges, a prefix
// sum over the lines in one warp), and a round takes as many whole lines
// as have at most kThreads such edges, since only edges of one line write
// the same pixels.  The filters are those of the plain version [SPEC
// §7.14.4-6]: the thresholds from the level, the masks and flat tests,
// and the one filter that applies (13-tap wide as running sums, 7-, 5- or
// 4-tap narrow with hev).
// Cells past a map (k >= k4, or a line past 4 n4) have length 0.  All
// arithmetic is 32-bit; values stay far inside int32 (pixels of at most
// 12 bits, sums of 16 of them).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
// output pixels a block, and the staged halo on each side
constexpr int kTileH = 64;
constexpr int kTileW = 64;
constexpr int kHalo = 11;
// staged rows (the tile's and the halo's) and source columns
constexpr int kRows = kTileH + 2 * kHalo;
constexpr int kSrcCols = kTileW + 2 * kHalo;
// the staged tile's row pitch in shared memory (int16), padded against
// bank conflicts
constexpr int kSrcPitch = kSrcCols + 1;
// edges that reach the tile along a line (k0 - 1 .. k1 + 2), the lines
// of a pass, the cell rows of the vertical maps the staged rows cover
constexpr int kEdgesV = kTileW / 4 + 3;
constexpr int kEdgesH = kTileH / 4 + 3;
constexpr int kLines = kRows > kTileW ? kRows : kTileW;
constexpr int kItems = kRows * kEdgesV > kTileW * kEdgesH ? kRows * kEdgesV
                                                          : kTileW * kEdgesH;
constexpr int kCellRowsV = kRows / 4 + 1;
constexpr int kCellColsH = kTileW / 4;
// staged loads in flight a thread, and the blocks an SM holds: 6 x 132
// SMs take a 1080p 4:2:0 frame's 780 tiles in one wave, and the register
// cap that sets (40) holds kBatch loads in flight without spilling
constexpr int kBatch = 16;
constexpr int kBlocksPerSm = 6;
static_assert(kEdgesV <= 32 && kEdgesH <= 32 && kLines <= kThreads,
              "a line's edges are the bits of a word, a line a thread");

// The int64 parameter array (ops/kernels/deblock.py _PARAMS): the
// frame's ints, then per plane (up to kMaxPlanes) its input (pointer,
// row stride), output (pointer, row stride), height, width, and the two
// cell maps of the vertical edges and of the horizontal edges with their
// shapes [n4, k4]; a plane the frame does not have is 0 throughout.
enum Param : int {
  P_SHARP = 0,
  P_BD = 1,
  P_NPLANES = 2,
  P_SRC0 = 3,
  P_SRC_STRIDE0 = 6,
  P_DST0 = 9,
  P_DST_STRIDE0 = 12,
  P_H0 = 15,
  P_W0 = 18,
  P_FLEN_V0 = 21,
  P_LVL_V0 = 24,
  P_N4_V0 = 27,
  P_K4_V0 = 30,
  P_FLEN_H0 = 33,
  P_LVL_H0 = 36,
  P_N4_H0 = 39,
  P_K4_H0 = 42,
  kParams = 45
};

struct Plane {
  const int32_t* src;
  int32_t* dst;
  const int32_t* flen[2];  // [0] vertical edges, [1] horizontal edges
  const int32_t* lvl[2];
  long long src_stride, dst_stride;
  int h, w, n4[2], k4[2];
  int tiles_x, first;  // tiles a row of the plane, its first block
};

struct Frame {
  Plane p[kMaxPlanes];
  int np, sharp, bd;
};

__device__ __forceinline__ int iabs(int a) { return a < 0 ? -a : a; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The filtered values of one edge: o[i] for the taps s[i] = p6..p0,
// q0..q6 (i = 6 - t for p_t, 7 + t for q_t), and which taps it writes:
// p0, p1, q0, q1 when `near`, p2 and q2 also when `mid`, p3..p5 and
// q3..q5 when `wide`.
struct Edge {
  int o[14];
  bool near, mid, wide;
};

// _filter_edges of one edge, with _thresholds of its level.
__device__ void filter_edge(const int s[14], int len, int lvl, int sharp,
                            int bd, Edge& e) {
  const int shift = (sharp > 0) + (sharp > 4);
  int limit = lvl >> shift;
  if (sharp > 0) limit = min(limit, 9 - sharp);
  limit = max(limit, 1);
  const int F = 1 << (bd - 8);
  const int blimit = (2 * (lvl + 2) + limit) * F;
  const int thresh = (lvl >> 4) * F;
  limit *= F;
  const int p0 = s[6], p1 = s[5], p2 = s[4], p3 = s[3];
  const int q0 = s[7], q1 = s[8], q2 = s[9], q3 = s[10];
  const bool m = iabs(p1 - p0) <= limit && iabs(q1 - q0) <= limit &&
                 iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) <= blimit;
  const bool m6 = m && iabs(p2 - p1) <= limit && iabs(q2 - q1) <= limit;
  const bool m8 = m6 && iabs(p3 - p2) <= limit && iabs(q3 - q2) <= limit;
  const bool mask = len > 0 && (len == 4 ? m : (len == 6 ? m6 : m8));
  const bool flat6 = iabs(p1 - p0) <= F && iabs(q1 - q0) <= F &&
                     iabs(p2 - p0) <= F && iabs(q2 - q0) <= F;
  const bool flat8 = flat6 && iabs(p3 - p0) <= F && iabs(q3 - q0) <= F;
  bool flat2 = true;
#pragma unroll
  for (int t = 4; t < 7; ++t)
    flat2 = flat2 && iabs(s[6 - t] - p0) <= F && iabs(s[7 + t] - q0) <= F;
#pragma unroll
  for (int i = 0; i < 14; ++i) e.o[i] = s[i];
  const bool w14 = mask && len == 14 && flat8 && flat2;
  const bool w8 = mask && len >= 8 && flat8 && !w14;
  const bool w6 = mask && len == 6 && flat6;
  const bool w4 = mask && !w14 && !w8 && !w6;
  e.near = mask;
  e.mid = w14 || w8;
  e.wide = w14;
  if (w14) {  // [SPEC §7.14.6.4], 13 taps, the ends repeated
    // sum of s[j] for j = i - 6 .. i + 6, clamped to the taps, at i = 1
    int sum = 6 * s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7];
#pragma unroll
    for (int i = 1; i < 13; ++i) {
      if (i > 1) sum += s[i + 6 > 13 ? 13 : i + 6] - s[i - 7 < 0 ? 0 : i - 7];
      e.o[i] = (s[i - 1] + s[i] + s[i + 1] + sum + 8) >> 4;
    }
  } else if (w8) {
    e.o[4] = (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3;
    e.o[5] = (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3;
    e.o[6] = (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3;
    e.o[7] = (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3;
    e.o[8] = (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3;
    e.o[9] = (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3;
  } else if (w6) {
    e.o[5] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
    e.o[6] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
    e.o[7] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
    e.o[8] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
  } else if (w4) {  // narrow filter with high edge variance
    const int half = 128 * F, lo = -half, hi = half - 1;
    const int top = (1 << bd) - 1;
    const bool hev = iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
    const int ps1 = p1 - half, ps0 = p0 - half;
    const int qs0 = q0 - half, qs1 = q1 - half;
    const int a = clampi((hev ? clampi(ps1 - qs1, lo, hi) : 0) +
                             3 * (qs0 - ps0), lo, hi);
    const int f1 = clampi(a + 4, lo, hi) >> 3;
    const int f2 = clampi(a + 3, lo, hi) >> 3;
    const int f3 = hev ? 0 : (f1 + 1) >> 1;
    e.o[7] = clampi(clampi(qs0 - f1, lo, hi) + half, 0, top);
    e.o[6] = clampi(clampi(ps0 + f2, lo, hi) + half, 0, top);
    e.o[8] = clampi(clampi(qs1 - f3, lo, hi) + half, 0, top);
    e.o[5] = clampi(clampi(ps1 + f3, lo, hi) + half, 0, top);
  }
}

// Whether the edge writes its tap i (1 <= i <= 12).
__device__ __forceinline__ bool writes(const Edge& e, int i) {
  const int d = i < 7 ? 6 - i : i - 7;  // 0 for p0 and q0
  return d < 2 ? e.near : (d == 2 ? e.mid : e.wide);
}

// Writes the taps kLo..kHi that the edge writes, tap i at taps[i * step].
template <int kLo, int kHi>
__device__ __forceinline__ void put(const Edge& e, int16_t* taps, int step) {
#pragma unroll
  for (int i = kLo; i <= kHi; ++i)
    if (writes(e, i)) taps[i * step] = static_cast<int16_t>(e.o[i]);
}

// The lists of a pass's edge lines with a length: a bit mask of each
// line's edges, each line's first item, and the items (line * 32 + edge),
// line by line.
struct Lists {
  uint32_t mask[kLines];
  int16_t first[kLines + 1];
  int16_t item[kItems];
};

// One pass's edges over a tile: `lines` lines of kEdges edges;
// `active(line, edge)` says whether an edge line has a length,
// `eval(line, edge, e)` filters it into `e` and returns whether it
// writes, `line_of(line, out, step)` gives the line's tap 0 of edge 0 in
// the staged tile and its step.  Each edge line with a length is
// evaluated once, by one thread; its writes go out in place in the plain
// version's order, a barrier before each of the three phases (the first
// also after every read of the round).
template <int kEdges, class Active, class Eval, class LineOf>
__device__ __forceinline__ void run_pass(Lists& l, int lines, Active active,
                                         Eval eval, LineOf line_of) {
  const int t = threadIdx.x;
  if (t < lines) {
    uint32_t m = 0;
    for (int k = 0; k < kEdges; ++k)
      if (active(t, k)) m |= 1u << k;
    l.mask[t] = m;
  }
  __syncthreads();
  if (t < 32) {  // the lines' first items: a prefix sum in one warp
    int carry = 0;
    for (int base = 0; base < lines; base += 32) {
      const int line = base + t;
      int n = line < lines ? __popc(l.mask[line]) : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, n, d);
        if (t >= d) n += up;
      }
      if (line < lines) l.first[line + 1] = static_cast<int16_t>(carry + n);
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
    if (t == 0) l.first[0] = 0;
  }
  __syncthreads();
  if (t < lines) {
    int at = l.first[t];
    for (uint32_t m = l.mask[t]; m; m &= m - 1)
      l.item[at++] =
          static_cast<int16_t>(t * 32 + __ffs(static_cast<int>(m)) - 1);
  }
  __syncthreads();
  for (int a = 0; a < lines;) {
    // the most whole lines a .. b - 1 with at most kThreads items
    int b = a + 1, hi = lines;
    while (b < hi) {
      const int mid = (b + hi + 1) >> 1;
      if (l.first[mid] - l.first[a] <= kThreads) b = mid;
      else hi = mid - 1;
    }
    Edge e;
    int16_t* out = nullptr;
    int step = 0;
    bool on = false;
    if (t < l.first[b] - l.first[a]) {
      const int it = l.item[l.first[a] + t];
      const int line = it >> 5, k = it & 31;
      on = eval(line, k, e);
      if (on) {
        line_of(line, out, step);
        out += 4 * k * step;
      }
    }
    a = b;
    __syncthreads();
    if (on) put<7, 10>(e, out, step);  // edge k on cell k
    __syncthreads();
    if (on) put<3, 6>(e, out, step);  // edge k on cell k - 1
    __syncthreads();
    if (on) {  // edge k on cell k + 1 (j < 2) and on cell k - 2 (j >= 2)
      put<11, 12>(e, out, step);
      put<1, 2>(e, out, step);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    deblock_kernel(const Frame a) {
  // the source tile with its halo, filtered in place by both passes
  __shared__ int16_t px[kRows * kSrcPitch];
  // the lengths and levels of the edges the block runs
  __shared__ int32_t len_v[kCellRowsV * kEdgesV], lvl_v[kCellRowsV * kEdgesV];
  __shared__ int32_t len_h[kCellColsH * kEdgesH], lvl_h[kCellColsH * kEdgesH];
  __shared__ Lists lists;

  const int b = blockIdx.x;
  int pi = 0;
  while (pi + 1 < a.np && b >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const int tile = b - pl.first;
  const int ty = tile / pl.tiles_x;
  const int y0 = ty * kTileH, x0 = (tile - ty * pl.tiles_x) * kTileW;
  const int t = threadIdx.x;

  constexpr int kStaged = kRows * kSrcCols;
  for (int i0 = t; i0 < kStaged; i0 += kBatch * kThreads) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / kSrcCols, c = i - r * kSrcCols;
      const int y = y0 - kHalo + r, x = x0 - kHalo + c;
      v[u] = i < kStaged && y >= 0 && y < pl.h && x >= 0 && x < pl.w
                 ? __ldg(pl.src + y * pl.src_stride + x)
                 : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / kSrcCols;
      if (i < kStaged)
        px[r * kSrcPitch + i - r * kSrcCols] = static_cast<int16_t>(v[u]);
    }
  }
  // vertical edges: cell row y0 / 4 - 3 + i of the staged rows, edge
  // x0 / 4 - 1 + k; horizontal edges: cell column x0 / 4 + i, edge
  // y0 / 4 - 1 + k (each 0 past its map or the plane's edges)
  const int kv = min(pl.k4[0], (pl.w + 3) >> 2);
  const int kh = min(pl.k4[1], (pl.h + 3) >> 2);
  for (int i = t; i < kCellRowsV * kEdgesV; i += kThreads) {
    const int row = y0 / 4 - 3 + i / kEdgesV;
    const int k = x0 / 4 - 1 + i % kEdgesV;
    const bool ok = row >= 0 && row < pl.n4[0] && k >= 0 && k < kv;
    len_v[i] = ok ? pl.flen[0][row * pl.k4[0] + k] : 0;
    lvl_v[i] = ok ? pl.lvl[0][row * pl.k4[0] + k] : 0;
  }
  for (int i = t; i < kCellColsH * kEdgesH; i += kThreads) {
    const int col = x0 / 4 + i / kEdgesH;
    const int k = y0 / 4 - 1 + i % kEdgesH;
    const bool ok = col < pl.n4[1] && k >= 0 && k < kh;
    len_h[i] = ok ? pl.flen[1][col * pl.k4[1] + k] : 0;
    lvl_h[i] = ok ? pl.lvl[1][col * pl.k4[1] + k] : 0;
  }
  __syncthreads();

  // the vertical edges of every staged row (row y0 - kHalo + r) on the
  // tile's columns; rows outside the plane stay 0
  const int sharp = a.sharp, bd = a.bd;
  run_pass<kEdgesV>(
      lists, kRows,
      [&](int r, int k) {
        const int y = y0 - kHalo + r;
        return y >= 0 && y < pl.h && len_v[((r + 1) >> 2) * kEdgesV + k] > 0;
      },
      [&](int r, int k, Edge& e) {
        const int c = ((r + 1) >> 2) * kEdgesV + k;
        int s[14];
        const int16_t* src = px + r * kSrcPitch + 4 * k;
#pragma unroll
        for (int i = 0; i < 14; ++i) s[i] = src[i];
        filter_edge(s, len_v[c], lvl_v[c], sharp, bd, e);
        return e.near;
      },
      [&](int r, int16_t*& out, int& step) {
        out = px + r * kSrcPitch;
        step = 1;
      });
  __syncthreads();

  // the horizontal edges of the tile's columns (x0 + c) on the vertical
  // pass's output
  run_pass<kEdgesH>(
      lists, kTileW,
      [&](int c, int k) {
        return x0 + c < pl.w && len_h[(c >> 2) * kEdgesH + k] > 0;
      },
      [&](int c, int k, Edge& e) {
        const int i = (c >> 2) * kEdgesH + k;
        int s[14];
        const int16_t* src = px + 4 * k * kSrcPitch + c + kHalo;
#pragma unroll
        for (int j = 0; j < 14; ++j) s[j] = src[j * kSrcPitch];
        filter_edge(s, len_h[i], lvl_h[i], sharp, bd, e);
        return e.near;
      },
      [&](int c, int16_t*& out, int& step) {
        out = px + c + kHalo;
        step = kSrcPitch;
      });
  __syncthreads();
  for (int i = t; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y < pl.h && x < pl.w)
      pl.dst[y * pl.dst_stride + x] = px[(r + kHalo) * kSrcPitch + c + kHalo];
  }
}

}  // namespace

// Runs both deblocking passes of the `nplanes` planes (1 to kMaxPlanes)
// in one launch on `stream`.  `params`: kParams int64 in Param order.
// The planes must hold pixels of `bd` bits (the kernel keeps them as
// int16), and each output must not overlap an input.  Returns the
// launch's error code (0: launched).
extern "C" int deblock_frame(const long long* params, int nplanes,
                             void* stream) {
  Frame a = {};
  a.np = nplanes;
  a.sharp = static_cast<int>(params[P_SHARP]);
  a.bd = static_cast<int>(params[P_BD]);
  if (nplanes < 1 || nplanes > kMaxPlanes || params[P_NPLANES] != nplanes ||
      a.sharp < 0 || a.sharp > 7 ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  long long blocks = 0;
  for (int i = 0; i < nplanes; ++i) {
    Plane& pl = a.p[i];
    const long long h = params[P_H0 + i], w = params[P_W0 + i];
    pl.src = reinterpret_cast<const int32_t*>(params[P_SRC0 + i]);
    pl.dst = reinterpret_cast<int32_t*>(params[P_DST0 + i]);
    pl.src_stride = params[P_SRC_STRIDE0 + i];
    pl.dst_stride = params[P_DST_STRIDE0 + i];
    if (h < 1 || w < 1 || h > (1 << 16) || w > (1 << 16) ||
        pl.src_stride < w || pl.dst_stride < w || pl.src == nullptr ||
        pl.dst == nullptr)
      return cudaErrorInvalidValue;
    for (int d = 0; d < 2; ++d) {
      const long long n4 = params[(d ? P_N4_H0 : P_N4_V0) + i];
      const long long k4 = params[(d ? P_K4_H0 : P_K4_V0) + i];
      pl.flen[d] = reinterpret_cast<const int32_t*>(
          params[(d ? P_FLEN_H0 : P_FLEN_V0) + i]);
      pl.lvl[d] = reinterpret_cast<const int32_t*>(
          params[(d ? P_LVL_H0 : P_LVL_V0) + i]);
      if (n4 < 0 || k4 < 0 || n4 * k4 > 0x7fffffffLL ||
          (n4 * k4 > 0 && (pl.flen[d] == nullptr || pl.lvl[d] == nullptr)))
        return cudaErrorInvalidValue;
      pl.n4[d] = static_cast<int>(n4);
      pl.k4[d] = static_cast<int>(k4);
    }
    pl.h = static_cast<int>(h);
    pl.w = static_cast<int>(w);
    pl.tiles_x = static_cast<int>((w + kTileW - 1) / kTileW);
    pl.first = static_cast<int>(blocks);
    blocks += pl.tiles_x * ((h + kTileH - 1) / kTileH);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, deblock_kernel, a);
}
