// One pass of the deblocking loop filter over every plane of a frame
// [SPEC §7.14]: all vertical edges (between columns), or all horizontal
// edges (between rows), hand-written for Hopper (sm_90a), one launch a
// pass, so two launches a frame.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled deblock
// program of the JAX package: av1dec_tpu/ops/kernels/deblock.py:219
// (deblock_planes; jit deblock_all :232, pass _pass_axis1 :160, filters
// _filter_edges :57, thresholds _thresholds :35).  Its plain version is
// _deblock_plain in av1dec_tpu_torch/ops/kernels/deblock.py (eager torch
// over the whole [H, W/4] edge lattice); the two agree byte for byte.
//
// What bounds it: bytes.  Each pass reads its input plane once and writes
// a new one (int32), and reads the two int32 per-4x4-cell maps of its
// direction (filter length, level); the filters are a few dozen integer
// operations on the few edges a block boundary has.
//
// Design: a pass works on lines (pixel rows for the vertical edges, pixel
// columns for the horizontal ones) of 4-pixel cells; the edge k of a line
// lies between positions 4k - 1 and 4k.  One thread owns one cell
// (line, k) and writes its 4 output pixels, each exactly once, so no
// thread writes a pixel another writes.  Within a pass every edge reads
// only the pass's input, so a pixel's value is that of the last of its
// writers in the plain version's order (_pass_axis1's recombination):
// the pixel itself, then edge k as q_j, then edge k + 1 as p_(3-j), then
// edge k - 1 as q_(4+j) (j < 2) or edge k + 2 as p_(7-j) (j >= 2), the
// last two only when their 13-tap wide filter runs.  On a stream's maps
// at most one of them writes (the lengths follow the transform sizes); the
// plain version also defines the result on maps where several do (every
// length beside every other), and this design keeps it there too, where a
// thread per edge writing its own taps would race.  Its cost: an edge with
// a length is evaluated by the threads of the two cells beside it, a wide
// one by up to four.  So the thread evaluates edge k and edge k + 1 when their length is not 0, and edges
// k - 1 and k + 2 only when their length is 14: it loads the edge's 14
// taps p6..q6 (0 outside the plane, as the plain version's zero
// padding), its thresholds from the level [SPEC §7.14.4], the masks and
// flat tests [SPEC §7.14.6.2] and the one filter that applies (13-tap
// wide, 7-, 5- or 4-tap narrow with hev) into registers.  Cells past the
// map (k >= k4, or line >= 4 n4) have length 0; only positions inside
// the plane are written.  Threads are numbered so that a warp's loads
// coalesce: along the line for the vertical pass (32 adjacent cells of
// a row), across lines for the horizontal pass (32 adjacent columns of
// one cell row).  Every plane of the frame is in the one launch; the
// vertical pass reads the planes in place through their row stride (the
// scan's flat frame buffer) and writes contiguous planes, which the
// horizontal pass reads.  All values stay far inside int32 (pixels of at
// most 12 bits, sums of 16 of them).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;

// The int64 parameter array (ops/kernels/deblock.py _PARAMS): the pass's
// ints, then per plane (up to kMaxPlanes) its input (pointer, row
// stride), output (pointer, row stride), height, width, the two cell
// maps of the pass's direction and their shape [n4, k4]; a plane the
// frame does not have is 0 throughout.
enum Param : int {
  P_AXIS = 0,
  P_SHARP = 1,
  P_BD = 2,
  P_NPLANES = 3,
  P_SRC0 = 4,
  P_SRC_STRIDE0 = 7,
  P_DST0 = 10,
  P_DST_STRIDE0 = 13,
  P_H0 = 16,
  P_W0 = 19,
  P_FLEN0 = 22,
  P_LVL0 = 25,
  P_N40 = 28,
  P_K40 = 31,
  kParams = 34
};

struct Plane {
  const int32_t* src;
  int32_t* dst;
  const int32_t* flen;
  const int32_t* lvl;
  long long src_line, src_pos;  // element steps between lines, positions
  long long dst_line, dst_pos;
  long long first;  // the plane's first thread
  int lines, n, cells, n4, k4;
};

struct Pass {
  Plane p[kMaxPlanes];
  long long total;
  int np, vertical, sharp, bd;
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
#pragma unroll
    for (int i = 1; i < 13; ++i) {
      int acc = s[i - 1] + s[i] + s[i + 1];
#pragma unroll
      for (int j = i - 6; j <= i + 6; ++j) acc += s[j < 0 ? 0 : (j > 13 ? 13 : j)];
      e.o[i] = (acc + 8) >> 4;
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

// The length of edge k of line `line` (0 past the map) and its level.
__device__ __forceinline__ int edge_len(const Plane& pl, int line, int k,
                                        int& lvl) {
  lvl = 0;
  if (k < 0 || k >= pl.cells || k >= pl.k4 || (line >> 2) >= pl.n4) return 0;
  const long long c = static_cast<long long>(line >> 2) * pl.k4 + k;
  lvl = pl.lvl[c];
  return pl.flen[c];
}

__device__ void eval_edge(const Pass& a, const Plane& pl, int line, int k,
                          int len, int lvl, Edge& e) {
  int s[14];
  const int32_t* src = pl.src + line * pl.src_line;
#pragma unroll
  for (int i = 0; i < 14; ++i) {
    const int pos = 4 * k - 7 + i;
    s[i] = pos >= 0 && pos < pl.n ? src[pos * pl.src_pos] : 0;
  }
  filter_edge(s, len, lvl, a.sharp, a.bd, e);
}

__global__ void __launch_bounds__(kThreads) deblock_kernel(const Pass a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.total) return;
  int pi = 0;
  while (pi + 1 < a.np && t >= a.p[pi + 1].first) ++pi;
  const Plane& pl = a.p[pi];
  const long long u = t - pl.first;
  int line, k;
  if (a.vertical) {
    line = static_cast<int>(u / pl.cells);
    k = static_cast<int>(u - static_cast<long long>(line) * pl.cells);
  } else {
    k = static_cast<int>(u / pl.lines);
    line = static_cast<int>(u - static_cast<long long>(k) * pl.lines);
  }
  const int32_t* src = pl.src + line * pl.src_line;
  int out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pos = 4 * k + j;
    out[j] = pos < pl.n ? src[pos * pl.src_pos] : 0;
  }
  Edge e;
  int lvl;
  // the writers of the cell's pixels, the one that wins last
  int len = edge_len(pl, line, k, lvl);
  if (len > 0) {
    eval_edge(a, pl, line, k, len, lvl, e);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (writes(e, 7 + j)) out[j] = e.o[7 + j];
  }
  len = edge_len(pl, line, k + 1, lvl);
  if (len > 0) {
    eval_edge(a, pl, line, k + 1, len, lvl, e);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (writes(e, 3 + j)) out[j] = e.o[3 + j];
  }
  len = edge_len(pl, line, k - 1, lvl);
  if (len == 14) {
    eval_edge(a, pl, line, k - 1, len, lvl, e);
    if (e.wide) {
      out[0] = e.o[11];
      out[1] = e.o[12];
    }
  }
  len = edge_len(pl, line, k + 2, lvl);
  if (len == 14) {
    eval_edge(a, pl, line, k + 2, len, lvl, e);
    if (e.wide) {
      out[2] = e.o[1];
      out[3] = e.o[2];
    }
  }
  int32_t* dst = pl.dst + line * pl.dst_line;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pos = 4 * k + j;
    if (pos < pl.n) dst[pos * pl.dst_pos] = out[j];
  }
}

}  // namespace

// Runs one deblocking pass (axis 0: the vertical edges, 1: the horizontal
// edges) of the `nplanes` planes (1 to kMaxPlanes) in one launch on
// `stream`.  `params`: kParams int64 in Param order.  Returns the
// launch's error code (0: launched).
extern "C" int deblock_pass(const long long* params, int nplanes,
                            void* stream) {
  Pass a = {};
  a.np = nplanes;
  a.vertical = params[P_AXIS] == 0;
  a.sharp = static_cast<int>(params[P_SHARP]);
  a.bd = static_cast<int>(params[P_BD]);
  if (nplanes < 1 || nplanes > kMaxPlanes || params[P_NPLANES] != nplanes ||
      (params[P_AXIS] != 0 && params[P_AXIS] != 1) || a.sharp < 0 ||
      a.sharp > 7 || (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  long long total = 0;
  for (int i = 0; i < nplanes; ++i) {
    Plane& pl = a.p[i];
    const long long h = params[P_H0 + i], w = params[P_W0 + i];
    const long long ss = params[P_SRC_STRIDE0 + i];
    const long long ds = params[P_DST_STRIDE0 + i];
    pl.src = reinterpret_cast<const int32_t*>(params[P_SRC0 + i]);
    pl.dst = reinterpret_cast<int32_t*>(params[P_DST0 + i]);
    pl.flen = reinterpret_cast<const int32_t*>(params[P_FLEN0 + i]);
    pl.lvl = reinterpret_cast<const int32_t*>(params[P_LVL0 + i]);
    const long long n4 = params[P_N40 + i], k4 = params[P_K40 + i];
    if (h < 1 || w < 1 || h > (1 << 16) || w > (1 << 16) || ss < w ||
        ds < w || n4 < 0 || k4 < 0 || n4 * k4 > 0x7fffffffLL ||
        pl.src == nullptr || pl.dst == nullptr ||
        (n4 * k4 > 0 && (pl.flen == nullptr || pl.lvl == nullptr)))
      return cudaErrorInvalidValue;
    pl.n4 = static_cast<int>(n4);
    pl.k4 = static_cast<int>(k4);
    // a line is a row (vertical edges) or a column (horizontal edges)
    pl.lines = static_cast<int>(a.vertical ? h : w);
    pl.n = static_cast<int>(a.vertical ? w : h);
    pl.src_line = a.vertical ? ss : 1;
    pl.src_pos = a.vertical ? 1 : ss;
    pl.dst_line = a.vertical ? ds : 1;
    pl.dst_pos = a.vertical ? 1 : ds;
    pl.cells = (pl.n + 3) / 4;
    pl.first = total;
    total += static_cast<long long>(pl.lines) * pl.cells;
  }
  a.total = total;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, deblock_kernel, a);
}
