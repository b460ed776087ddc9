// The MC pass of one frame: every translational motion-compensation lane
// of every (T, compound) bucket [SPEC §7.11.3.4, §7.11.3.15], hand-written
// for Hopper (sm_90a), one launch for the whole pass.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled MC
// program of the JAX package: av1dec_tpu/ops/kernels/mc.py:84 (_mc_bucket,
// with _mc_list :54, all buckets of a frame in run_mc :112).  Its plain
// version is _mc_plain in av1dec_tpu_torch/ops/kernels/mc.py (the eager
// bucket loop over _mc_bucket); the two agree byte for byte.
//
// What bounds it: bytes on paper.  Each predicted pixel reads its
// reference pixel once per list (1 byte at 8 bits, 4 above: the packed
// reference is uint8 or int32) and writes one int32; the lane rows are
// read once.  The 8-tap passes are 16 multiply-adds a pixel a list.  A
// frame's pass is a few thousand small windows, so what it costs in
// practice is the latency of each window's gather and the chain of
// dependent loads and multiply-adds of its filter.
//
// Design: the work of a pass is a list of items, a bucket's after the
// other's: an item is the 32 / T lanes of a bucket of T <= 32 that one
// warp takes side by side, or one 32 x 32 tile of a lane of T = 64 or
// 128.  The grid is persistent: SMs x resident blocks (the
// occupancy API, queried once a device on the host, no device sync), and
// warp w of the grid takes items w, w + warps, ... in order.  Each warp
// works alone, with __syncwarp and no block barrier, in its own shared
// buffer: for each list of its item it copies the windows, waits for
// them and filters.  A window row that needs no column or flat-index
// clamp is copied with cp.async (__pipeline_memcpy_async): at 8 bits as
// the aligned 16-byte chunks that cover it, its first byte's offset kept
// beside it, at 10 and 12 bits a word at a time; any other row is
// gathered with the plain version's clamps (row to [0, ly], column to
// [0, lx], flat index to [0, ref_len - 1]).  The filter is compiled for
// each tile side T in {4, 8, 16, 32} and compound flag, picked by a
// switch on the item's bucket, so every index is a constant: a thread
// owns one output column j of one lane; it runs the horizontal 8-tap
// pass down its window rows (rounding r0) into a ring of 8 registers
// and, from the eighth row on, the vertical pass on the ring, so no
// intermediate goes to shared memory.  Each lane's 8 + 8 taps are read
// once a list from a __constant__ copy of the filter table into
// registers.  Single-list output is Round2(v, r1s), compound output
// Round2(w0 Round2(v0, 7) + w1 Round2(v1, 7), bshift) with list 0's
// rounded sums held in registers between the two lists; both clipped to
// [0, 2^bd - 1].  Only pixels inside the lane's w x h window are filtered
// and written (rows past h and tiles past w or h are skipped), each
// output row of a warp as one coalesced run of int32.  Items are
// independent: the lanes of a frame write disjoint pixels (InterPlan's
// lanes on the host, checked by the tests), so no order is needed; the
// trash slot of the frame buffer is never written.  All sums stay well
// inside int32 (12-bit pixels, 8 taps of at most 128).  (Measured and
// left out, PERF.md: a second buffer a warp that copies the next item's
// windows while this one filters, int4 stores, and 32 x 16 tiles.)

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// Lane row fields, in MC_FIELDS order (ops/kernels/mc.py).
enum Field : int {
  F_X = 0,
  F_Y = 1,
  F_BASE = 2,
  F_STRIDE = 3,
  F_W = 4,
  F_H = 5,
  F_RB0 = 6,
  F_RS0 = 7,
  F_LX0 = 8,
  F_LY0 = 9,
  F_CX0 = 10,
  F_CY0 = 11,
  F_HF0 = 12,
  F_VF0 = 13,
  F_RB1 = 14,
  F_RS1 = 15,
  F_LX1 = 16,
  F_LY1 = 17,
  F_CX1 = 18,
  F_CY1 = 19,
  F_HF1 = 20,
  F_VF1 = 21,
  F_W0 = 22,
  F_W1 = 23,
  F_BSHIFT = 24,
  kFields = 25
};
// list 1's fields follow list 0's at this distance
constexpr int kListFields = F_RB1 - F_RB0;

// The int64 parameter array (ops/kernels/mc.py _PARAMS): pointers, then
// ints, then per bucket (up to kMaxBuckets) its lane rows, T, compound
// flag and lane count; a bucket the pass does not have is 0 throughout.
// P_FTAB (the table's device copy, which the plain version reads) is not
// read here: the kernel has its own copy, kFtab.
enum Param : int {
  P_FRAME = 0,
  P_REF = 1,
  P_FTAB = 2,
  P_REF_LEN = 3,
  P_REF_BYTES = 4,
  P_BD = 5,
  P_NB = 6,
  P_ROWS0 = 7,
  P_T0 = 19,
  P_COMP0 = 31,
  P_N0 = 43,
  kParams = 55
};

constexpr int kMaxBuckets = 12;  // T in {4, ..., 128} x compound
constexpr int kMaxT = 128;
constexpr int kTile = 32;        // output tile side of a warp, at most
constexpr int kWarps = 8;        // warps a block
constexpr int kTaps = 8;
constexpr int kMaxDevices = 64;

// The six 16-phase filter banks, [6 * 16, 8] (ops/kernels/mc.py _FTAB:
// inter_tables.SUBPEL_FILTERS); a lane's hf / vf field is a row.
__constant__ int32_t kFtab[6 * 16 * kTaps] = {
    0, 0, 0, 128, 0, 0, 0, 0,  0, 2, -6, 126, 8, -2, 0, 0,
    0, 2, -10, 122, 18, -4, 0, 0,  0, 2, -12, 116, 28, -8, 2, 0,
    0, 2, -14, 110, 38, -10, 2, 0,  0, 2, -14, 102, 48, -12, 2, 0,
    0, 2, -16, 94, 58, -12, 2, 0,  0, 2, -14, 84, 66, -12, 2, 0,
    0, 2, -14, 76, 76, -14, 2, 0,  0, 2, -12, 66, 84, -14, 2, 0,
    0, 2, -12, 58, 94, -16, 2, 0,  0, 2, -12, 48, 102, -14, 2, 0,
    0, 2, -10, 38, 110, -14, 2, 0,  0, 2, -8, 28, 116, -12, 2, 0,
    0, 0, -4, 18, 122, -10, 2, 0,  0, 0, -2, 8, 126, -6, 2, 0,
    0, 0, 0, 128, 0, 0, 0, 0,  0, 2, 28, 62, 34, 2, 0, 0,
    0, 0, 26, 62, 36, 4, 0, 0,  0, 0, 22, 62, 40, 4, 0, 0,
    0, 0, 20, 60, 42, 6, 0, 0,  0, 0, 18, 58, 44, 8, 0, 0,
    0, 0, 16, 56, 46, 10, 0, 0,  0, -2, 16, 54, 48, 12, 0, 0,
    0, -2, 14, 52, 52, 14, -2, 0,  0, 0, 12, 48, 54, 16, -2, 0,
    0, 0, 10, 46, 56, 16, 0, 0,  0, 0, 8, 44, 58, 18, 0, 0,
    0, 0, 6, 42, 60, 20, 0, 0,  0, 0, 4, 40, 62, 22, 0, 0,
    0, 0, 4, 36, 62, 26, 0, 0,  0, 0, 2, 34, 62, 28, 2, 0,
    0, 0, 0, 128, 0, 0, 0, 0,  -2, 2, -6, 126, 8, -2, 2, 0,
    -2, 6, -12, 124, 16, -6, 4, -2,  -2, 8, -18, 120, 26, -10, 6, -2,
    -4, 10, -22, 116, 38, -14, 6, -2,  -4, 10, -22, 108, 48, -18, 8, -2,
    -4, 10, -24, 100, 60, -20, 8, -2,  -4, 10, -24, 90, 70, -22, 10, -2,
    -4, 12, -24, 80, 80, -24, 12, -4,  -2, 10, -22, 70, 90, -24, 10, -4,
    -2, 8, -20, 60, 100, -24, 10, -4,  -2, 8, -18, 48, 108, -22, 10, -4,
    -2, 6, -14, 38, 116, -22, 10, -4,  -2, 6, -10, 26, 120, -18, 8, -2,
    -2, 4, -6, 16, 124, -12, 6, -2,  0, 2, -2, 8, 126, -6, 2, -2,
    0, 0, 0, 128, 0, 0, 0, 0,  0, 0, 0, 120, 8, 0, 0, 0,
    0, 0, 0, 112, 16, 0, 0, 0,  0, 0, 0, 104, 24, 0, 0, 0,
    0, 0, 0, 96, 32, 0, 0, 0,  0, 0, 0, 88, 40, 0, 0, 0,
    0, 0, 0, 80, 48, 0, 0, 0,  0, 0, 0, 72, 56, 0, 0, 0,
    0, 0, 0, 64, 64, 0, 0, 0,  0, 0, 0, 56, 72, 0, 0, 0,
    0, 0, 0, 48, 80, 0, 0, 0,  0, 0, 0, 40, 88, 0, 0, 0,
    0, 0, 0, 32, 96, 0, 0, 0,  0, 0, 0, 24, 104, 0, 0, 0,
    0, 0, 0, 16, 112, 0, 0, 0,  0, 0, 0, 8, 120, 0, 0, 0,
    0, 0, 0, 128, 0, 0, 0, 0,  0, 0, -4, 126, 8, -2, 0, 0,
    0, 0, -8, 122, 18, -4, 0, 0,  0, 0, -10, 116, 28, -6, 0, 0,
    0, 0, -12, 110, 38, -8, 0, 0,  0, 0, -12, 102, 48, -10, 0, 0,
    0, 0, -14, 94, 58, -10, 0, 0,  0, 0, -12, 84, 66, -10, 0, 0,
    0, 0, -12, 76, 76, -12, 0, 0,  0, 0, -10, 66, 84, -12, 0, 0,
    0, 0, -10, 58, 94, -14, 0, 0,  0, 0, -10, 48, 102, -12, 0, 0,
    0, 0, -8, 38, 110, -12, 0, 0,  0, 0, -6, 28, 116, -10, 0, 0,
    0, 0, -4, 18, 122, -8, 0, 0,  0, 0, -2, 8, 126, -4, 0, 0,
    0, 0, 0, 128, 0, 0, 0, 0,  0, 0, 30, 62, 34, 2, 0, 0,
    0, 0, 26, 62, 36, 4, 0, 0,  0, 0, 22, 62, 40, 4, 0, 0,
    0, 0, 20, 60, 42, 6, 0, 0,  0, 0, 18, 58, 44, 8, 0, 0,
    0, 0, 16, 56, 46, 10, 0, 0,  0, 0, 14, 54, 48, 12, 0, 0,
    0, 0, 12, 52, 52, 12, 0, 0,  0, 0, 12, 48, 54, 14, 0, 0,
    0, 0, 10, 46, 56, 16, 0, 0,  0, 0, 8, 44, 58, 18, 0, 0,
    0, 0, 6, 42, 60, 20, 0, 0,  0, 0, 4, 40, 62, 22, 0, 0,
    0, 0, 4, 36, 62, 26, 0, 0,  0, 0, 2, 34, 62, 30, 0, 0,
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int round2(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

template <class A>
constexpr A cmax(A a, A b) {
  return a < b ? b : a;
}

// The windows of an item of tile side T: kLanes lanes side by side (one
// tile at T = 32), each T + 7 rows of kPitch bytes.  An 8-bit row is
// copied as the 16-byte chunks that cover it, so it takes up to 15 bytes
// more than its T + 7; an int32 row is copied a word at a time.
template <class Ref, int T>
struct Geo {
  static constexpr int kLanes = kTile / T;
  static constexpr int kW = T + 7;
  static constexpr int kRows = kLanes * kW;
  static constexpr int kPitch =
      sizeof(Ref) == 1 ? (15 + kW + 15) / 16 * 16 : kW * 4;
};

// A warp's window buffer, sized for the largest tile side.
template <class Ref>
struct alignas(16) Buf {
  static constexpr int kBytes =
      cmax(cmax(Geo<Ref, 4>::kRows * Geo<Ref, 4>::kPitch,
                Geo<Ref, 8>::kRows * Geo<Ref, 8>::kPitch),
           cmax(Geo<Ref, 16>::kRows * Geo<Ref, 16>::kPitch,
                Geo<Ref, 32>::kRows * Geo<Ref, 32>::kPitch));
  unsigned char data[kBytes];
  // 8 bits: each row's first byte in its first chunk (int32: unused)
  uint8_t off[sizeof(Ref) == 1 ? Geo<Ref, 4>::kRows : 1];
};

struct Bucket {
  const int32_t* rows;
  int t;      // lane tile size T
  int comp;   // 1: both lists, blended
  int n;      // lanes
  int first;  // the bucket's first item
};

struct McArgs {
  int32_t* frame;
  const void* ref;
  int ref_len;
  int bd;
  int nb;
  int items;  // of every bucket
  Bucket b[kMaxBuckets];
};

// The item's first lane and its tile's origin in the lane.
struct Place {
  int lane0, oy, ox;
};

__device__ __forceinline__ Place place(const Bucket& bk, int item) {
  const int local = item - bk.first;
  if (bk.t <= kTile) return {local * (kTile / bk.t), 0, 0};
  const int per = bk.t / kTile, k = local % (per * per);
  return {local / (per * per), k / per * kTile, k % per * kTile};
}

// Copies the windows of list `list` of the item at `p` into `buf` (cp.async
// where a row needs no clamp): each of the warp's threads takes whole
// rows.  A row is only copied when the filter reads it: its lane exists
// and has pixels in the tile, and the row lies within the tile's rows
// that have pixels, plus 7.
template <class Ref, int T>
__device__ __forceinline__ void gather(const McArgs& a, const Bucket& bk,
                                       const Place& p, int list,
                                       Buf<Ref>& buf, int lane) {
  using G = Geo<Ref, T>;
  const int fo = list * kListFields;
  const Ref* ref = static_cast<const Ref*>(a.ref);
  for (int k = lane; k < G::kRows; k += 32) {
    const int g = k / G::kW, r = k % G::kW;
    if (p.lane0 + g >= bk.n) continue;
    const int32_t* L = bk.rows + (p.lane0 + g) * kFields;
    const int hh = min(T, __ldg(L + F_H) - p.oy);
    if (r >= hh + 7 || __ldg(L + F_W) <= p.ox) continue;
    const int lx = __ldg(L + F_LX0 + fo), ly = __ldg(L + F_LY0 + fo);
    const int rb = __ldg(L + F_RB0 + fo), rs = __ldg(L + F_RS0 + fo);
    const int cx = __ldg(L + F_CX0 + fo) + p.ox;
    const int row = min(max(__ldg(L + F_CY0 + fo) + p.oy + r, 0), ly);
    const int i0 = rb + row * rs + cx;
    unsigned char* dst = buf.data + k * G::kPitch;
    if (cx >= 0 && cx + G::kW - 1 <= lx && i0 >= 0 &&
        i0 <= a.ref_len - G::kW) {
      if constexpr (sizeof(Ref) == 1) {
        // the aligned chunks around the row: they lie in the pages of
        // the reference, since each holds at least one of its bytes
        const uintptr_t at = reinterpret_cast<uintptr_t>(ref + i0);
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(at & ~uintptr_t{15});
        const int off = static_cast<int>(at & 15);
        buf.off[k] = static_cast<uint8_t>(off);
        for (int m = 0; m < (off + G::kW + 15) / 16; ++m)
          __pipeline_memcpy_async(dst + 16 * m, src + 16 * m, 16);
      } else {
#pragma unroll
        for (int c = 0; c < G::kW; ++c)
          __pipeline_memcpy_async(dst + 4 * c, ref + i0 + c, 4);
      }
    } else {
      if constexpr (sizeof(Ref) == 1) buf.off[k] = 0;
      Ref* d = reinterpret_cast<Ref*>(dst);
#pragma unroll
      for (int c = 0; c < G::kW; ++c) {
        const int col = min(max(cx + c, 0), lx);
        d[c] = ref[clampi(rb + row * rs + col, 0, a.ref_len - 1)];
      }
    }
  }
}

// Filters list `list` of the item from `buf`: this thread's column j of
// lane g.  List 0 of a compound item leaves its rounded sums in p0; list
// 1 blends.
template <class Ref, int T, bool Comp>
__device__ __forceinline__ void filter(const McArgs& a, const Bucket& bk,
                                       const Place& p, int list,
                                       const Buf<Ref>& buf, int lane,
                                       int (&p0)[T]) {
  using G = Geo<Ref, T>;
  const int g = lane / T, j = lane % T;
  if (p.lane0 + g >= bk.n) return;
  const int32_t* L = bk.rows + (p.lane0 + g) * kFields;
  const int hh = min(T, __ldg(L + F_H) - p.oy);
  if (j >= min(T, __ldg(L + F_W) - p.ox) || hh <= 0) return;
  const int fo = list * kListFields;
  const int hf = __ldg(L + F_HF0 + fo) * kTaps;
  const int vf = __ldg(L + F_VF0 + fo) * kTaps;
  int th[kTaps], tv[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) {
    th[q] = kFtab[hf + q];
    tv[q] = kFtab[vf + q];
  }
  const int r0 = a.bd == 12 ? 5 : 3;
  const int r1s = a.bd == 12 ? 9 : 11;
  const int hi = (1 << a.bd) - 1;
  const bool last = !Comp || list == 1;
  int w0 = 0, w1 = 0, sh = 1;
  if (Comp && last) {
    w0 = __ldg(L + F_W0);
    w1 = __ldg(L + F_W1);
    sh = __ldg(L + F_BSHIFT);
  }
  const int stride = __ldg(L + F_STRIDE);
  int32_t* out = a.frame + __ldg(L + F_BASE) +
                 (__ldg(L + F_Y) + p.oy) * stride + __ldg(L + F_X) + p.ox +
                 j;
  const unsigned char* win = buf.data + g * G::kW * G::kPitch;
  int ring[kTaps];
#pragma unroll
  for (int r = 0; r < G::kW; ++r) {
    if (r >= hh + 7) break;
    int at = r * G::kPitch;
    if constexpr (sizeof(Ref) == 1) at += buf.off[g * G::kW + r];
    const Ref* s = reinterpret_cast<const Ref*>(win + at) + j;
    int acc = 0;
#pragma unroll
    for (int q = 0; q < kTaps; ++q) acc += static_cast<int>(s[q]) * th[q];
    ring[r % kTaps] = round2(acc, r0);
    if (r < kTaps - 1) continue;
    const int i = r - (kTaps - 1);
    int v = 0;
#pragma unroll
    for (int q = 0; q < kTaps; ++q) v += ring[(i + q) % kTaps] * tv[q];
    if (!last) {
      p0[i] = round2(v, 7);
      continue;
    }
    int o;
    if (Comp) {
      const int s2 = w0 * p0[i] + w1 * round2(v, 7);
      o = (s2 + (1 << (sh - 1))) >> sh;
    } else {
      o = round2(v, r1s);
    }
    out[i * stride] = clampi(o, 0, hi);
  }
}

// Runs item `item` of bucket `bk`: for each list, its windows' copies,
// then the filter.
template <class Ref, int T, bool Comp>
__device__ void run_item(const McArgs& a, const Bucket& bk, int item,
                         Buf<Ref>& buf, int lane) {
  const Place p = place(bk, item);
  int p0[T];
#pragma unroll
  for (int list = 0; list <= static_cast<int>(Comp); ++list) {
    gather<Ref, T>(a, bk, p, list, buf, lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    filter<Ref, T, Comp>(a, bk, p, list, buf, lane, p0);
    __syncwarp();
  }
}

template <class Ref>
__global__ void __launch_bounds__(kWarps * 32) mc_kernel(const McArgs a) {
  __shared__ Buf<Ref> smem[kWarps];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int stride = static_cast<int>(gridDim.x) * kWarps;
  int bi = 0;
  for (int item = static_cast<int>(blockIdx.x) * kWarps + warp;
       item < a.items; item += stride) {
    while (bi + 1 < a.nb && item >= a.b[bi + 1].first) ++bi;
    const Bucket& bk = a.b[bi];
    switch ((bk.t < kTile ? bk.t : kTile) * 2 + bk.comp) {
      case 8:
        run_item<Ref, 4, false>(a, bk, item, smem[warp], lane);
        break;
      case 9:
        run_item<Ref, 4, true>(a, bk, item, smem[warp], lane);
        break;
      case 16:
        run_item<Ref, 8, false>(a, bk, item, smem[warp], lane);
        break;
      case 17:
        run_item<Ref, 8, true>(a, bk, item, smem[warp], lane);
        break;
      case 32:
        run_item<Ref, 16, false>(a, bk, item, smem[warp], lane);
        break;
      case 33:
        run_item<Ref, 16, true>(a, bk, item, smem[warp], lane);
        break;
      case 64:
        run_item<Ref, kTile, false>(a, bk, item, smem[warp], lane);
        break;
      default:
        run_item<Ref, kTile, true>(a, bk, item, smem[warp], lane);
        break;
    }
  }
}

using Kernel = void (*)(McArgs);

// Builds the item layout of the buckets into `a`; returns the items of
// the pass, or -1 for a bucket the kernel does not take.
long long plan(const long long* params, McArgs& a) {
  long long items = 0;
  for (int k = 0; k < a.nb; ++k) {
    Bucket& bk = a.b[k];
    bk.rows = reinterpret_cast<const int32_t*>(params[P_ROWS0 + k]);
    bk.t = static_cast<int>(params[P_T0 + k]);
    bk.comp = static_cast<int>(params[P_COMP0 + k]);
    bk.n = static_cast<int>(params[P_N0 + k]);
    if (bk.t < 4 || bk.t > kMaxT || (bk.t & (bk.t - 1)) || bk.n < 0 ||
        (bk.comp != 0 && bk.comp != 1) || bk.rows == nullptr)
      return -1;
    bk.first = static_cast<int>(items);
    const long long per = bk.t > kTile ? bk.t / kTile : 1;
    items += bk.t <= kTile
                 ? (static_cast<long long>(bk.n) + kTile / bk.t - 1) /
                       (kTile / bk.t)
                 : static_cast<long long>(bk.n) * per * per;
    if (items > 0x7fffffffLL) return -1;
  }
  return items;
}

// Launches `kernel` (slot `id` of the cache) with blocks of kWarps warps,
// one warp an item, up to the blocks resident at once on the current
// device (SMs x occupancy, queried once a device).
int launch(Kernel kernel, int id, const McArgs& a, cudaStream_t stream) {
  static std::atomic<int> cached[2][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  int resident = cached[id][dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kWarps * 32, 0);
    if (err != cudaSuccess) return err;
    // at least one block (a launch that cannot fit fails on its own)
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    cached[id][dev].store(resident, std::memory_order_relaxed);
  }
  const int need = (a.items + kWarps - 1) / kWarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(need < resident ? need : resident));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// Runs the MC pass of every lane of the `nb` buckets (nb <= kMaxBuckets)
// in one launch on `stream`.  `params`: kParams int64 in Param order.
// Returns the launch's error code (0: launched, or nothing to launch).
extern "C" int mc_frame(const long long* params, int nb, void* stream) {
  McArgs a;
  a.frame = reinterpret_cast<int32_t*>(params[P_FRAME]);
  a.ref = reinterpret_cast<const void*>(params[P_REF]);
  a.ref_len = static_cast<int>(params[P_REF_LEN]);
  a.bd = static_cast<int>(params[P_BD]);
  a.nb = nb;
  if (nb < 1 || nb > kMaxBuckets || params[P_NB] != nb || a.ref_len < 1 ||
      params[P_REF_LEN] > 0x7fffffffLL ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  const long long items = plan(params, a);
  if (items < 0) return cudaErrorInvalidValue;
  if (items == 0) return cudaSuccess;
  a.items = static_cast<int>(items);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params[P_REF_BYTES] == 1)
    return launch(mc_kernel<uint8_t>, 0, a, s);
  if (params[P_REF_BYTES] == 4)
    return launch(mc_kernel<int32_t>, 1, a, s);
  return cudaErrorInvalidValue;
}
