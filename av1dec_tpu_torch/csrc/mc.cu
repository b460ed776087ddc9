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
// What bounds it: bytes.  Each predicted pixel reads its reference pixel
// once per list (1 byte at 8 bits, 4 above: the packed reference is uint8
// or int32) and writes one int32; the lane rows are read once.  The 8-tap
// passes are 16 multiply-adds a pixel a list, far under the card's int32
// rate.  The eager version pays a launch for every array op of every
// bucket (hundreds a frame); this is one launch.
//
// Design: the host builds the grid from the buckets' (T, compound, lanes)
// alone (no device value is read: the pass runs under the scan's no-sync
// guard).  A block of kThreads threads takes one output tile of at most
// kTile x kTile pixels: a lane of T >= 32 is (T / 32)^2 tiles, one block
// each; lanes of T < 32 are packed kThreads / T^2 to a block.  For each
// list the block stages the tile's (t + 7) x (t + 7) reference window in
// shared memory with the plain version's clamps (row to [0, ly], column
// to [0, lx], flat index to [0, ref_len - 1]), runs the horizontal 8-tap
// pass with rounding r0 into a (t + 7) x t shared buffer, and the
// vertical pass into registers (kThreads pixels, 1 or 4 a thread).  A
// compound lane keeps list 0's sums in registers while list 1 reuses the
// buffers.  Then single-list output is Round2(v, r1s) and compound output
// Round2(w0 Round2(v0, 7) + w1 Round2(v1, 7), bshift), clipped to
// [0, 2^bd - 1], and only the pixels inside the lane's w x h window are
// written.  Blocks are independent: the lanes of a frame write disjoint
// pixels (InterPlan's lanes on the host, checked by the tests), so no order is
// needed; the trash slot of the frame buffer is never written.  All sums
// stay well inside int32 (12-bit pixels, 8 taps of at most 128).

#include <cuda_runtime.h>

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
constexpr int kTile = 32;        // output tile side of a block, at most
constexpr int kThreads = 256;
constexpr int kTaps = 8;
// shared words of the largest case: T = 4 (16 lanes of 11 x 11 windows)
// for the windows, T >= 32 (one 39 x 32 tile) for the horizontal sums
constexpr int kWinWords = 16 * 11 * 11;
constexpr int kMidWords = (kTile + 7) * kTile;
constexpr int kPerThread = kTile * kTile / kThreads;  // pixels, at most

struct Bucket {
  const int32_t* rows;
  int t;       // lane tile size T
  int comp;    // 1: both lists, blended
  int n;       // lanes
  int tile;    // output tile side, min(T, kTile)
  int per;     // tiles along a side of a lane (T >= kTile), else 1
  int items;   // lanes a block (T < kTile), else 1
  int first;   // the bucket's first block
};

struct McArgs {
  int32_t* frame;
  const void* ref;
  const int32_t* ftab;  // [6 * 16, 8] filter taps
  int ref_len;
  int bd;
  int nb;
  Bucket b[kMaxBuckets];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int round2(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

template <typename Ref>
__global__ void __launch_bounds__(kThreads) mc_kernel(const McArgs a) {
  __shared__ int32_t win[kWinWords];
  __shared__ int32_t mid[kMidWords];
  __shared__ int32_t lane[16][kFields];

  const int tid = threadIdx.x;
  int bi = 0;
  while (bi + 1 < a.nb && static_cast<int>(blockIdx.x) >= a.b[bi + 1].first)
    ++bi;
  const Bucket& bk = a.b[bi];
  const int local = static_cast<int>(blockIdx.x) - bk.first;
  const int t = bk.tile, items = bk.items;
  int lane0, oy = 0, ox = 0;
  if (bk.t >= kTile) {
    const int tiles = bk.per * bk.per, k = local % tiles;
    lane0 = local / tiles;
    oy = (k / bk.per) * kTile;
    ox = (k % bk.per) * kTile;
  } else {
    lane0 = local * items;
  }
  for (int k = tid; k < items * kFields; k += kThreads) {
    const int item = k / kFields, f = k % kFields;
    lane[item][f] = lane0 + item < bk.n
                        ? bk.rows[(lane0 + item) * kFields + f]
                        : 0;
  }
  __syncthreads();

  const int W = t + 7;
  const int npix = items * t * t;  // kThreads or kTile^2
  const int r0 = a.bd == 12 ? 5 : 3;
  const Ref* ref = static_cast<const Ref*>(a.ref);
  int v0[kPerThread], v1[kPerThread];
  for (int list = 0; list <= bk.comp; ++list) {
    const int fo = list * kListFields;
    for (int k = tid; k < items * W * W; k += kThreads) {
      const int item = k / (W * W), r = (k / W) % W, c = k % W;
      const int32_t* L = lane[item];
      const int row = min(max(L[F_CY0 + fo] + oy + r, 0), L[F_LY0 + fo]);
      const int col = min(max(L[F_CX0 + fo] + ox + c, 0), L[F_LX0 + fo]);
      const int idx = clampi(L[F_RB0 + fo] + row * L[F_RS0 + fo] + col, 0,
                             a.ref_len - 1);
      win[k] = static_cast<int32_t>(ref[idx]);
    }
    __syncthreads();
    for (int k = tid; k < items * W * t; k += kThreads) {
      const int item = k / (W * t), r = (k / t) % W, c = k % t;
      const int32_t* f = a.ftab + lane[item][F_HF0 + fo] * kTaps;
      const int32_t* s = win + item * W * W + r * W + c;
      int acc = 0;
#pragma unroll
      for (int q = 0; q < kTaps; ++q) acc += s[q] * f[q];
      mid[k] = round2(acc, r0);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      if (m * kThreads >= npix) break;
      const int k = tid + m * kThreads;
      const int item = k / (t * t), i = (k / t) % t, j = k % t;
      const int32_t* f = a.ftab + lane[item][F_VF0 + fo] * kTaps;
      const int32_t* s = mid + item * W * t + i * t + j;
      int acc = 0;
#pragma unroll
      for (int q = 0; q < kTaps; ++q) acc += s[q * t] * f[q];
      if (list == 0)
        v0[m] = acc;
      else
        v1[m] = acc;
    }
    __syncthreads();
  }

  const int hi = (1 << a.bd) - 1;
  const int r1s = a.bd == 12 ? 9 : 11;
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    if (m * kThreads >= npix) break;
    const int k = tid + m * kThreads;
    const int item = k / (t * t), i = oy + (k / t) % t, j = ox + k % t;
    const int32_t* L = lane[item];
    if (lane0 + item >= bk.n || i >= L[F_H] || j >= L[F_W]) continue;
    int out;
    if (bk.comp) {
      const int sh = L[F_BSHIFT];
      const int s = L[F_W0] * round2(v0[m], 7) + L[F_W1] * round2(v1[m], 7);
      out = (s + (1 << (sh - 1))) >> sh;
    } else {
      out = round2(v0[m], r1s);
    }
    a.frame[L[F_BASE] + (L[F_Y] + i) * L[F_STRIDE] + L[F_X] + j] =
        clampi(out, 0, hi);
  }
}

using Kernel = void (*)(McArgs);

// Builds the block layout of the buckets into `a`; returns the blocks of
// the launch, or -1 for a bucket the kernel does not take.
long long plan(const long long* params, McArgs& a) {
  long long blocks = 0;
  for (int k = 0; k < a.nb; ++k) {
    Bucket& bk = a.b[k];
    bk.rows = reinterpret_cast<const int32_t*>(params[P_ROWS0 + k]);
    bk.t = static_cast<int>(params[P_T0 + k]);
    bk.comp = static_cast<int>(params[P_COMP0 + k]);
    bk.n = static_cast<int>(params[P_N0 + k]);
    if (bk.t < 4 || bk.t > kMaxT || (bk.t & (bk.t - 1)) || bk.n < 0 ||
        (bk.comp != 0 && bk.comp != 1) || bk.rows == nullptr)
      return -1;
    bk.tile = bk.t < kTile ? bk.t : kTile;
    bk.per = bk.t / bk.tile;
    bk.items = bk.t < kTile ? kThreads / (bk.t * bk.t) : 1;
    if (bk.items < 1) bk.items = 1;
    bk.first = static_cast<int>(blocks);
    blocks += bk.t < kTile
                  ? (static_cast<long long>(bk.n) + bk.items - 1) / bk.items
                  : static_cast<long long>(bk.n) * bk.per * bk.per;
  }
  return blocks;
}

}  // namespace

// Runs the MC pass of every lane of the `nb` buckets (nb <= kMaxBuckets)
// in one launch on `stream`.  `params`: kParams int64 in Param order.
// Returns the launch's error code (0: launched, or nothing to launch).
extern "C" int mc_frame(const long long* params, int nb, void* stream) {
  McArgs a;
  a.frame = reinterpret_cast<int32_t*>(params[P_FRAME]);
  a.ref = reinterpret_cast<const void*>(params[P_REF]);
  a.ftab = reinterpret_cast<const int32_t*>(params[P_FTAB]);
  a.ref_len = static_cast<int>(params[P_REF_LEN]);
  a.bd = static_cast<int>(params[P_BD]);
  a.nb = nb;
  if (nb < 1 || nb > kMaxBuckets || params[P_NB] != nb || a.ref_len < 1 ||
      (a.bd != 8 && a.bd != 10 && a.bd != 12))
    return cudaErrorInvalidValue;
  const long long blocks = plan(params, a);
  if (blocks < 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  Kernel kernel;
  if (params[P_REF_BYTES] == 1)
    kernel = mc_kernel<uint8_t>;
  else if (params[P_REF_BYTES] == 4)
    kernel = mc_kernel<int32_t>;
  else
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}
