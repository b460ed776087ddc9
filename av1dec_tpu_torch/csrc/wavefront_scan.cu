// The wavefront intra reconstruction scan of one batch [SPEC §7.11.2],
// hand-written for Hopper (sm_90a): one persistent launch for every level.
//
// Replaces, on the CUDA path of av1dec_tpu_torch, the XLA-compiled window
// scan of the JAX package: av1dec_tpu/ops/kernels/wavefront.py:343
// (_apply_bucket, under lax.scan in run_wavefront_chunk :465).  Its plain
// version is _scan_plain in av1dec_tpu_torch/ops/kernels/wavefront.py (the
// eager window loop over _apply_bucket); the two agree byte for byte.
//
// What bounds it: the chain of levels.  A level holds tens of lanes (one
// transform block each); every lane's prediction reads pixels written at
// strictly earlier levels (pipeline/wavefront.py), so a 4-frame 1080p
// batch is a chain of a few hundred dependent steps.  Its bytes (lane
// rows, residuals, palettes, the frame written once) and integer
// operations take tens of microseconds; each link of the chain costs at
// least one round trip through L2: a lane sees its previous level's
// counter, gathers its edges, computes, writes and publishes.
// wavefront_scan_floor runs that protocol over the same tickets with no
// pixel work: its time is the chain term of this design.
//
// Design: one launch of min(lanes, SMs x resident blocks) blocks of
// kThreads threads.  The host orders every lane of the batch once, level
// by level (levels with lanes only, buckets in order inside a level): the
// ticket table (plan_levels).  A block takes its next ticket from a global
// counter (atomicAdd), loads all that does not depend on the frame (the
// lane row, its residual, a palette lane's whole prediction) into shared
// memory, and only then waits: thread 0 polls done[level - 1] (an acquire
// load at device scope, __nanosleep back-off) until it holds the lane
// count of the previous level with lanes.  The block computes the lane,
// writes its pixels, syncs, and thread 0 publishes with __threadfence and
// a release add to done[level]; the block takes its next ticket.  While
// level l runs, the blocks holding later tickets have their inputs in
// shared memory.  The counters (the ticket counter, then done[] of each
// level with lanes, kCounterStride ints apart so that pollers of
// different levels meet on different L2 lines) are zeroed by the wrapper
// for each launch; the kernel allocates nothing.
//
// Why it cannot deadlock: a lane waits only on lanes of smaller tickets.
// Tickets are taken in order, only by blocks that are running, and a
// block keeps its ticket until it has published it.  So the smallest
// unpublished ticket waits on nothing unpublished and its block is
// running: the scan always advances, whatever blocks are resident, and no
// cooperative launch is needed (blocks that start after the last ticket
// was taken exit at once).  A wait longer than kWaitLimitNs of
// %globaltimer traps, so a wrong ticket table ends in a CUDA error at the
// next synchronisation, not in a hung card.
//
// Memory order: every read of the frame (edges, corner, CfL's luma, an
// MF_INTER lane's MC prediction) goes through __ldcg, L2 only: L1 is not
// coherent across SMs, and a block may hold lines from an earlier lane.
//
// Per lane: the block gathers the lane's above/left edges and corner into
// shared memory with the clamps of _gather_edges, computes only its own
// mode family (the plain version computes every cheap family and selects),
// adds the residual, clips and writes its w x h pixels; nothing else of
// the frame is written.  Filter-intra runs its 4x2 patches in
// anti-diagonal order in a shared (w+1) x (h+1) buffer (a patch reads only
// its left, above and above-left patches, so the patches of one diagonal
// are independent).  Every index is clamped as the plain version clamps
// it, so the kept pixels read the same values.  A left shift of a value
// that may be negative is written as a multiply (undefined in C++17); >>
// on signed ints is arithmetic.

#include <cuda_runtime.h>
#include <cuda/atomic>

#include <atomic>
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

// Columns of the ticket table (plan_levels, _TICKET in
// ops/kernels/wavefront.py): a lane's bucket and row, its level's index
// among the levels with lanes, and the lane count of the level before it
// that done[level - 1] must reach (0 at the first level).
enum Ticket : int {
  K_BUCKET = 0,
  K_ROW = 1,
  K_LEVEL = 2,
  K_WAIT = 3,
  kTicketFields = 4
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
  P_TICKETS = 8,
  P_COUNTERS = 9,
  P_KERN = 10,
  P_SM = 11,
  P_FI_TAPS = 12,
  P_N = 13,
  P_RES_LEN = 14,
  P_RES_BYTES = 15,
  P_SM_LEN = 16,
  P_NB = 17,
  P_T0 = 18,
  P_T1 = 19,
  P_T2 = 20,
  P_BD = 21,
  P_SUB_X = 22,
  P_SUB_Y = 23,
  P_EEF = 24,
  kParams = 25
};

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 3;
constexpr int kMaxT = 64;
constexpr int kEdge = 2 * kMaxT + 1;  // corner + 2T edge pixels
constexpr int kLut = 4 * kMaxT + 3;   // directional LUT, indices 0..4T+2
constexpr int kFiBuf = 33 * 33;       // filter-intra blocks are <= 32x32
constexpr int kKern = 4 * 5;          // edge filter kernels (_KERN)
constexpr int kSmLen = 128;           // smooth weights (SM_WEIGHTS)
constexpr int kFiTaps = 5 * 8 * 7;    // filter-intra taps (_FI_TAPS)
// ints from one level's done counter to the next (128 bytes: an L2 line)
constexpr int kCounterStride = 32;
// a wait this long (ns of %globaltimer) means a wrong ticket table: trap
constexpr unsigned long long kWaitLimitNs = 2000000000ull;
constexpr unsigned kMaxBackoffNs = 256;  // polling interval cap
constexpr int kMaxDevices = 64;

struct ScanArgs {
  int32_t* frame;  // [n + 1]; slot n is the plain version's trash slot
  const void* res;
  const int32_t* rows[kMaxBuckets];  // [N_b, kFields]
  const int32_t* pal[kMaxBuckets];   // [P_b, T_b, T_b]
  const int32_t* tickets;            // [tickets, kTicketFields]
  int* counters;  // [(levels + 1) * kCounterStride]: ticket, done[]
  const int32_t* kern;     // [4, 5]
  const int32_t* sm;       // [sm_len]
  const int32_t* fi_taps;  // [5, 8, 7]
  int tickets_n, n, res_len, sm_len, nb;
  int ts[kMaxBuckets];
  int bd, sub_x, sub_y, eef;
};

// A block's shared memory: the tables (loaded once), the lane being run
// and its scratch.
struct Smem {
  int kern[kKern], sm[kSmLen], fi_taps[kFiTaps];
  int ticket[kTicketFields + 1];  // the ticket's index, then its columns
  int row[kFields];
  int pre[kMaxT * kMaxT];  // residual; a palette lane's final pixels
  int above[kEdge], left[kEdge];
  int filt[2][kEdge];
  int lut[2][kLut];
  int fibuf[kFiBuf];
  int red[kThreads / 32 + 1];
  int dc_sum[2];
  int corner_v;
};

using DeviceAtomic = cuda::atomic_ref<int, cuda::thread_scope_device>;

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

// %globaltimer, in ns (the CPU rehearsal of tests/cuda_cpu_shim.h, which
// compiles this file with g++, reads a host clock instead)
__device__ __forceinline__ unsigned long long globaltimer_ns() {
#ifdef CUDA_CPU_SHIM
  return cuda_cpu_shim_ns();
#else
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#endif
}

// Thread 0 of the block: the next ticket into s.ticket (its index, then
// its columns when it is one of the batch's).
__device__ __forceinline__ void take_ticket(const ScanArgs& a, Smem& s) {
  const int t = atomicAdd(a.counters, 1);
  s.ticket[0] = t;
  if (t < a.tickets_n)
    for (int k = 0; k < kTicketFields; ++k)
      s.ticket[1 + k] = a.tickets[(size_t)t * kTicketFields + k];
}

// Thread 0 of the block: wait until done[level - 1] holds `want` (acquire
// at device scope); trap after kWaitLimitNs.
__device__ __forceinline__ void wait_level(const ScanArgs& a, int level,
                                           int want) {
  if (level == 0) return;
  DeviceAtomic done(a.counters[level * kCounterStride]);
  if (done.load(cuda::std::memory_order_acquire) >= want) return;
  const unsigned long long t0 = globaltimer_ns();
  unsigned ns = 32;
  while (done.load(cuda::std::memory_order_acquire) < want) {
    __nanosleep(ns);
    ns = min(2 * ns, kMaxBackoffNs);
    if (globaltimer_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// Thread 0 of the block, after a __syncthreads that follows the lane's
// writes: make them visible at device scope, then count the lane done.
__device__ __forceinline__ void publish(const ScanArgs& a, int level) {
  __threadfence();
  DeviceAtomic(a.counters[(level + 1) * kCounterStride])
      .fetch_add(1, cuda::std::memory_order_release);
}

// One lane (s.row, bucket's T) after its wait: edges, prediction,
// residual (s.pre), clip and write.
__device__ __forceinline__ void run_lane(const ScanArgs& a, Smem& s,
                                         int T) {
  const int tid = threadIdx.x;
  const int* row = s.row;
  int* const above = s.above;
  int* const left = s.left;
  int32_t* frame = a.frame;
  const int n = a.n, bd = a.bd;
  const int maxv = (1 << bd) - 1;
  const int x = row[F_X], y = row[F_Y];
  const int base = row[F_BASE], stride = row[F_STRIDE];
  const int mf = row[F_MODE_FAMILY];
  const int w = row[F_W], h = row[F_H], lw = row[F_LW];
  auto at = [&](int idx) { return __ldcg(frame + clampi(idx, 0, n - 1)); };

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
      int sum = 0;
      for (int k = lane; k < cnt; k += 32) sum += e[1 + k];
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) s.dc_sum[warp] = sum;
    }
    __syncthreads();
    const int s_a = s.dc_sum[0], s_l = s.dc_sum[1];
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
        s.corner_v = row[F_CORNER_FILT] > 0
                         ? (left[1] * 5 + above[0] * 6 + above[1] * 5 + 8) >> 4
                         : above[0];
        above[0] = s.corner_v;
        left[0] = s.corner_v;
      }
      __syncthreads();
      for (int k = tid; k < 2 * (size + 1); k += kThreads) {
        const int side = k > size;
        const int i = side ? k - size - 1 : k;
        s.filt[side][i] =
            side ? edge_filter_px(left, i, row[F_NPX_LEFT], row[F_STR_LEFT],
                                  size, s.kern)
                 : edge_filter_px(above, i, row[F_NPX_ABOVE],
                                  row[F_STR_ABOVE], size, s.kern);
      }
      __syncthreads();
      eA = s.filt[0];
      eL = s.filt[1];
    }
    const int p_angle = row[F_P_ANGLE];
    const int npx_a = w + (p_angle < 90 ? h : 0);
    const int npx_l = h + (p_angle > 180 ? w : 0);
    const int lutlen = 4 * T + 3;
    for (int k = tid; k < 2 * lutlen; k += kThreads) {
      const int side = k >= lutlen;
      const int kk = side ? k - lutlen : k;
      s.lut[side][kk] =
          side ? lut_entry(eL, kk, T, row[F_UP_LEFT], npx_l, maxv)
               : lut_entry(eA, kk, T, row[F_UP_ABOVE], npx_a, maxv);
    }
    __syncthreads();
  } else if (mf == MF_FI) {
    // serial 4x2 patch recursion [SPEC §7.11.2.3], by anti-diagonals
    int* const fibuf = s.fibuf;
    const int W1 = w + 1;
    for (int k = tid; k < (h + 1) * W1; k += kThreads) {
      const int r = k / W1, c = k - r * W1;
      fibuf[k] = r == 0 ? above[c] : c == 0 ? left[r] : 0;
    }
    __syncthreads();
    const int nc = w >> 2, nr = h >> 1;
    const int* tv = s.fi_taps + 56 * clampi(row[F_FI_MODE], 0, 4);
    for (int d = 0; d < nr + nc - 1; ++d) {
      for (int t = tid; t < nc * 8; t += kThreads) {
        const int sj = t >> 3, k = t & 7, si = d - sj;
        if (si < 0 || si >= nr) continue;
        const int i = 1 + 2 * si, j = 1 + 4 * sj;
        const int o = (i - 1) * W1 + (j - 1);
        const int pv[7] = {fibuf[o],     fibuf[o + 1],  fibuf[o + 2],
                           fibuf[o + 3], fibuf[o + 4],  fibuf[o + W1],
                           fibuf[o + 2 * W1]};
        int sum = 0;
#pragma unroll
        for (int m = 0; m < 7; ++m) sum += tv[k * 7 + m] * pv[m];
        const int v = sum >= 0 ? (sum + 8) >> 4 : -((-sum + 8) >> 4);
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
    auto lat = [&](int idx) { return __ldcg(frame + min(idx, n - 1)); };
    if (sub_x && sub_y)
      return (lat(bb) + lat(bb + 1) + lat(bb + lstride) +
              lat(bb + lstride + 1))
             << 1;
    if (sub_x) return (lat(bb) + lat(bb + 1)) << 2;
    return lat(bb) << 3;
  };
  const int npix = w * h;
  if (cfl) {
    int sum = 0;
    for (int p = tid; p < npix; p += kThreads)
      sum += cfl_t(p >> lw, p & (w - 1));
    const int tot = block_sum(sum, s.red);
    const int shift = row[F_LW] + row[F_LH];
    cfl_avg = (tot + (1 << max(shift - 1, 0))) >> shift;
  }

  // predict, add the residual, clip, write the w x h pixels
  const bool has_res = row[F_RES_IDX] >= 0;
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
        v = dir_px(s.lut[0], s.lut[1], i, j, w, h, T, row[F_P_ANGLE],
                   row[F_DX], row[F_DY], row[F_UP_ABOVE], row[F_UP_LEFT]);
        break;
      case MF_FI:
        v = s.fibuf[(i + 1) * (w + 1) + (j + 1)];
        break;
      case MF_INTER:
        // the MC pass wrote this block's prediction into the frame
        v = at(fidx);
        break;
      default: {
        // the smooth modes [SPEC §7.11.2.6] (_smooth_all)
        const int sw_w = s.sm[clampi(w + j, 0, sm_top)];
        const int sw_h = s.sm[clampi(h + i, 0, sm_top)];
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
    // a palette lane's pixels were finished before the wait
    if (mf == MF_PAL)
      v = s.pre[p];
    else if (has_res)
      v = clampi(v + s.pre[p], 0, maxv);
    if (fidx >= 0 && fidx < n) frame[fidx] = v;
  }
}

// The scan (kPixels) or its protocol alone (the floor: tickets, waits and
// publishes, no pixel work), until the tickets run out.
template <typename Res, bool kPixels>
__device__ __forceinline__ void scan_blocks(const ScanArgs& a) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  if constexpr (kPixels) {
    for (int k = tid; k < kKern; k += kThreads) s.kern[k] = a.kern[k];
    for (int k = tid; k < a.sm_len; k += kThreads) s.sm[k] = a.sm[k];
    for (int k = tid; k < kFiTaps; k += kThreads) s.fi_taps[k] = a.fi_taps[k];
  }
  for (;;) {
    if (tid == 0) take_ticket(a, s);
    __syncthreads();
    if (s.ticket[0] >= a.tickets_n) return;
    const int bucket = s.ticket[1 + K_BUCKET];
    const int level = s.ticket[1 + K_LEVEL];
    if constexpr (kPixels) {
      // all that does not depend on the frame: the lane row, the residual
      // and a palette lane's prediction
      const int T = a.ts[bucket];
      const int32_t* src =
          a.rows[bucket] + (size_t)s.ticket[1 + K_ROW] * kFields;
      if (tid < kFields) s.row[tid] = src[tid];
      __syncthreads();
      const int w = s.row[F_W], lw = s.row[F_LW];
      const int npix = w * s.row[F_H];
      const int res_idx = s.row[F_RES_IDX];
      const bool pal = s.row[F_MODE_FAMILY] == MF_PAL;
      const int32_t* pmap =
          pal ? a.pal[bucket] + (size_t)max(s.row[F_PAL_IDX], 0) * T * T
              : nullptr;
      const int maxv = (1 << a.bd) - 1;
      for (int p = tid; p < npix; p += kThreads) {
        const int i = p >> lw, j = p & (w - 1);
        const int r =
            res_idx >= 0
                ? static_cast<int>(static_cast<const Res*>(
                      a.res)[clampi(res_idx + i * w + j, 0, a.res_len - 1)])
                : 0;
        if (pal) {
          const int v = pmap[i * T + j];
          s.pre[p] = res_idx >= 0 ? clampi(v + r, 0, maxv) : v;
        } else {
          s.pre[p] = r;
        }
      }
    }
    if (tid == 0) wait_level(a, level, s.ticket[1 + K_WAIT]);
    __syncthreads();
    if constexpr (kPixels) run_lane(a, s, a.ts[bucket]);
    __syncthreads();
    if (tid == 0) publish(a, level);
  }
}

template <typename Res>
__global__ void __launch_bounds__(kThreads)
    wavefront_scan_kernel(const ScanArgs a) {
  scan_blocks<Res, true>(a);
}

__global__ void __launch_bounds__(kThreads)
    wavefront_floor_kernel(const ScanArgs a) {
  scan_blocks<int16_t, false>(a);
}

using Kernel = void (*)(ScanArgs);

// Launches `kernel` (kernel `id` of 3: its cache slot) with one block for
// each ticket, up to the blocks resident at once on the current device
// (SMs x occupancy, queried once a device).  Returns the error code.
int launch(Kernel kernel, int id, ScanArgs a, cudaStream_t stream) {
  static std::atomic<int> cached[3][kMaxDevices];
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
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    cached[id][dev].store(resident, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tickets_n < resident ? a.tickets_n : resident);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

ScanArgs unpack(const long long* params, int tickets) {
  ScanArgs a;
  a.frame = reinterpret_cast<int32_t*>(params[P_FRAME]);
  a.res = reinterpret_cast<const void*>(params[P_RES]);
  for (int k = 0; k < kMaxBuckets; ++k) {
    a.rows[k] = reinterpret_cast<const int32_t*>(params[P_ROWS0 + k]);
    a.pal[k] = reinterpret_cast<const int32_t*>(params[P_PAL0 + k]);
    a.ts[k] = static_cast<int>(params[P_T0 + k]);
  }
  a.tickets = reinterpret_cast<const int32_t*>(params[P_TICKETS]);
  a.counters = reinterpret_cast<int*>(params[P_COUNTERS]);
  a.kern = reinterpret_cast<const int32_t*>(params[P_KERN]);
  a.sm = reinterpret_cast<const int32_t*>(params[P_SM]);
  a.fi_taps = reinterpret_cast<const int32_t*>(params[P_FI_TAPS]);
  a.tickets_n = tickets;
  a.n = static_cast<int>(params[P_N]);
  a.res_len = static_cast<int>(params[P_RES_LEN]);
  a.sm_len = static_cast<int>(params[P_SM_LEN]);
  a.nb = static_cast<int>(params[P_NB]);
  a.bd = static_cast<int>(params[P_BD]);
  a.sub_x = static_cast<int>(params[P_SUB_X]);
  a.sub_y = static_cast<int>(params[P_SUB_Y]);
  a.eef = static_cast<int>(params[P_EEF]);
  return a;
}

}  // namespace

// Runs the scan of every lane of the ticket table (`tickets` of them) in
// one launch on `stream`.  `params`: kParams int64 in Param order; the
// counters zeroed.  Returns the launch's error code (0: launched).
extern "C" int wavefront_scan(const long long* params, int tickets,
                              void* stream) {
  const ScanArgs a = unpack(params, tickets);
  if (tickets <= 0 || a.sm_len > kSmLen || a.nb < 1 || a.nb > kMaxBuckets)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (params[P_RES_BYTES] == 2)
    return launch(wavefront_scan_kernel<int16_t>, 0, a, s);
  if (params[P_RES_BYTES] == 4)
    return launch(wavefront_scan_kernel<int32_t>, 1, a, s);
  return cudaErrorInvalidValue;
}

// The same launch, tickets, waits and publishes with no pixel work (no
// frame, residual or lane row is read): the chain term of the scan of
// these tickets.  Same arguments; returns the launch's error code.
extern "C" int wavefront_scan_floor(const long long* params, int tickets,
                                    void* stream) {
  const ScanArgs a = unpack(params, tickets);
  if (tickets <= 0) return cudaErrorInvalidValue;
  return launch(wavefront_floor_kernel, 2, a,
                static_cast<cudaStream_t>(stream));
}
