// A CPU stand-in for the CUDA runtime and the device intrinsics that the
// kernels of av1dec_tpu_torch/csrc/ use (wavefront_scan.cu, mc.cu,
// itx.cu, deblock.cu, wiener.cu, superres.cu), so that g++ compiles the
// exact source and runs its kernels on the host
// (tests/test_torch_scan_shim.py, tests/test_torch_mc_shim.py,
// tests/test_torch_itx_shim.py, tests/test_torch_postfilter_shim.py).
// The test puts three one-line headers,
// cuda_runtime.h, cuda_pipeline.h and cuda/atomic, that include this file
// on the include path, and compiles with -std=c++20 -pthread
// -DCUDA_CPU_SHIM_MAIN (and -DCUDA_CPU_SHIM_ENTRY=name for a kernel other
// than the scan).
//
// A thread block is a process (fork), so that `__shared__`, which is
// `static` here, is the block's own, and the blocks of a launch run at
// once; a CUDA thread is a thread of that process.  With 0 or fewer
// resident blocks (`cuda_cpu_shim_resident`), for kernels whose blocks
// never wait on each other and whose threads wait only at barriers, the
// blocks run one after another in this process, by one set of CUDA
// threads that meet at a barrier between blocks, each a fiber
// (ucontext) of this one OS thread that hands over to the next at every
// barrier.  The buffers the
// blocks write (the frame and the counters) are mapped shared by the
// runner (main, below).  __syncthreads, __syncwarp and __shfl_xor_sync
// are barriers of the block's or the warp's threads; __shfl_sync,
// __shfl_up_sync and __ballot_sync are warp exchanges like
// __shfl_xor_sync, __popc and __ffs the compiler's bit counts; int4 and
// make_int4 the vector type's fields, __align__ the compiler's attribute; cp.async (__pipeline_memcpy_async) is
// a memcpy, so __pipeline_commit and __pipeline_wait_prior do nothing; a
// kernel's dynamic shared memory is cuda_cpu_shim_dynamic_smem();
// atomicAdd, atomicCAS, cuda::atomic_ref and __threadfence are the host's
// atomics and fences; __ldcg is a plain
// (relaxed atomic) load, __ldg a load; __nanosleep yields;
// %globaltimer is the steady clock; __trap aborts the block, and the
// launch then returns an error.  The device has one SM, on which
// |`cuda_cpu_shim_resident`| blocks are resident (the occupancy query's
// answer).
#pragma once

#include <sched.h>
#include <sys/mman.h>
#include <sys/wait.h>
#include <ucontext.h>
#include <unistd.h>

#include <atomic>
#include <barrier>
#include <chrono>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <new>
#include <string>
#include <thread>
#include <vector>

#define CUDA_CPU_SHIM 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __constant__

struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

using cudaStream_t = void*;
enum cudaError_t : int {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorLaunchFailure = 719
};
enum cudaDeviceAttr : int { cudaDevAttrMultiProcessorCount = 16 };

inline int cuda_cpu_shim_resident = 1;

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = cuda_cpu_shim_resident < 0 ? -cuda_cpu_shim_resident
                                  : cuda_cpu_shim_resident;
  return cudaSuccess;
}

template <class T>
inline T min(T a, T b) {
  return b < a ? b : a;
}
template <class T>
inline T max(T a, T b) {
  return a < b ? b : a;
}

// The CUDA threads of a launch whose blocks run one after another, as
// fibers of this one OS thread: each runs until it waits at a barrier or
// ends, then the next one runs, so that the launch needs no core of its
// own a thread.
struct CudaCpuShimFibers {
  static constexpr size_t kStack = 1 << 18;
  std::vector<ucontext_t> ctx;
  std::vector<std::unique_ptr<char[]>> stacks;
  std::vector<unsigned> block_of;  // the block each one is in
  std::vector<char> done;
  ucontext_t main;
  int cur = 0;
};
inline CudaCpuShimFibers* cuda_cpu_shim_fibers = nullptr;

// A barrier of `count` threads: OS threads wait in a std::barrier,
// fibers hand over to the next fiber until the last one arrives.
struct CudaCpuShimBarrier {
  explicit CudaCpuShimBarrier(int count) : os(count), count(count) {}
  void arrive_and_wait() {
    auto* f = cuda_cpu_shim_fibers;
    if (f == nullptr) {
      os.arrive_and_wait();
      return;
    }
    const unsigned g = gen;
    if (++arrived == count) {
      arrived = 0;
      ++gen;
      return;
    }
    while (gen == g) swapcontext(&f->ctx[f->cur], &f->main);
  }
  std::barrier<> os;
  int count, arrived = 0;
  unsigned gen = 0;
};

// the barriers of the block this process runs
struct CudaCpuShimBlock {
  std::unique_ptr<CudaCpuShimBarrier> block;
  std::vector<std::unique_ptr<CudaCpuShimBarrier>> warps;
  int shfl[32][32];
  std::vector<long long> dynamic_smem;  // the launch's bytes, 8-aligned
};
inline CudaCpuShimBlock* cuda_cpu_shim_block = nullptr;

// The block's dynamic shared memory (`extern __shared__` on the card).
inline void* cuda_cpu_shim_dynamic_smem() {
  return cuda_cpu_shim_block->dynamic_smem.data();
}

inline void __syncthreads() {
  cuda_cpu_shim_block->block->arrive_and_wait();
}
// __syncwarp calls of the launch's threads, over all its blocks (main
// maps it shared, so that forked blocks count into it)
inline std::atomic<long long>* cuda_cpu_shim_warp_syncs = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) {
  if (cuda_cpu_shim_warp_syncs)
    cuda_cpu_shim_warp_syncs->fetch_add(1, std::memory_order_relaxed);
  cuda_cpu_shim_block->warps[threadIdx.x >> 5]->arrive_and_wait();
}
// the value of lane from(lane) of the warp (every lane takes part)
template <class From>
inline int cuda_cpu_shim_shfl(int v, From from) {
  const unsigned warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto& b = *cuda_cpu_shim_block;
  b.shfl[warp][lane] = v;
  b.warps[warp]->arrive_and_wait();
  const int got = b.shfl[warp][from(lane)];
  b.warps[warp]->arrive_and_wait();
  return got;
}
inline int __shfl_xor_sync(unsigned, int v, int lane_mask) {
  return cuda_cpu_shim_shfl(v, [=](unsigned l) { return l ^ lane_mask; });
}
inline int __shfl_sync(unsigned, int v, int src) {
  return cuda_cpu_shim_shfl(v, [=](unsigned) { return src & 31; });
}
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  return cuda_cpu_shim_shfl(
      v, [=](unsigned l) { return l >= delta ? l - delta : l; });
}
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned bits = 0;
  for (unsigned l = 0; l < 32; ++l)  // every lane reads every lane's vote
    bits |= static_cast<unsigned>(cuda_cpu_shim_shfl(
                pred != 0, [=](unsigned) { return l; })) << l;
  return bits;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
template <class T>
inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// cp.async: the copy is done at once, so a wait has nothing to wait for
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicCAS(unsigned long long* p,
                                    unsigned long long cmp,
                                    unsigned long long v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __nanosleep(unsigned) { sched_yield(); }
[[noreturn]] inline void __trap() {
  std::fprintf(stderr, "cuda_cpu_shim: __trap in block %u\n", blockIdx.x);
  std::abort();
}
inline unsigned long long cuda_cpu_shim_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

namespace cuda {
enum thread_scope { thread_scope_system, thread_scope_device,
                    thread_scope_block };
namespace std {
using ::std::memory_order;
using ::std::memory_order_acquire;
using ::std::memory_order_relaxed;
using ::std::memory_order_release;
}  // namespace std
template <class T, thread_scope>
struct atomic_ref : ::std::atomic_ref<T> {
  using ::std::atomic_ref<T>::atomic_ref;
};
}  // namespace cuda

struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
};

// The body of each fiber of a launch whose blocks run one after another
// (set by cudaLaunchKernelEx: its thread index runs every block).
inline std::function<void(unsigned)> cuda_cpu_shim_fiber_body;

inline void cuda_cpu_shim_fiber_main() {
  cuda_cpu_shim_fiber_body(static_cast<unsigned>(cuda_cpu_shim_fibers->cur));
  cuda_cpu_shim_fibers->done[cuda_cpu_shim_fibers->cur] = 1;
}

// Runs the config's grid of kernel f: with a resident count above 0,
// each block a forked process of blockDim.x threads, all at once, and
// waits for them (an error if a block failed); else the blocks one after
// another in this process, their threads as fibers that meet at a
// barrier between blocks.
template <class A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                               void (*f)(A), A arg) {
  const dim3 grid = config->gridDim, block = config->blockDim;
  std::fflush(nullptr);
  if (cuda_cpu_shim_resident <= 0) {
    blockDim = block;
    gridDim = grid;
    CudaCpuShimBlock state;
    state.block = std::make_unique<CudaCpuShimBarrier>(block.x);
    state.dynamic_smem.resize((config->dynamicSmemBytes + 7) / 8);
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
      state.warps.push_back(std::make_unique<CudaCpuShimBarrier>(32));
    cuda_cpu_shim_block = &state;
    CudaCpuShimFibers fibers;
    fibers.ctx.resize(block.x);
    fibers.block_of.assign(block.x, 0);
    fibers.done.assign(block.x, 0);
    cuda_cpu_shim_fiber_body = [&](unsigned t) {
      for (unsigned b = 0; b < grid.x; ++b) {
        fibers.block_of[t] = blockIdx.x = b;
        f(arg);
        state.block->arrive_and_wait();
      }
    };
    for (unsigned t = 0; t < block.x; ++t) {
      fibers.stacks.emplace_back(new char[CudaCpuShimFibers::kStack]);
      ucontext_t& c = fibers.ctx[t];
      getcontext(&c);
      c.uc_stack.ss_sp = fibers.stacks.back().get();
      c.uc_stack.ss_size = CudaCpuShimFibers::kStack;
      c.uc_link = &fibers.main;
      makecontext(&c, cuda_cpu_shim_fiber_main, 0);
    }
    cuda_cpu_shim_fibers = &fibers;
    for (unsigned live = block.x; live > 0;) {
      for (unsigned t = 0; t < block.x; ++t) {
        if (fibers.done[t]) continue;
        fibers.cur = static_cast<int>(t);
        threadIdx.x = t;
        blockIdx.x = fibers.block_of[t];
        swapcontext(&fibers.main, &fibers.ctx[t]);
        if (fibers.done[t]) --live;
      }
    }
    cuda_cpu_shim_fibers = nullptr;
    cuda_cpu_shim_block = nullptr;
    return cudaSuccess;
  }
  std::vector<pid_t> kids;
  for (unsigned b = 0; b < grid.x; ++b) {
    const pid_t pid = fork();
    if (pid < 0) return cudaErrorLaunchFailure;
    if (pid == 0) {
      blockDim = block;
      gridDim = grid;
      CudaCpuShimBlock state;
      state.block = std::make_unique<CudaCpuShimBarrier>(block.x);
      state.dynamic_smem.resize((config->dynamicSmemBytes + 7) / 8);
      for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
        state.warps.push_back(std::make_unique<CudaCpuShimBarrier>(32));
      cuda_cpu_shim_block = &state;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([=] {
          threadIdx.x = t;
          blockIdx.x = b;
          f(arg);
        });
      for (auto& th : threads) th.join();
      std::fflush(nullptr);
      _exit(0);
    }
    kids.push_back(pid);
  }
  bool ok = true;
  for (const pid_t pid : kids) {
    int status = 0;
    waitpid(pid, &status, 0);
    ok = ok && WIFEXITED(status) && WEXITSTATUS(status) == 0;
  }
  return ok ? cudaSuccess : cudaErrorLaunchFailure;
}

#ifdef CUDA_CPU_SHIM_MAIN
#ifdef CUDA_CPU_SHIM_ENTRY
extern "C" int CUDA_CPU_SHIM_ENTRY(const long long*, int, void*);
#else
extern "C" int wavefront_scan(const long long*, int, void*);
extern "C" int wavefront_scan_floor(const long long*, int, void*);
#endif

// shim DIR ENTRY RESIDENT TICKETS: DIR/params.txt holds one line a
// parameter, "i VALUE", "p FILE SHARED" or "o FILE SHARED OFFSET"; a
// pointer parameter points at FILE's bytes (mapped shared when SHARED is
// 1, and then written back to FILE.out after the launch), OFFSET bytes
// in for "o" (a view that starts inside a buffer).  ENTRY: scan or floor, or anything with
// CUDA_CPU_SHIM_ENTRY, which is then called; RESIDENT 0 runs the blocks
// one after another (RESIDENT -n too, with n blocks resident); TICKETS
// is the entry's int argument.  Prints on
// stderr the __syncwarp calls of the launch's threads, then the entry's
// return code, and exits with it.
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const std::string dir = argv[1];
  cuda_cpu_shim_resident = std::atoi(argv[3]);
  struct Buf {
    std::string file;
    void* p;
    size_t bytes;
  };
  std::vector<long long> params;
  std::vector<Buf> shared;
  FILE* pf = std::fopen((dir + "/params.txt").c_str(), "r");
  if (!pf) return 2;
  char kind[2];
  while (std::fscanf(pf, "%1s", kind) == 1) {
    if (kind[0] == 'i') {
      long long v;
      if (std::fscanf(pf, "%lld", &v) != 1) return 2;
      params.push_back(v);
      continue;
    }
    char name[256];
    int is_shared;
    long long offset = 0;
    if (std::fscanf(pf, "%255s %d", name, &is_shared) != 2) return 2;
    if (kind[0] == 'o' && std::fscanf(pf, "%lld", &offset) != 1) return 2;
    FILE* f = std::fopen((dir + "/" + name).c_str(), "rb");
    if (!f) return 2;
    std::fseek(f, 0, SEEK_END);
    const size_t bytes = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    // 16 bytes of slack: a kernel may read the aligned 16-byte chunk
    // that holds the buffer's last byte (malloc's and mmap's buffers
    // start aligned)
    void* p = is_shared ? mmap(nullptr, bytes + 16, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_ANONYMOUS, -1, 0)
                        : std::calloc(bytes + 16, 1);
    if (p == nullptr || p == MAP_FAILED ||
        std::fread(p, 1, bytes, f) != bytes)
      return 2;
    std::fclose(f);
    if (is_shared) shared.push_back({name, p, bytes});
    params.push_back(reinterpret_cast<long long>(p) + offset);
  }
  std::fclose(pf);
  const int tickets = std::atoi(argv[4]);
  void* syncs = mmap(nullptr, sizeof(std::atomic<long long>),
                     PROT_READ | PROT_WRITE, MAP_SHARED | MAP_ANONYMOUS, -1,
                     0);
  if (syncs == MAP_FAILED) return 2;
  cuda_cpu_shim_warp_syncs = new (syncs) std::atomic<long long>(0);
#ifdef CUDA_CPU_SHIM_ENTRY
  const int rc = CUDA_CPU_SHIM_ENTRY(params.data(), tickets, nullptr);
#else
  const int rc = std::strcmp(argv[2], "floor") == 0
                     ? wavefront_scan_floor(params.data(), tickets, nullptr)
                     : wavefront_scan(params.data(), tickets, nullptr);
#endif
  for (const Buf& b : shared) {
    FILE* f = std::fopen((dir + "/" + b.file + ".out").c_str(), "wb");
    if (!f || std::fwrite(b.p, 1, b.bytes, f) != b.bytes) return 2;
    std::fclose(f);
  }
  std::fprintf(stderr, "cuda_cpu_shim: %lld warp barriers\n",
               cuda_cpu_shim_warp_syncs->load());
  std::printf("%d\n", rc);
  return rc;
}
#endif
