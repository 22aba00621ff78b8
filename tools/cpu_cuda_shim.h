// Just enough of CUDA to run a kernel source of this repository on the CPU
// (tools/cuda_on_cpu.py, for tools/rehearse_ba_kernels.py,
// tools/rehearse_pnp_kernel.py and tools/rehearse_hamming_kernel.py): no
// card, no nvcc.  Every CUDA thread of a block is a fiber on one host
// thread (its own stack, switched with _setjmp/_longjmp); blocks run one
// after another, so `__shared__` variables are function statics.
// `__syncthreads` is a barrier over the block's fibers, `__syncwarp` one
// over the warp's lanes, a warp's shuffles and votes an exchange array (two,
// used in turn) behind a barrier over its lanes, `cp.async`
// (`__pipeline_memcpy_async`) a plain copy, `clock64` a count of its calls
// (it times nothing), `__popc` the compiler's popcount.  A fiber that
// returns leaves its block's and its warp's barriers.  Float arithmetic is
// the host's: build with -ffp-contract=off, as nvcc's --fmad=false, and
// -U_FORTIFY_SOURCE (the checked longjmp refuses to change stacks).
#pragma once

#include <setjmp.h>
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <tuple>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static

using std::fma;
using std::sqrt;

struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the running fiber's indices (one host thread runs every fiber)
inline uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

namespace cpu_cuda {

struct Barrier {
  int expected = 0, arrived = 0;
  unsigned gen = 0;
};

struct Fiber {
  ucontext_t uc;
  jmp_buf jb;
  std::vector<char> stack;
  uint3 tid;
  bool started = false, done = false;
  unsigned exchanges = 0;   // a lane's shuffles and votes so far: picks the buffer
};

struct Warp {
  Barrier bar;
  alignas(8) unsigned char buf[2][32][8];
};

struct Sched {
  jmp_buf jb;
  std::vector<Fiber> fibers;
  std::vector<Warp> warps;
  Barrier block;
  int current = -1;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
};

inline Sched* g = nullptr;

inline void yield() {
  Fiber& f = g->fibers[g->current];
  if (!_setjmp(f.jb)) _longjmp(g->jb, 1);
}

inline void wait(Barrier& b) {
  const unsigned gen = b.gen;
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) yield();
}

inline void drop(Barrier& b) {
  if (--b.expected > 0 && b.arrived == b.expected) {
    b.arrived = 0;
    ++b.gen;
  }
}

inline Warp& warp() { return g->warps[threadIdx.x / 32]; }

// Every lane offers v; each returns the value of lane src(lane).
template <class T, class Src>
T exchange(T v, Src src) {
  Warp& w = warp();
  Fiber& f = g->fibers[g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  std::memcpy(w.buf[k][lane], &v, sizeof(T));
  wait(w.bar);
  T out;
  std::memcpy(&out, w.buf[k][src(lane)], sizeof(T));
  return out;
}

inline void entry() {
  g->body(g->arg);
  Fiber& f = g->fibers[g->current];
  f.done = true;
  drop(warp().bar);
  drop(g->block);
  _longjmp(g->jb, 1);
}

// Run body(arg) on n fibers of one block until every fiber has returned.
inline void run_block(int n, uint3 block_idx, void (*body)(void*), void* arg) {
  static Sched s;
  s.fibers.resize(n);
  s.warps.assign((n + 31) / 32, Warp{});
  for (int w = 0; w * 32 < n; ++w) s.warps[w].bar.expected = std::min(32, n - 32 * w);
  s.block = Barrier{n, 0, 0};
  s.body = body;
  s.arg = arg;
  g = &s;
  blockIdx = block_idx;
  for (int t = 0; t < n; ++t) {
    Fiber& f = s.fibers[t];
    f.stack.resize(1 << 17);
    f.started = f.done = false;
    f.exchanges = 0;
    f.tid = uint3{static_cast<unsigned>(t) % blockDim.x,
                  (static_cast<unsigned>(t) / blockDim.x) % blockDim.y,
                  static_cast<unsigned>(t) / (blockDim.x * blockDim.y)};
  }
  int live = n;
  while (live > 0) {
    for (int t = 0; t < n; ++t) {
      Fiber& f = s.fibers[t];
      if (f.done) continue;
      s.current = t;
      threadIdx = f.tid;
      if (!_setjmp(s.jb)) {
        if (!f.started) {
          f.started = true;
          getcontext(&f.uc);
          f.uc.uc_stack.ss_sp = f.stack.data();
          f.uc.uc_stack.ss_size = f.stack.size();
          f.uc.uc_link = nullptr;
          makecontext(&f.uc, entry, 0);
          setcontext(&f.uc);
        }
        _longjmp(f.jb, 1);
      }
      if (f.done) --live;
    }
  }
  g = nullptr;
}

}  // namespace cpu_cuda

inline void __syncthreads() { cpu_cuda::wait(cpu_cuda::g->block); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { cpu_cuda::wait(cpu_cuda::warp().bar); }

// The shuffles over a full warp, `width` a power of two up to 32: the lanes
// in segments of `width`, a source outside its lane's segment read as the
// lane's own value (`__shfl_down_sync`) or wrapped into it (`__shfl_sync`).
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return cpu_cuda::exchange(v, [&](unsigned l) { return l ^ static_cast<unsigned>(lane_mask); });
}

template <class T>
T __shfl_sync(unsigned, T v, int src_lane, int width = 32) {
  return cpu_cuda::exchange(v, [&](unsigned l) {
    return (l & ~static_cast<unsigned>(width - 1)) + static_cast<unsigned>(src_lane % width);
  });
}

template <class T>
T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  return cpu_cuda::exchange(v, [&](unsigned l) {
    return (l % width) + delta < static_cast<unsigned>(width) ? l + delta : l;
  });
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

// A stand-in for the SM's cycle counter: the calls so far, over every fiber.
inline long long clock64() {
  static long long ticks = 0;
  return ++ticks;
}

inline bool __any_sync(unsigned, bool pred) {
  cpu_cuda::Warp& w = cpu_cuda::warp();
  cpu_cuda::Fiber& f = cpu_cuda::g->fibers[cpu_cuda::g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  w.buf[k][lane][0] = pred;
  cpu_cuda::wait(w.bar);
  bool any = false;
  for (int l = 0; l < w.bar.expected; ++l) any = any || w.buf[k][l][0];
  return any;
}

inline void __pipeline_memcpy_async(void* dst, const void* src, std::size_t n,
                                    std::size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}

// kernel<<<grid, block, 0, stream>>>(args...): the grid's blocks one after
// another, each on block.x * block.y * block.z fibers.
template <class... KArgs, class... Args>
void cpu_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, Args... args) {
  const int n = static_cast<int>(block.x * block.y * block.z);
  struct Call {
    void (*kernel)(KArgs...);
    std::tuple<Args...> args;
  } call{kernel, std::tuple<Args...>(args...)};
  auto body = [](void* p) {
    Call& c = *static_cast<Call*>(p);
    std::apply([&](auto&... a) { c.kernel(a...); }, c.args);
  };
  blockDim = block;
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) cpu_cuda::run_block(n, uint3{x, y, z}, body, &call);
}
