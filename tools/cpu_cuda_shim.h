// Just enough of CUDA to run a kernel source of this repository on the CPU
// (tools/cuda_on_cpu.py, for tools/rehearse_ba_kernels.py,
// tools/rehearse_pnp_kernel.py, tools/rehearse_hamming_kernel.py and
// tools/rehearse_image_kernels.py): no card, no nvcc.  Every CUDA thread of a block is a fiber on one host
// thread (its own stack, switched with _setjmp/_longjmp); blocks run one
// after another, so `__shared__` variables are function statics.
// `__syncthreads` is a barrier over the block's fibers, `__syncwarp` one
// over the warp's lanes, a warp's shuffles, votes and `mma.sync` an
// exchange array (two, used in turn) behind a barrier over its lanes,
// `__ballot_sync` a vote of that kind, bf16 rounding torch's (nearest,
// ties to even),
// `cp.async` (`__pipeline_memcpy_async`) a plain copy, `clock64` a count of
// its calls (it times nothing), `__popc` the compiler's popcount, dynamic
// shared memory one static buffer.  A
// fiber that returns leaves its block's and its warp's barriers.  Float
// arithmetic is the host's: build with -ffp-contract=off, as nvcc's
// --fmad=false, and -U_FORTIFY_SOURCE (the checked longjmp refuses to
// change stacks).  A kernel source names inline PTX through a helper that
// takes the shim's emulation under `#ifdef CPU_CUDA_SHIM`, which only this
// header defines.
#pragma once

#define CPU_CUDA_SHIM 1

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
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(8) int2 {
  int x, y;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline int2 make_int2(int x, int y) { return int2{x, y}; }
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// A kernel's dynamic shared memory: one buffer of the card's most a block
// can take, which every block uses in turn (`cpu_cuda::dynamic_shared`,
// named by a kernel source under `#ifdef CPU_CUDA_SHIM` in place of its
// `extern __shared__` array); raising a kernel's limit does nothing.
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
namespace cpu_cuda {
alignas(16) inline unsigned char dynamic_buffer[232448];
template <class T>
T* dynamic_shared() {
  return reinterpret_cast<T*>(dynamic_buffer);
}
}  // namespace cpu_cuda

// One device with `cpu_cuda_sm_count` multiprocessors (2 unless a caller
// sets another through the library's `cpu_cuda_set_sm_count`).
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cpu_cuda_sm_count = 2;
extern "C" void cpu_cuda_set_sm_count(int n) { cpu_cuda_sm_count = n; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int device) {
  if (attr != cudaDevAttrMultiProcessorCount || device != 0) return cudaErrorInvalidValue;
  *value = cpu_cuda_sm_count;
  return cudaSuccess;
}

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

constexpr int kLaneBytes = 24;    // what a lane offers at most: an mma's a0-a3 and b0, b1

struct Warp {
  Barrier bar;
  alignas(8) unsigned char buf[2][32][kLaneBytes];
  int product[2][16][8];         // an mma's A B, by the first lane past the barrier
  unsigned product_gen[2] = {~0u, ~0u};
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
  static_assert(sizeof(T) <= kLaneBytes);
  Warp& w = warp();
  Fiber& f = g->fibers[g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  std::memcpy(w.buf[k][lane], &v, sizeof(T));
  wait(w.bar);
  T out;
  std::memcpy(&out, w.buf[k][src(lane)], sizeof(T));
  return out;
}

// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc for the
// calling lane, once every lane of its warp has offered its fragments, in
// the PTX ISA's layout (lane = 4 groupID + t): A's a0 / a1 hold rows
// groupID / groupID + 8 at k = 32t..32t+31, a2 / a3 the same rows at
// k = 128+32t..128+32t+31 (bit i at k + i); B's b0 / b1 column groupID at
// the same k; the lane's d0, d1 are row groupID at columns 2t, 2t + 1 and
// d2, d3 row groupID + 8.  d = c + popc(A & B) over k (d may alias c).
inline void mma_m16n8k256_and_popc(int (&d)[4], const unsigned (&a)[4],
                                   const unsigned (&b)[2], const int (&c)[4]) {
  struct Frag {
    unsigned a[4], b[2];
  };
  static_assert(sizeof(Frag) <= kLaneBytes);
  Warp& w = warp();
  Fiber& f = g->fibers[g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  const Frag mine{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}};
  std::memcpy(w.buf[k][lane], &mine, sizeof(Frag));
  wait(w.bar);
  if (w.product_gen[k] != w.bar.gen) {   // the first lane here: the whole 16 x 8 product
    w.product_gen[k] = w.bar.gen;
    unsigned A[16][8], B[8][8];           // [row][k / 32], [column][k / 32]
    for (unsigned l = 0; l < 32; ++l) {
      Frag x;
      std::memcpy(&x, w.buf[k][l], sizeof(Frag));
      const unsigned group = l / 4, t = l % 4;
      for (unsigned half = 0; half < 2; ++half) {
        A[group][4 * half + t] = x.a[2 * half];
        A[group + 8][4 * half + t] = x.a[2 * half + 1];
        B[group][4 * half + t] = x.b[half];
      }
    }
    for (int r = 0; r < 16; ++r)
      for (int n = 0; n < 8; ++n) {
        int sum = 0;
        for (int j = 0; j < 8; ++j) sum += __builtin_popcount(A[r][j] & B[n][j]);
        w.product[k][r][n] = sum;
      }
  }
  int out[4];
  for (int i = 0; i < 4; ++i)
    out[i] = c[i] + w.product[k][lane / 4 + 8 * (i / 2)][2 * (lane % 4) + i % 2];
  for (int i = 0; i < 4; ++i) d[i] = out[i];
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
T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  return cpu_cuda::exchange(v, [&](unsigned l) { return l % width >= delta ? l - delta : l; });
}

template <class T>
T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  return cpu_cuda::exchange(v, [&](unsigned l) {
    return (l % width) + delta < static_cast<unsigned>(width) ? l + delta : l;
  });
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

// A load through the read-only data cache: a plain load here.
template <class T>
T __ldg(const T* p) {
  return *p;
}

// A load past the L1 (cached in L2 only): a plain load here.
template <class T>
T __ldcg(const T* p) {
  return *p;
}

// The blocks run one after another and a fiber yields only at a barrier or a
// warp exchange: a read-modify-write is atomic as it stands, and a fence
// has nothing to order.
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline void __threadfence() {}

// A stand-in for the SM's cycle counter: the calls so far, over every fiber.
inline long long clock64() {
  static long long ticks = 0;
  return ++ticks;
}

inline unsigned __ballot_sync(unsigned, bool pred) {
  cpu_cuda::Warp& w = cpu_cuda::warp();
  cpu_cuda::Fiber& f = cpu_cuda::g->fibers[cpu_cuda::g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  const int lanes = w.bar.expected;    // before the wait: a lane past it may return
  w.buf[k][lane][0] = pred;
  cpu_cuda::wait(w.bar);
  unsigned bits = 0;
  for (int l = 0; l < lanes; ++l) bits |= static_cast<unsigned>(w.buf[k][l][0] != 0) << l;
  return bits;
}

// bfloat16 as torch rounds a float to it (to nearest, ties to even; NaN
// to a quiet NaN) and back.
struct __nv_bfloat16 {
  std::uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  if (f != f) return __nv_bfloat16{0x7FC0};
  return __nv_bfloat16{static_cast<std::uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const std::uint32_t u = static_cast<std::uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline bool __any_sync(unsigned, bool pred) {
  cpu_cuda::Warp& w = cpu_cuda::warp();
  cpu_cuda::Fiber& f = cpu_cuda::g->fibers[cpu_cuda::g->current];
  const unsigned lane = threadIdx.x % 32, k = f.exchanges++ & 1;
  const int lanes = w.bar.expected;    // before the wait: a lane past it may return
  w.buf[k][lane][0] = pred;
  cpu_cuda::wait(w.bar);
  bool any = false;
  for (int l = 0; l < lanes; ++l) any = any || w.buf[k][l][0];
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
