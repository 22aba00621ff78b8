// K4: Hamming distances between packed 256-bit descriptors (8 words of
// 32 bits), the port's counterpart of the JAX package's
// alvaar_tpu/ops/hamming.py:
//
// * hamming_min_crossbag_kernel: `hamming_min_crossbag` (:81-107), the
//   minimum distance over every pair of two landmarks' descriptor bags
//   (local-map matching, alvaar_tpu/worldmap/matching.py:78).  Per output
//   (s, n, m) the minimum over (ga, gb) with filled_a[s, n, ga] and
//   filled_b[s, m, gb] of sum_w popc(a[s, n, ga, w] ^ b[s, m, gb, w]), as a
//   float; 257 (DESC_BITS + 1) where no pair is filled.
// * hamming_matrix_kernel: `hamming_matrix_matmul` (:60-66) and
//   `hamming_vs_pm1` (:45-51), the loop queries' dense [N, M] matrix
//   (alvaar_tpu/loopclosure/detector.py:246, 273, 299): the same with one
//   descriptor a side and no masks, as int32.
//
// Neither is a Pallas kernel: the JAX package leaves them to XLA as ±1
// matrix products on the MXU.  Both take a leading S rows (the stacked
// rows of a torch.func.vmap), so one launch serves a batched keyframe or
// loop phase.
//
// Bound: the JAX formulation's 2 (N G) (M G) 256 operations are ~7 us on
// the card's int8 tensor cores at N = 4096, M = 192, G = 6, against ~1 us
// for the bytes; by popcounts (16 a clock per SM) the same work is
// N M G^2 8 popc, ~60 us.  This first design counts bits: a block takes 32
// columns of B (one a lane, its bag held in registers) and a tile of 32
// rows of A staged in shared memory, which every lane of a warp reads at
// one address (a broadcast); each warp takes every fourth row of the tile
// and stores 32 neighbouring outputs of a row.  No atomics and no floating
// point sums: each output has one owner and its value is an exact integer.
// The tensor cores (b1 mma with XOR-popc, or the ±1 int8 product) are a
// later design's.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;       // 32-bit words per descriptor
constexpr int kCols = 32;       // columns of B per block: one a lane
constexpr int kWarps = 4;       // warps per block; warp y takes rows y, y + 4, ... of the tile
constexpr int kTileRows = 32;   // rows of A per block
constexpr int kThreads = kCols * kWarps;
constexpr int kMaxBag = 8;      // descriptors a bag at most (SlamConfig().desc_bag_size is 6)
constexpr int kFar = 257;       // DESC_BITS + 1: no filled pair
constexpr int kMaxGridYZ = 65535;

// One block's outputs out[s, n0 .. n0 + 31, 32 columns]; a [S, N, G, 8],
// fa [S, N, G], b [S, M, G, 8], fb [S, M, G], out [S, N, M] (fa, fb unread
// when not kMasked).
template <int G, bool kMasked, class T>
__device__ __forceinline__ void hamming_tile(const unsigned* __restrict__ a,
                                             const bool* __restrict__ fa,
                                             const unsigned* __restrict__ b,
                                             const bool* __restrict__ fb, int N, int M,
                                             T* __restrict__ out) {
  constexpr int kBag = G * kWords;
  __shared__ unsigned sa[kTileRows * kBag];
  __shared__ unsigned sfa[kTileRows];
  const long long s = blockIdx.z;
  const int n0 = blockIdx.y * kTileRows;
  const int rows = N - n0 < kTileRows ? N - n0 : kTileRows;
  const int m = blockIdx.x * kCols + threadIdx.x;
  const int tid = threadIdx.y * kCols + threadIdx.x;

  const unsigned* at = a + (s * N + n0) * kBag;
  for (int i = tid; i < rows * kBag; i += kThreads) sa[i] = at[i];
  if (kMasked && tid < rows) {
    const bool* f = fa + (s * N + n0 + tid) * G;
    unsigned bits = 0;
    for (int g = 0; g < G; ++g) bits |= f[g] ? 1u << g : 0u;
    sfa[tid] = bits;
  }
  unsigned rb[kBag];
  unsigned fbits = 1u;
  if (m < M) {
    const unsigned* bm = b + (s * M + m) * kBag;
#pragma unroll
    for (int i = 0; i < kBag; ++i) rb[i] = bm[i];
    if (kMasked) {
      const bool* f = fb + (s * M + m) * G;
      fbits = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) fbits |= f[g] ? 1u << g : 0u;
    }
  }
  __syncthreads();
  if (m >= M) return;

  T* o = out + (s * N + n0) * M + m;
  for (int r = threadIdx.y; r < rows; r += kWarps) {
    const unsigned* ar = sa + r * kBag;
    const unsigned fab = kMasked ? sfa[r] : 1u;
    int best = kFar;
#pragma unroll
    for (int ga = 0; ga < G; ++ga) {
      if (!((fab >> ga) & 1u)) continue;    // the same for every lane of the warp
#pragma unroll
      for (int gb = 0; gb < G; ++gb) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) d += __popc(ar[ga * kWords + w] ^ rb[gb * kWords + w]);
        if ((fbits >> gb) & 1u) best = d < best ? d : best;
      }
    }
    o[static_cast<long long>(r) * M] = static_cast<T>(best);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    hamming_min_crossbag_kernel(const unsigned* a, const bool* fa, const unsigned* b,
                                const bool* fb, int N, int M, float* out) {
  hamming_tile<G, true>(a, fa, b, fb, N, M, out);
}

__global__ void __launch_bounds__(kThreads)
    hamming_matrix_kernel(const unsigned* a, const unsigned* b, int N, int M, int* out) {
  hamming_tile<1, false>(a, nullptr, b, nullptr, N, M, out);
}

using MinKernel = void (*)(const unsigned*, const bool*, const unsigned*, const bool*, int, int,
                           float*);
const MinKernel kMinKernels[kMaxBag] = {
    hamming_min_crossbag_kernel<1>, hamming_min_crossbag_kernel<2>,
    hamming_min_crossbag_kernel<3>, hamming_min_crossbag_kernel<4>,
    hamming_min_crossbag_kernel<5>, hamming_min_crossbag_kernel<6>,
    hamming_min_crossbag_kernel<7>, hamming_min_crossbag_kernel<8>};

bool bad_shape(int S, int N, int M) {
  return S < 1 || S > kMaxGridYZ || N < 0 || M < 0 || N > kMaxGridYZ * kTileRows;
}

dim3 grid_of(int S, int N, int M) {
  return dim3((M + kCols - 1) / kCols, (N + kTileRows - 1) / kTileRows, S);
}

}  // namespace

// out [S, N, M] float32 from bag_a [S, N, G, 8], filled_a [S, N, G],
// bag_b [S, M, G, 8], filled_b [S, M, G] on `stream`; 1 <= G <= 8.
extern "C" int hamming_min_crossbag_launch(const void* bag_a, const void* filled_a,
                                           const void* bag_b, const void* filled_b, int S,
                                           int N, int M, int G, void* out, void* stream) {
  if (bad_shape(S, N, M) || G < 1 || G > kMaxBag) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || M == 0) return 0;
  const MinKernel kernel = kMinKernels[G - 1];
  kernel<<<grid_of(S, N, M), dim3(kCols, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bag_a), static_cast<const bool*>(filled_a),
      static_cast<const unsigned*>(bag_b), static_cast<const bool*>(filled_b), N, M,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [S, N, M] int32 from a [S, N, 8], b [S, M, 8] on `stream`.
extern "C" int hamming_matrix_launch(const void* a, const void* b, int S, int N, int M,
                                     void* out, void* stream) {
  if (bad_shape(S, N, M)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || M == 0) return 0;
  hamming_matrix_kernel<<<grid_of(S, N, M), dim3(kCols, kWarps), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b), N, M,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hamming_kernel_limits(int* max_bag) {
  *max_bag = kMaxBag;
  return 0;
}
