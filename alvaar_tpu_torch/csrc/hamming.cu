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
// Bound: the JAX formulation's 2 (N G) (M G) 256 operations would take
// ~7 us on the card's int8 tensor cores at N = 4096, M = 192, G = 6; as
// the binary operations below (8 times the bits for the same issue slots)
// ~0.9 us, under the ~1.2 us that the bytes take (mostly the float32
// output), so the bytes bound it.
//
// The min cross-bag pass runs on the tensor cores, in their binary form:
// `mma.sync m16n8k256 .b1 .and.popc` gives, for a 16 x 8 tile, c +
// popc(a & b) over a whole 256-bit descriptor a side, and
// popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b).  (On an H100 the AND
// form issues at the int8 m16n8k32 form's ~7 clocks a sub-partition, so 8
// times its bits; the XOR form assembles but runs 6-20 times slower:
// tools/hamming_tuning.py --rate.)  In the PTX ISA's fragments (lane =
// 4 groupID + t) a0 / a1 are rows groupID / groupID + 8 at k = 32t..32t+31
// and a2 / a3 the same rows at k = 128+32t..; b0 / b1 column groupID at
// the same k: so they are words t and t + 4 of each descriptor, read as
// they are.  A warp takes 8 columns of B, their words in registers (2 G)
// with popc(b), or 1024 for an empty slot or a column past M; a block of 4
// warps walks tiles of A's rows staged in shared memory by cp.async
// (double-buffered, each row padded by 16 bytes against bank conflicts)
// with popc(a) per slot, 1024 more for an empty one.  The loop over (ga, gb)
// leaves every pair's 16 x 8 tile in the same accumulator registers, so
// the bag minimum is elementwise in the lane's registers: min over gb of
// popc(b) - 2 popc(a & b), then popc(a) added and the running minimum,
// which starts at 257, taken.  A sentinel never reaches the output (a sum
// with one is at least 1024 - 256).  The blocks are persistent: grid.x
// covers B's columns by 32, grid.y fills the card with kBlocksPerSm blocks
// a multiprocessor, and each block walks a contiguous run of (row s, A
// tile) items, reading B again when s changes.  No atomics, no
// floating-point sums: each output has one owner and its value is an exact
// integer.
//
// The dense matrix counts bits: a block takes 32 columns of B (one a
// lane, its descriptor in registers) and a tile of 32 rows of A staged in
// shared memory, which every lane of a warp reads at one address (a
// broadcast); each warp takes every fourth row of the tile and stores 32
// neighbouring outputs of a row.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;           // 32-bit words per descriptor
constexpr int kMaxBag = 8;          // descriptors a bag at most (SlamConfig().desc_bag_size is 6)
constexpr int kFar = 257;           // DESC_BITS + 1: no filled pair
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxRows = kMaxGridYZ;            // S: the dense kernel's grid.z
constexpr int kMaxNMatrix = kMaxGridYZ * 32;    // the dense kernel's grid.y times its tile
constexpr int kMaxNCrossbag = 0x7FFFFFF0;       // the row walk's n0 + its tile stays an int

// The min cross-bag kernel's tiling.
constexpr int kStageTiles = 4;      // m16 tiles of A a stage; each warp takes them in turn
constexpr int kTileRows = 16 * kStageTiles;   // rows of A a stage
constexpr int kWarpCols = 8;        // columns of B a warp: one n8 tile
constexpr int kBlockWarps = 4;
constexpr int kBlockCols = kWarpCols * kBlockWarps;
constexpr int kBlockThreads = 32 * kBlockWarps;
constexpr int kBlocksPerSm = 4;     // __launch_bounds__'s minimum, the grid's target
constexpr int kEmpty = 1024;        // added to an empty slot's popcount: past any distance
// the (row, slot) pairs of a stage that each thread reads the filled flag of
constexpr int kSlotsPerThread = (kTileRows * kMaxBag + kBlockThreads - 1) / kBlockThreads;

__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

// d = c + popc(A & B) over k = 256 for one 16 x 8 tile: A row-major, B
// column-major, one bit an element, the PTX ISA's fragments (lane = 4
// groupID + t): a0 / a1 rows groupID / groupID + 8 at k = 32t..32t+31, a2 /
// a3 the same rows at k = 128+32t..128+32t+31; b0 / b1 column groupID at
// those k; c0, c1 row groupID at columns 2t, 2t + 1, c2, c3 row groupID + 8.
// The CPU rehearsal's shim emulates it.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2], const int (&c)[4]) {
#ifdef CPU_CUDA_SHIM
  cpu_cuda::mma_m16n8k256_and_popc(d, a, b, c);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(c[0]),
        "r"(c[1]), "r"(c[2]), "r"(c[3]));
#endif
}

__device__ __forceinline__ int popc_words(const unsigned* w) {
  const uint4 lo = reinterpret_cast<const uint4*>(w)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(w)[1];
  return __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) + __popc(hi.x) +
         __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
}

// Words of a row of a stage: its G descriptors and 4 words of padding, so
// that the lanes' words t of rows groupID fall in distinct banks.
template <int G>
constexpr int kRowWords = G * kWords + 4;

// Item `item` (row s = item / tiles, rows n0 = (item % tiles) * kTileRows
// of A) into a stage: its bags by cp.async (a 16-byte piece a copy),
// zeros past N.  Every thread of the block calls it; the caller commits.
// Returns the thread's filled flags (bit j: the stage's (row, slot) pair
// threadIdx.x + j * kBlockThreads, as `stage_popcounts` takes them).
template <int G>
__device__ __forceinline__ unsigned stage_tile(unsigned* words, const unsigned* a,
                                               const bool* fa, long long item, int tiles,
                                               int N) {
  const long long s = item / tiles;
  const int n0 = static_cast<int>(item % tiles) * kTileRows;
  const int rows = N - n0 < kTileRows ? N - n0 : kTileRows;
  const unsigned* src = a + (s * N + n0) * G * kWords;
  for (int i = threadIdx.x; i < kTileRows * G * 2; i += kBlockThreads) {
    unsigned* dst = words + (i / (2 * G)) * kRowWords<G> + 4 * (i % (2 * G));
    if (i < rows * G * 2) {
      __pipeline_memcpy_async(dst, src + 4 * i, 16);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) dst[w] = 0u;
    }
  }
  const bool* f = fa + (s * N + n0) * G;
  unsigned fills = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int i = threadIdx.x + j * kBlockThreads;
    if (i < rows * G && f[i]) fills |= 1u << j;
  }
  return fills;
}

// A stage's popc(a) per (row, slot), kEmpty more where the slot is empty
// (`fills` from `stage_tile`), once its words have landed.
template <int G>
__device__ __forceinline__ void stage_popcounts(int* pa, const unsigned* words,
                                                unsigned fills) {
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int i = threadIdx.x + j * kBlockThreads;
    if (i < kTileRows * G)
      pa[i] = popc_words(words + (i / G) * kRowWords<G> + (i % G) * kWords) +
              ((fills >> j) & 1u ? 0 : kEmpty);
  }
}

// The warp's 8 columns of B in row s: bf[gb] the lane's b0, b1 (words t
// and t + 4 of its column col0 + groupID's slot gb, zeros past M), and
// pb[gb][h] the popcount of column col0 + 2t + h's slot gb, or kEmpty where
// the slot is empty or the column is past M.
template <int G>
__device__ __forceinline__ void load_columns(unsigned (&bf)[G][2], int (&pb)[G][2],
                                             const unsigned* b, const bool* fb, long long s,
                                             int M, int col0, int group, int t) {
  const int n = col0 + group;
#pragma unroll
  for (int gb = 0; gb < G; ++gb) {
    const unsigned* w = b + ((s * M + n) * G + gb) * kWords;
    bf[gb][0] = n < M ? w[t] : 0u;
    bf[gb][1] = n < M ? w[t + 4] : 0u;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = col0 + 2 * t + h;
#pragma unroll
    for (int gb = 0; gb < G; ++gb)
      pb[gb][h] = m < M && fb[(s * M + m) * G + gb]
                      ? popc_words(b + ((s * M + m) * G + gb) * kWords)
                      : kEmpty;
  }
}

// a [S, N, G, 8], fa [S, N, G], b [S, M, G, 8], fb [S, M, G] → out [S, N, M];
// block (x, y) takes columns 32 x .. 32 x + 31 of the items y * per ..
// y * per + per - 1 (of S * tiles).
template <int G>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
    hamming_min_crossbag_kernel(const unsigned* a, const bool* fa, const unsigned* b,
                                const bool* fb, int S, int N, int M, long long per,
                                float* out) {
  constexpr int kStride = kRowWords<G>;
  __shared__ uint4 s_tiles[2][kTileRows * kStride / 4];   // uint4: 16-byte aligned
  __shared__ int s_pa[2][kTileRows * G];
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const long long items = static_cast<long long>(S) * tiles;
  const long long first = blockIdx.y * per;
  const long long last = first + per < items ? first + per : items;
  if (first >= last) return;
  const int lane = threadIdx.x % 32, group = lane / 4, t = lane % 4;
  const int col0 = blockIdx.x * kBlockCols + (threadIdx.x / 32) * kWarpCols;
  const bool active = col0 < M;             // the same for every lane of the warp
  const int zero[4] = {0, 0, 0, 0};

  unsigned bf[G][2];
  int pb[G][2];
  long long loaded = -1;
  unsigned fills = stage_tile<G>(&s_tiles[0][0].x, a, fa, first, tiles, N);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  stage_popcounts<G>(s_pa[0], &s_tiles[0][0].x, fills);
  __syncthreads();
  for (long long item = first; item < last; ++item) {
    const int k = static_cast<int>((item - first) & 1);
    if (item + 1 < last) {
      fills = stage_tile<G>(&s_tiles[k ^ 1][0].x, a, fa, item + 1, tiles, N);
      __pipeline_commit();
    }
    const long long s = item / tiles;
    const int n0 = static_cast<int>(item % tiles) * kTileRows;
    if (active) {
      if (s != loaded) {
        load_columns<G>(bf, pb, b, fb, s, M, col0, group, t);
        loaded = s;
      }
      for (int mt = 0; mt < kStageTiles && n0 + 16 * mt < N; ++mt) {
        const unsigned* w0 = &s_tiles[k][0].x + (16 * mt + group) * kStride;
        const unsigned* w1 = w0 + 8 * kStride;
        const int* pa0 = s_pa[k] + (16 * mt + group) * G;
        const int* pa1 = pa0 + 8 * G;
        int best[4] = {kFar, kFar, kFar, kFar};
#pragma unroll
        for (int ga = 0; ga < G; ++ga) {
          const unsigned frag[4] = {w0[ga * kWords + t], w1[ga * kWords + t],
                                    w0[ga * kWords + 4 + t], w1[ga * kWords + 4 + t]};
          int m[4];
#pragma unroll
          for (int gb = 0; gb < G; ++gb) {
            int d[4];
            mma_and_popc(d, frag, bf[gb], zero);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int v = pb[gb][i % 2] - 2 * d[i];
              m[i] = gb == 0 ? v : imin(m[i], v);
            }
          }
          best[0] = imin(best[0], m[0] + pa0[ga]);
          best[1] = imin(best[1], m[1] + pa0[ga]);
          best[2] = imin(best[2], m[2] + pa1[ga]);
          best[3] = imin(best[3], m[3] + pa1[ga]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + 16 * mt + group + 8 * (i / 2), m = col0 + 2 * t + i % 2;
          if (n < N && m < M) out[(s * N + n) * M + m] = static_cast<float>(best[i]);
        }
      }
    }
    if (item + 1 < last) {      // the next stage's words landed, this one's read by all
      __pipeline_wait_prior(0);
      __syncthreads();
      stage_popcounts<G>(s_pa[k ^ 1], &s_tiles[k ^ 1][0].x, fills);
    }
    __syncthreads();
  }
}

constexpr int kDenseCols = 32;      // columns of B per block: one a lane
constexpr int kDenseWarps = 4;      // warp y takes rows y, y + 4, ... of the tile
constexpr int kDenseRows = 32;      // rows of A per block
constexpr int kDenseThreads = kDenseCols * kDenseWarps;

// a [S, N, 8], b [S, M, 8] → out [S, N, M]: block (x, y, s) takes
// out[s, 32 y .. 32 y + 31, 32 x .. 32 x + 31].
__global__ void __launch_bounds__(kDenseThreads)
    hamming_matrix_kernel(const unsigned* a, const unsigned* b, int N, int M, int* out) {
  __shared__ unsigned sa[kDenseRows * kWords];
  const long long s = blockIdx.z;
  const int n0 = blockIdx.y * kDenseRows;
  const int rows = N - n0 < kDenseRows ? N - n0 : kDenseRows;
  const int m = blockIdx.x * kDenseCols + threadIdx.x;
  const int tid = threadIdx.y * kDenseCols + threadIdx.x;

  const unsigned* at = a + (s * N + n0) * kWords;
  for (int i = tid; i < rows * kWords; i += kDenseThreads) sa[i] = at[i];
  unsigned rb[kWords];
  if (m < M) {
    const unsigned* bm = b + (s * M + m) * kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) rb[i] = bm[i];
  }
  __syncthreads();
  if (m >= M) return;

  int* o = out + (s * N + n0) * M + m;
  for (int r = threadIdx.y; r < rows; r += kDenseWarps) {
    const unsigned* ar = sa + r * kWords;
    int d = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d += __popc(ar[w] ^ rb[w]);
    o[static_cast<long long>(r) * M] = d;
  }
}

using MinKernel = void (*)(const unsigned*, const bool*, const unsigned*, const bool*, int, int,
                           int, long long, float*);
const MinKernel kMinKernels[kMaxBag] = {
    hamming_min_crossbag_kernel<1>, hamming_min_crossbag_kernel<2>,
    hamming_min_crossbag_kernel<3>, hamming_min_crossbag_kernel<4>,
    hamming_min_crossbag_kernel<5>, hamming_min_crossbag_kernel<6>,
    hamming_min_crossbag_kernel<7>, hamming_min_crossbag_kernel<8>};

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// out [S, N, M] float32 from bag_a [S, N, G, 8], filled_a [S, N, G],
// bag_b [S, M, G, 8], filled_b [S, M, G] on `stream`; 1 <= G <= 8, the bags
// 16-byte aligned.
extern "C" int hamming_min_crossbag_launch(const void* bag_a, const void* filled_a,
                                           const void* bag_b, const void* filled_b, int S,
                                           int N, int M, int G, void* out, void* stream) {
  if (S < 1 || S > kMaxRows || N < 0 || N > kMaxNCrossbag || M < 0 || G < 1 || G > kMaxBag)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || M == 0) return 0;
  if (!aligned16(bag_a) || !aligned16(bag_b)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_blocks = (M + kBlockCols - 1) / kBlockCols;
  const long long items = static_cast<long long>(S) * ((N + kTileRows - 1) / kTileRows);
  long long groups = static_cast<long long>(kBlocksPerSm) * sms / col_blocks;
  groups = groups < 1 ? 1 : groups > items ? items : groups;
  const long long per = (items + groups - 1) / groups;
  groups = (items + per - 1) / per;
  const MinKernel kernel = kMinKernels[G - 1];
  kernel<<<dim3(col_blocks, static_cast<unsigned>(groups)), dim3(kBlockThreads), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bag_a), static_cast<const bool*>(filled_a),
      static_cast<const unsigned*>(bag_b), static_cast<const bool*>(filled_b), S, N, M, per,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [S, N, M] int32 from a [S, N, 8], b [S, M, 8] on `stream`.
extern "C" int hamming_matrix_launch(const void* a, const void* b, int S, int N, int M,
                                     void* out, void* stream) {
  if (S < 1 || S > kMaxRows || N < 0 || N > kMaxNMatrix || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || M == 0) return 0;
  hamming_matrix_kernel<<<dim3((M + kDenseCols - 1) / kDenseCols,
                               (N + kDenseRows - 1) / kDenseRows, S),
                          dim3(kDenseCols, kDenseWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b), N, M,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The limits the wrappers check before a launch (ops/hamming_kernel.py).
extern "C" int hamming_kernel_limits(int* max_bag, int* max_rows, int* max_n_crossbag,
                                     int* max_n_matrix) {
  *max_bag = kMaxBag;
  *max_rows = kMaxRows;
  *max_n_crossbag = kMaxNCrossbag;
  *max_n_matrix = kMaxNMatrix;
  return 0;
}
