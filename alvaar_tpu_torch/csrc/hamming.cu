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
// * hamming_bmma_kernel<R, kStore>: `hamming_matrix_matmul` (:60-66) and
//   `hamming_vs_pm1` (:45-51) with the reduction the loop queries apply to
//   their [N, M] matrix (alvaar_tpu/loopclosure/detector.py:75-85, 246-249,
//   273-276, 299-303): per query row the least and second least of the
//   masked distances and the first column of the least, as float32 with
//   the callers' `big` where a pair is masked (`hamming_best_two`; a
//   second launch, hamming_bmma_merge_kernel, joins column chunks), or with
//   kStore the dense int32 matrix itself (`hamming_matrix`).
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
// The dense pass runs on the same binary tensor cores.  Its query side
// is small (N = 130-352 keypoints) and stays in registers: a block holds R
// <= 12 m16 tiles of A (192 rows) as fragments, and here a lane takes
// words 2t and 2t + 1 of a descriptor (one 8-byte load; any assignment of
// words to k serves, as long as A and B share it).  Its 4 warps walk the
// block's chunk of B's 8-column tiles, each column's words loaded straight
// from global memory (a warp's tile is 256 contiguous bytes), 4 tiles a
// warp in flight.  Every (row, column) is one key, value << 21 | column:
// the value popc(b) + 256 - 2 popc(a & b) from the column's key base less
// the mma's count shifted by 22 (one IMAD), a masked column's fragment
// zeroed and its base 1023 << 21, a column past M all ones.  A lane keeps
// each of its rows' least and second least key (three integer min/max a
// key); the lanes' pairs go to shared memory, where a thread a row merges
// them and adds the row's popc(a) (computed once into shared memory) back:
// keys are distinct and exact, so the order of merging is free.  A query
// against at most 64 column tiles (one entry, 192 columns) runs in one
// chunk over row blocks of one m16 tile; past that the column chunks' best
// two go to scratch and a second launch reduces them a warp a row.  No
// atomics, no floats until the output.  A popcount per pair with `__popc`
// (the earlier design) issues 8 instructions a pair at 16 a clock a
// multiprocessor: 18 us of issue at 192 x 49 152; the binary mma does a
// 16 x 8 tile's 128 pairs in one, and the reduction's 4 integer
// instructions a pair bound it (~3.4 us of issue there; the rest is the
// chain of dependent loads, shuffles and the merge's launch).  Bound by
// latency at the loop queries' shapes: their bytes (1.6 MB at 192 x
// 49 152) take 0.5 us.  kStore replaces the reduction by popc(a) + popc(b)
// - 2 popc(a & b) stored as pairs of int32 (blocks of 4 m16 tiles, a column
// tile a warp): then the output's bytes bound it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;           // 32-bit words per descriptor
constexpr int kMaxBag = 8;          // descriptors a bag at most (SlamConfig().desc_bag_size is 6)
constexpr int kFar = 257;           // DESC_BITS + 1: no filled pair
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxRows = kMaxGridYZ;            // S: the dense pass's grid.z
constexpr int kMaxNMatrix = kMaxGridYZ * 32;    // the dense pass's rows of A: its row
                                                // blocks (grid.y) stay within 65535
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

// The dense pass's tiling.
constexpr int kDenseWarps = 4;         // a block's warps: warp w takes column tiles w, w + 4, ...
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kDenseMaxTiles = 12;     // m16 tiles of A a lane's registers hold: 192 rows
constexpr int kDenseBlocksPerSm = 4;   // the grid's target
constexpr int kDenseWarpTiles = 4;     // column tiles a warp takes at least, past one chunk;
constexpr int kDenseFewTiles = 2;      // ... this many where the chunks fit one block an SM
constexpr int kDenseAhead = 4;         // column tiles a warp has in flight (the best two)
constexpr int kStoreAhead = 2;         // ... (the int32 form)
constexpr int kSmallTiles = 64;        // the best two up to this many column tiles: one chunk,
constexpr int kSmallMaxTiles = 1;      // ... this many m16 tiles of A a block (no merge)
constexpr int kStoreMaxTiles = 4;      // the int32 form: m16 tiles of A a block (a tile a warp)
constexpr int kMergeWarps = 4;         // the merge's block: a warp a row,
constexpr int kMergeLoads = 4;         // ... each lane's loads of a round issued together
// A best-two key: value << kKeyShift | the column's offset in its block's
// chunk.  The value is popc(b) - 2 popc(a & b) + kValueBias (0..512; the
// row's popc(a) - kValueBias added back gives the distance), kMasked for a
// masked pair; a column past M is kNoKey (value kNoValue).
constexpr int kKeyShift = 21;
constexpr unsigned kColMask = (1u << kKeyShift) - 1;
constexpr int kMaxChunkTiles = 1 << (kKeyShift - 3);   // a chunk's columns fit the key's offset
constexpr unsigned kValueBias = 256;
constexpr unsigned kMasked = 1023;
constexpr unsigned kNoValue = 2047;
constexpr unsigned kNoKey = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned umin(unsigned x, unsigned y) { return x < y ? x : y; }
__device__ __forceinline__ unsigned umax(unsigned x, unsigned y) { return x > y ? x : y; }
__device__ __forceinline__ unsigned long long umin64(unsigned long long x,
                                                     unsigned long long y) {
  return x < y ? x : y;
}
__device__ __forceinline__ unsigned long long umax64(unsigned long long x,
                                                     unsigned long long y) {
  return x > y ? x : y;
}

// The running best two of a row: its least key and second least.
__device__ __forceinline__ void take(unsigned& best, unsigned& second, unsigned key) {
  second = umin(second, umax(best, key));
  best = umin(best, key);
}

// A row's outputs from the codes of its best and second (its distance, or
// kMasked, or kNoValue: no second column) and the best's column: the
// callers' float32 distances, `big` for a masked pair, a masked row's
// (big, big, 0) and inf for a lone column's second, as their composition
// gives them.
__device__ __forceinline__ void write_best_two(bool row_ok, int M, unsigned best_code,
                                               unsigned best_col, unsigned second_code,
                                               float big, float* best, float* second,
                                               long long* idx) {
  const float inf = __int_as_float(0x7f800000);
  if (!row_ok) {
    *best = big;
    *second = M > 1 ? big : inf;
    *idx = 0;
    return;
  }
  *best = best_code == kMasked ? big : static_cast<float>(best_code);
  *second = second_code >= kNoValue ? inf
            : second_code == kMasked ? big
                                     : static_cast<float>(second_code);
  *idx = best_col;
}

// A key's value (popc(b) - 2 popc(a & b) + kValueBias, or a sentinel) as
// its code: the distance once the row's popc(a) is added back.
__device__ __forceinline__ unsigned value_code(unsigned key, int pa) {
  const unsigned v = key >> kKeyShift;
  return v >= kMasked ? v : v + static_cast<unsigned>(pa) - kValueBias;
}

// The lane's words of column tile tl's column group (zeros past the chunk
// or M) and whether that column is unmasked.
struct ColumnWords {
  uint2 w;
  bool ok;
};

__device__ __forceinline__ ColumnWords load_column(const uint2* b, const bool* col_ok,
                                                   long long s, int M, int tl, int tile1,
                                                   int group, int t) {
  const int col = tl * 8 + group;
  ColumnWords c{make_uint2(0u, 0u), false};
  if (tl < tile1 && col < M) {
    c.w = b[(s * M + col) * 4 + t];
    c.ok = col_ok == nullptr || col_ok[s * M + col];
  }
  return c;
}

// A column tile's B fragment (a masked column's zeroed: it counts 0) and,
// for the lane's columns 2t and 2t + 1 (which groups 2t and 2t + 1 hold),
// their popc(b) (kStore) or their key bases: (popc(b) + kValueBias) << 21
// | the column's offset in the chunk, kMasked << 21 | offset for a masked
// column, kNoKey past M.
struct TileKeys {
  unsigned fb[2];
  int lo, hi;
};

template <bool kStore>
__device__ __forceinline__ TileKeys tile_keys(ColumnWords c, int tl, int tile0, int M, int group,
                                              int t) {
  int pb = __popc(c.w.x) + __popc(c.w.y);
  pb += __shfl_xor_sync(0xFFFFFFFFu, pb, 1);
  pb += __shfl_xor_sync(0xFFFFFFFFu, pb, 2);
  TileKeys k{{c.ok ? c.w.x : 0u, c.ok ? c.w.y : 0u}, 0, 0};
  if (kStore) {
    k.lo = __shfl_sync(0xFFFFFFFFu, pb, 8 * t);
    k.hi = __shfl_sync(0xFFFFFFFFu, pb, 8 * t + 4);
  } else {
    const int col = tl * 8 + group;
    const unsigned off = static_cast<unsigned>(col - tile0 * 8);
    const unsigned key = col >= M ? kNoKey
                         : c.ok   ? (static_cast<unsigned>(pb) + kValueBias) << kKeyShift | off
                                  : kMasked << kKeyShift | off;
    k.lo = static_cast<int>(__shfl_sync(0xFFFFFFFFu, key, 8 * t));
    k.hi = static_cast<int>(__shfl_sync(0xFFFFFFFFu, key, 8 * t + 4));
  }
  return k;
}

// a [S, N, 8] and b [S, M, 8] as uint2 (words 2t, 2t + 1 of a descriptor at
// [4 row + t]); row_ok [S, N] and col_ok [S, M] (null: all).  Block (x, y,
// s) takes rows 16 R y .. 16 R y + 16 R - 1 of A against B's column tiles
// x chunk_tiles .. (x + 1) chunk_tiles - 1 of row s.  kStore: out [S, N, M]
// the distances.  Otherwise each row's best two over the block's chunk:
// with one chunk best, second, idx [S, N] themselves; with several the keys
// part_key [S, N, chunks] (code << 32 | column) and second codes
// part_second [S, N, chunks] that hamming_bmma_merge_kernel reduces.
template <int R, bool kStore>
__global__ void __launch_bounds__(kDenseThreads)
    hamming_bmma_kernel(const uint2* a, const uint2* b, const bool* row_ok, const bool* col_ok,
                        int N, int M, int chunk_tiles, float big, int* out, float* best,
                        float* second, long long* idx, unsigned long long* part_key,
                        unsigned* part_second) {
  const long long s = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, group = lane / 4, t = lane % 4;
  const int n0 = blockIdx.y * 16 * R;
  const int tile0 = blockIdx.x * chunk_tiles;
  const int tiles = (M + 7) / 8;
  const int tile1 = tile0 + chunk_tiles < tiles ? tile0 + chunk_tiles : tiles;
  const int zero[4] = {0, 0, 0, 0};

  // each row's popc(a), a thread a row, into shared memory (the best two's
  // epilogue reads it, and the store epilogue's lanes), and its mask
  __shared__ int s_pa[16 * R];
  constexpr int kRowReads = (16 * R + kDenseThreads - 1) / kDenseThreads;
  bool row_on[kRowReads];
#pragma unroll
  for (int j = 0; j < kRowReads; ++j) {
    const int i = threadIdx.x + j * kDenseThreads, n = n0 + i;
    row_on[j] = kStore || n >= N || row_ok == nullptr || row_ok[s * N + n];
    if (i < 16 * R) {
      int p = 0;
#pragma unroll
      for (int w = 0; w < 4 && n < N; ++w) {
        const uint2 x = a[(s * N + n) * 4 + w];
        p += __popc(x.x) + __popc(x.y);
      }
      s_pa[i] = p;
    }
  }
  // A's fragments: words 2t and 2t + 1 of rows group and group + 8 of each
  // m16 tile, zeros past N
  unsigned fa[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + 16 * r + group;
    const uint2 lo = n < N ? a[(s * N + n) * 4 + t] : make_uint2(0u, 0u);
    const uint2 hi = n + 8 < N ? a[(s * N + n + 8) * 4 + t] : make_uint2(0u, 0u);
    fa[r][0] = lo.x;
    fa[r][1] = hi.x;
    fa[r][2] = lo.y;
    fa[r][3] = hi.y;
  }
  int pa[R][2];
  if (kStore) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pa[r][0] = s_pa[16 * r + group];
      pa[r][1] = s_pa[16 * r + group + 8];
    }
  }
  unsigned kb[R][2], ks[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) kb[r][0] = kb[r][1] = ks[r][0] = ks[r][1] = kNoKey;
  const bool pairs = M % 2 == 0;      // kStore: two neighbouring outputs as one 8-byte store

  // B's column tiles: the lane's words of column group of the warp's next
  // kAhead tiles are in flight while one is reduced
  constexpr int kAhead = kStore ? kStoreAhead : kDenseAhead;
  ColumnWords ahead[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    ahead[u] = load_column(b, col_ok, s, M, tile0 + warp + u * kDenseWarps, tile1, group, t);
  for (int base = tile0 + warp; base < tile1; base += kAhead * kDenseWarps) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int tl = base + u * kDenseWarps;
      if (tl >= tile1) break;                 // the same for the whole warp
      const TileKeys k = tile_keys<kStore>(ahead[u], tl, tile0, M, group, t);
      ahead[u] = load_column(b, col_ok, s, M, tl + kAhead * kDenseWarps, tile1, group, t);
      const unsigned(&fb)[2] = k.fb;
      const int lo = k.lo, hi = k.hi;
      const int m = tl * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int d[4];
        mma_and_popc(d, fa[r], fb, zero);
        if (kStore) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + 16 * r + group + 8 * h;
            if (n >= N) continue;
            const int v0 = pa[r][h] + lo - 2 * d[2 * h], v1 = pa[r][h] + hi - 2 * d[2 * h + 1];
            int* o = out + (s * N + n) * static_cast<long long>(M) + m;
            if (pairs && m + 1 < M) {
              *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
            } else {
              if (m < M) o[0] = v0;
              if (m + 1 < M) o[1] = v1;
            }
          }
        } else {      // the key less 2 popc(a & b) in its value: an exact integer, no borrow
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(lo) - (static_cast<unsigned>(d[2 * h]) << (kKeyShift + 1)));
            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(hi) -
                     (static_cast<unsigned>(d[2 * h + 1]) << (kKeyShift + 1)));
          }
        }
      }
    }
  }
  if (kStore) return;

  // every lane's best two of its rows into shared memory, then a thread a
  // row merges the 4 lanes of each warp's group that hold it (rows padded
  // by 8 entries: the lanes of a store fall in distinct banks)
  constexpr int kLanes = 4 * kDenseWarps, kStride = 16 * R + 8;
  __shared__ unsigned s_best[kLanes * kStride], s_second[kLanes * kStride];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (4 * warp + t) * kStride + 16 * r + group + 8 * h;
      s_best[at] = kb[r][h];
      s_second[at] = ks[r][h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRowReads; ++j) {
    const int i = threadIdx.x + j * kDenseThreads;
    const int n = n0 + i;
    if (i >= 16 * R || n >= N) break;
    unsigned bk = s_best[i], sk = s_second[i];
    for (int l = 1; l < kLanes; ++l) {
      sk = umin(umin(sk, s_second[l * kStride + i]), umax(bk, s_best[l * kStride + i]));
      bk = umin(bk, s_best[l * kStride + i]);
    }
    const unsigned col = static_cast<unsigned>(tile0 * 8) + (bk & kColMask);
    const unsigned bc = value_code(bk, s_pa[i]), sc = value_code(sk, s_pa[i]);
    if (part_key == nullptr) {
      write_best_two(row_on[j], M, bc, col, sc, big, best + s * N + n, second + s * N + n,
                     idx + s * N + n);
    } else {
      const long long at = (s * N + n) * gridDim.x + blockIdx.x;
      part_key[at] = static_cast<unsigned long long>(bc) << 32 | col;
      part_second[at] = sc;
    }
  }
}

// The chunks' best two of each row (part_key, part_second [S, N, chunks])
// → best, second, idx [S, N]: a warp a row, its lanes over the chunks (a
// row's are contiguous), then a butterfly.  Every key's column is its
// own, so the minima are the same in any order.
__global__ void __launch_bounds__(32 * kMergeWarps)
    hamming_bmma_merge_kernel(const bool* row_ok, const unsigned long long* part_key,
                              const unsigned* part_second, int S, int N, int M, int chunks,
                              float big, float* best, float* second, long long* idx) {
  const long long row = static_cast<long long>(blockIdx.x) * kMergeWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(S) * N) return;       // the same for the whole warp
  const int lane = threadIdx.x % 32;
  const bool on = row_ok[row];
  unsigned long long bk = ~0ull;
  unsigned sv = kNoKey;
  const unsigned long long* keys = part_key + row * chunks;
  const unsigned* seconds = part_second + row * chunks;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kMergeLoads) {
    unsigned long long k[kMergeLoads];
    unsigned v[kMergeLoads];
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {      // the loads issued together
      const int c = c0 + 32 * u;
      k[u] = c < chunks ? keys[c] : ~0ull;
      v[u] = c < chunks ? seconds[c] : kNoKey;
    }
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      sv = umin(umin(sv, v[u]), static_cast<unsigned>(umax64(bk, k[u]) >> 32));
      bk = umin64(bk, k[u]);
    }
  }
  for (int lane_mask = 16; lane_mask >= 1; lane_mask /= 2) {
    const unsigned long long ok = __shfl_xor_sync(0xFFFFFFFFu, bk, lane_mask);
    const unsigned os = __shfl_xor_sync(0xFFFFFFFFu, sv, lane_mask);
    sv = umin(umin(sv, os), static_cast<unsigned>(umax64(bk, ok) >> 32));
    bk = umin64(bk, ok);
  }
  if (lane == 0)
    write_best_two(on, M, static_cast<unsigned>(bk >> 32), static_cast<unsigned>(bk), sv, big,
                   best + row, second + row, idx + row);
}

using BmmaKernel = void (*)(const uint2*, const uint2*, const bool*, const bool*, int, int, int,
                            float, int*, float*, float*, long long*, unsigned long long*,
                            unsigned*);
const BmmaKernel kBestTwoKernels[kDenseMaxTiles] = {
    hamming_bmma_kernel<1, false>,  hamming_bmma_kernel<2, false>,
    hamming_bmma_kernel<3, false>,  hamming_bmma_kernel<4, false>,
    hamming_bmma_kernel<5, false>,  hamming_bmma_kernel<6, false>,
    hamming_bmma_kernel<7, false>,  hamming_bmma_kernel<8, false>,
    hamming_bmma_kernel<9, false>,  hamming_bmma_kernel<10, false>,
    hamming_bmma_kernel<11, false>, hamming_bmma_kernel<12, false>};
const BmmaKernel kStoreKernels[kDenseMaxTiles] = {
    hamming_bmma_kernel<1, true>,  hamming_bmma_kernel<2, true>,
    hamming_bmma_kernel<3, true>,  hamming_bmma_kernel<4, true>,
    hamming_bmma_kernel<5, true>,  hamming_bmma_kernel<6, true>,
    hamming_bmma_kernel<7, true>,  hamming_bmma_kernel<8, true>,
    hamming_bmma_kernel<9, true>,  hamming_bmma_kernel<10, true>,
    hamming_bmma_kernel<11, true>, hamming_bmma_kernel<12, true>};

// The dense pass's grid for S rows of N x M.  The best two: up to
// kSmallTiles column tiles in one chunk (no merge) over row blocks of at
// most kSmallMaxTiles m16 tiles; past that R <= kDenseMaxTiles tiles of A a
// block (balanced over ceil(N / 16 kDenseMaxTiles) row blocks) and B's
// column tiles in as many chunks as make kDenseBlocksPerSm blocks a
// multiprocessor while each warp keeps kDenseWarpTiles tiles
// (kDenseFewTiles where that makes at most one block a multiprocessor:
// shorter chains for a lone query at a few thousand columns).  The int32
// form needs no merge: R <= kStoreMaxTiles and a column tile a warp.
struct DensePlan {
  int R, row_blocks, chunk_tiles, chunks;
};

int dense_plan(int S, int N, int M, bool store, DensePlan* plan) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_a = (N + 15) / 16, tiles_b = (M + 7) / 8;
  const bool small = !store && tiles_b <= kSmallTiles;
  int most_r = store ? kStoreMaxTiles : small ? kSmallMaxTiles : kDenseMaxTiles;
  if ((tiles_a + most_r - 1) / most_r > kMaxGridYZ)     // grid.y's limit (N <= kMaxNMatrix)
    most_r = (tiles_a + kMaxGridYZ - 1) / kMaxGridYZ;
  plan->row_blocks = (tiles_a + most_r - 1) / most_r;
  plan->R = (tiles_a + plan->row_blocks - 1) / plan->row_blocks;
  long long chunks = 1;
  if (store) {
    chunks = (tiles_b + kDenseWarps - 1) / kDenseWarps;
  } else if (!small) {
    const long long units = static_cast<long long>(S) * plan->row_blocks;
    chunks = (static_cast<long long>(kDenseBlocksPerSm) * sms + units - 1) / units;
    const long long few = tiles_b / (kDenseWarps * kDenseFewTiles);
    const long long most = units * few <= sms ? few : tiles_b / (kDenseWarps * kDenseWarpTiles);
    chunks = chunks > most ? most : chunks;
  }
  const long long least = (tiles_b + kMaxChunkTiles - 1) / kMaxChunkTiles;
  chunks = chunks < least ? least : chunks < 1 ? 1 : chunks;
  plan->chunk_tiles = static_cast<int>((tiles_b + chunks - 1) / chunks);
  plan->chunks = (tiles_b + plan->chunk_tiles - 1) / plan->chunk_tiles;
  return 0;
}

bool aligned8(const void* p) { return reinterpret_cast<unsigned long long>(p) % 8 == 0; }

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

// The number of column chunks the best two of S rows of N x M takes: past
// one, the wrapper gives hamming_best_two_launch scratch for [S, N, chunks]
// keys (8 bytes) and second codes (4 bytes).
extern "C" int hamming_best_two_chunks(int S, int N, int M, int* chunks) {
  if (S < 1 || S > kMaxRows || N < 1 || N > kMaxNMatrix || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DensePlan plan;
  const int e = dense_plan(S, N, M, false, &plan);
  *chunks = plan.chunks;
  return e;
}

// best, second [S, N] float32 and idx [S, N] int64 from a [S, N, 8], b [S,
// M, 8] (8-byte aligned), row_ok [S, N] and col_ok [S, M] on `stream`: per
// row the least and second least of the masked distances (`big` where
// either mask is off; the second inf where M is 1) and the first column of
// the least.  part_key and part_second: the scratch that
// hamming_best_two_chunks asks for (`scratch_chunks` chunks), or null
// where it says 1; past one the merge runs as a second launch.
extern "C" int hamming_best_two_launch(const void* a, const void* b, const void* row_ok,
                                       const void* col_ok, int S, int N, int M, float big,
                                       void* best, void* second, void* idx, void* part_key,
                                       void* part_second, int scratch_chunks, void* stream) {
  if (S < 1 || S > kMaxRows || N < 0 || N > kMaxNMatrix || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (!aligned8(a) || !aligned8(b)) return static_cast<int>(cudaErrorInvalidValue);
  DensePlan plan;
  int e = dense_plan(S, N, M, false, &plan);
  if (e != 0) return e;
  const bool merge = plan.chunks > 1;
  if (merge && (part_key == nullptr || part_second == nullptr || scratch_chunks < plan.chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto ua = static_cast<const uint2*>(a);
  const auto rows = static_cast<const bool*>(row_ok);
  const BmmaKernel kernel = kBestTwoKernels[plan.R - 1];
  kernel<<<dim3(plan.chunks, plan.row_blocks, S), dim3(kDenseThreads), 0, st>>>(
      ua, static_cast<const uint2*>(b), rows, static_cast<const bool*>(col_ok), N, M,
      plan.chunk_tiles, big, nullptr, static_cast<float*>(best), static_cast<float*>(second),
      static_cast<long long*>(idx), merge ? static_cast<unsigned long long*>(part_key) : nullptr,
      static_cast<unsigned*>(part_second));
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || !merge) return e;
  const long long rows_all = static_cast<long long>(S) * N;
  hamming_bmma_merge_kernel<<<static_cast<unsigned>((rows_all + kMergeWarps - 1) / kMergeWarps),
                              dim3(32 * kMergeWarps), 0, st>>>(
      rows, static_cast<const unsigned long long*>(part_key),
      static_cast<const unsigned*>(part_second), S, N, M, plan.chunks, big,
      static_cast<float*>(best), static_cast<float*>(second), static_cast<long long*>(idx));
  return static_cast<int>(cudaGetLastError());
}

// out [S, N, M] int32 from a [S, N, 8], b [S, M, 8] (8-byte aligned) on
// `stream`: the dense pass with its store epilogue.
extern "C" int hamming_matrix_launch(const void* a, const void* b, int S, int N, int M,
                                     void* out, void* stream) {
  if (S < 1 || S > kMaxRows || N < 0 || N > kMaxNMatrix || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || M == 0) return 0;
  if (!aligned8(a) || !aligned8(b) || !aligned8(out))
    return static_cast<int>(cudaErrorInvalidValue);
  DensePlan plan;
  const int e = dense_plan(S, N, M, true, &plan);
  if (e != 0) return e;
  const BmmaKernel kernel = kStoreKernels[plan.R - 1];
  kernel<<<dim3(plan.chunks, plan.row_blocks, S), dim3(kDenseThreads), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(a), static_cast<const uint2*>(b), nullptr, nullptr, N, M,
      plan.chunk_tiles, 0.0f, static_cast<int*>(out), nullptr, nullptr, nullptr, nullptr,
      nullptr);
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
