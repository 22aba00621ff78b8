// The image kernels of the frame and of the keyframe pass, the port's
// counterparts of four XLA formulations of the JAX package (none of them a
// Pallas kernel; the JAX package compiles them into its jitted step):
//
// * K7, alvaar_tpu/ops/image.py:23-63: `rgba_to_gray` (BT.601 luma of an
//   RGB(A) frame, u8 or float32) as `gray_kernel`: four pixels a thread
//   from whole words (u8 RGBA one 16-byte load, u8 RGB three 4-byte words,
//   float32 three or four 16-byte loads) and one float4 store, a grid of at
//   most 8 blocks a multiprocessor striding over the frame, an unaligned
//   frame and the last pixels % 4 by loads of one channel each; bound by
//   bytes (each pixel's channels read once, 4 bytes written).  And
//   `build_pyramid` / `pyr_down` (the 5-tap binomial blur and 2x decimation) as
//   `pyramid_kernel`, over a stack of B images in one launch.  One launch
//   writes two levels (so every preset's 3-level pyramid is one launch; 4
//   levels take two, the second writing one level) or one (`pyr_down`).
//   A block owns an 8 x 32 tile of the second level: it stages the 41 x 137
//   pixels of level 0 that tile needs, computes the 19 x 67 level-1 values
//   around it in shared memory (each at its own clamped level-1
//   coordinate), writes the 16 x 64 of them it owns, and takes level 2
//   from the shared tile.  Level 0 is read once (its halo from L2), the
//   levels written once: bound by bytes.
// * K5, alvaar_tpu/ops/detect.py:159-252: the whole of `detect_grid` in
//   two launches.  `detect_cells_kernel`, a block per (grid cell, row):
//   the cell's Shi-Tomasi response and a 2-pixel ring around it (the
//   subpixel fit's neighbourhood), computed in sub-tiles of at most 54 x
//   54 with every stage staged once in shared memory (the image, the 3x3
//   pre-blur, Sobel's dx and dy, the box means' vertical pass, then their
//   horizontal pass and the min-eig) into a response tile that stays
//   resident (in global scratch where it does not fit beside them); the
//   cell's best peak (tracked as the response is computed) and second
//   peak; their subpixel fit, border and finiteness gates; the cell's
//   occupancy and the peaks' proximity to the live keypoints (the block's
//   strided scan, a ballot a warp, one barrier).  A block of 256 threads,
//   four of them a multiprocessor.  `detect_rank_kernel`, blocks of 16
//   candidates a row: the 5-rung threshold ladder's counts, the rung, the
//   new threshold, the priorities, and each candidate's stable rank by a
//   warp's strided count over the row's 2C priorities, staged in shared
//   memory 1024 at a time.  Bound by the image's bytes; what holds it back
//   is latency: a cell's block runs its dependent stages one after another
//   (~10-14 us at 640x480, tools/image_kernel_timeline.py), and one row has
//   only 130-352 cells to spread over 132 multiprocessors.
// * K3, alvaar_tpu/ops/orb.py:96-149: `describe`, 1, 2 or 4 warps a
//   keypoint (the most that keep the launch within ~16 warps a
//   multiprocessor), each a band of rows, in blocks of 128 threads: the
//   0.2 box blur of the 35 x 35 window whose 31 x 31 inner pixels the
//   moments and the taps read (the patch centre is clamped so that the
//   window lies inside the image: no edge clamps), a column of it a lane,
//   its loads issued together, the vertical pass in registers and the
//   horizontal one through shared memory, straight-line code with no branch
//   per row; the intensity-centroid moments from the lane's column in
//   registers, in four float64 partial sums, then a warp sum by shuffles
//   that leaves every lane the angle and its steering bin (no thread
//   alone; a block barrier only where a keypoint has several warps); 256
//   steered compares of bf16-rounded pixels, each pair's two 16-bit patch
//   indices in one word of the [30, 256] table read through the read-only
//   path, a ballot per descriptor word.  Bound by latency: a keypoint is
//   ~35 KB of work, so its chain of loads, passes, sums and compares sets
//   the time at the single stream's widths.
// * K8, alvaar_tpu/ops/image.py:83-130: `clahe` over a stack of B images
//   in two launches whatever B.  `clahe_lut_kernel`, a block per (tile,
//   image): the tile's pixels by 16-byte loads into eight warp-private
//   histograms (integer atomics in shared memory), summed a bin a thread;
//   then thread k on bin k: the clip's excess by warp shuffles, the CDF's
//   prefix in float64 (exact) by a shuffle scan a warp and the totals of
//   the warps before, the normalised table.
//   `clahe_apply_kernel`, blocks striding over the stack's bands of tile
//   rows (as many blocks as stay resident): a block stages the 3 x 3
//   tiles' tables around its tile and its rows' weights in shared memory,
//   a thread four pixels a 16-byte load and store, its columns' weights in
//   registers, each pixel's four tables at its rounded value blended
//   bilinearly; a scalar path in both kernels for an unaligned image or a
//   tile side that is not a multiple of 4.  Bound by bytes: the image read
//   twice, the tables written and read, the output written; at one 640x480
//   frame by the two launches' chains of dependent steps.
//
// Each computes what its plain version (alvaar_tpu_torch/ops/image.py,
// detect.py, orb.py) computes, operation for operation: the stencils'
// taps in `_sep_conv`'s order (rows first, then columns, ((0 + k0 x0) +
// k1 x1) + ...), edge-clamped indices at every stage, Sobel's difference
// first, the box means, the min-eig; build with --fmad=false, so that no
// multiply-add is contracted.  A tile in shared memory holds each stage's
// value at the clamped coordinate of every entry, so that the next stage
// reads its clamped neighbours from it as the plain version does.  So K7
// and K5 are bit-equal to their plain versions.  K3's moments are
// 961-term sums, which the plain version takes with torch.sum in an order
// no kernel reproduces: here each term is the plain version's float32
// product, summed in float64 and rounded once, so the angle is within a
// few float32 ulps of the plain one and a descriptor can differ only where
// that angle lies on a steering-bin boundary.
//
// The per-cell argmax follows torch.argmax: NaN above every number, ties
// to the first index, cells past the image's edge padded with -inf (an
// all -inf cell gives index 0).  The selection is ops/topk.py's stable
// descending sort of the 2C priorities: a candidate's rank is the count of
// greater priorities plus equal ones at lower indices.  No float atomics:
// every output has one owner in its launch (K8's histogram counts are
// integers, added in shared memory).
//
// Every kernel takes a leading S (or B) rows, so one launch serves a
// stack of frames or the rows of a torch.func.vmap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGrayThreads = 256;     // the gray kernel's block
constexpr int kGrayBlocksPerSm = 8;   // its grid's most: a grid-stride loop past it
constexpr int kMaxRows = 65535;       // S: grid.y of the cell, rank and describe kernels

// The plain versions' constants, rounded to float32 as torch rounds a
// Python float it multiplies a float32 tensor by.
constexpr float kGrayR = static_cast<float>(0.299);
constexpr float kGrayG = static_cast<float>(0.587);
constexpr float kGrayB = static_cast<float>(0.114);
constexpr float kBin0 = 0.0625f, kBin1 = 0.25f, kBin2 = 0.375f;   // [1, 4, 6, 4, 1] / 16
constexpr float kThird = static_cast<float>(1.0 / 3.0);          // the box means' taps
constexpr float kCvNorm = static_cast<float>(9.0 / (3060.0 * 3060.0));   // cornerMinEigenVal units
constexpr float kFifth = static_cast<float>(0.2);                // ORB's box blur taps
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kDetFloor = static_cast<float>(1e-12);
constexpr float kQualityMin = static_cast<float>(1e-9);
constexpr float kFill = static_cast<float>(0.9);      // the ladder's target fill
constexpr float kStarve = static_cast<float>(0.33);   // below it the threshold halves
constexpr int kRungs = 5;

// K7's tile: the second level's rows and columns a block owns
constexpr int kPyrTileY = 8;
constexpr int kPyrTileX = 32;
constexpr int kPyr0Y = 4 * kPyrTileY + 9, kPyr0X = 4 * kPyrTileX + 9;   // level 0 staged
constexpr int kPyr1Y = 2 * kPyrTileY + 3, kPyr1X = 2 * kPyrTileX + 3;   // level 1 with its halo
constexpr int kPyrThreads = 256;
constexpr int kPyrLoads = (kPyr0Y * kPyr0X + kPyrThreads - 1) / kPyrThreads;   // a thread's loads

// K5: a response sub-tile's side at most; the shared memory a cell block
// may take (the stages of its sub-tiles and, where they fit beside them,
// its response tile: up to 175 x 175 floats beside a 54 x 54 sub-tile's
// stages); the candidates a rank block ranks and the priorities it stages
// at a time.  K5's scratch per row, in units of C: floats (the candidates'
// x, y and score, 2C each) and ints (the candidates passing the gates 2C,
// the occupied cells C).
constexpr int kMaxChunk = 54;
constexpr int kCellSmemBytes = 180 * 1024;
constexpr int kCellThreads = 256;                 // the cell kernel's block: kCellRows rows
constexpr int kCellBlocks = 4;                    // its blocks a multiprocessor holds at least
constexpr int kStageUnroll = 4;                   // rows of a stage a thread overlaps
constexpr int kCellCols = 64;                     // of kCellCols, a column of every stage each
constexpr int kCellRows = kCellThreads / kCellCols;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kCellLoads = (kMaxChunk + 6 + kCellRows - 1) / kCellRows;   // image rows a thread loads
static_assert(kMaxChunk + 6 <= kCellCols, "a sub-tile's stages are one column a thread wide");
constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankPer = 16;
constexpr int kRankTile = 1024;
constexpr int kScratchF = 6;
constexpr int kScratchI = 3;

// ORB's geometry (ops/orb.py)
constexpr int kPatch = 36;            // _PSZ: the patch covers [-17, +18] around its centre
constexpr int kPatchLo = 17;          // _PLO
constexpr int kRadius = 15;           // PATCH_RADIUS: the moments' circle
constexpr int kSide = 2 * kRadius + 1;   // the patch rows and columns the moments and taps read
constexpr int kWin = kSide + 4;       // the blur's window: 2 more pixels a side
constexpr int kBits = 256;
constexpr int kAngleBins = 30;
// K3: a keypoint's 31 x 31 pixels are tile rows of kPatch floats, so that
// the steering table's flat patch index i (row i / 36, column i % 36) is
// tile entry i - kTileBase
constexpr int kTileBase = (kPatchLo - kRadius) * (kPatch + 1);
// K3's blocks: 128 threads, kWarps warps a keypoint (a template
// parameter: 4 or 1) and so 4 / kWarps keypoints a block; each warp a band
// of the footprint's rows and kBits / 32 / kWarps descriptor words.  A
// launch of at most kDescWideKeypoints keypoints (S N) gives each 4 warps,
// a larger one 1: up to a pass's 704 keypoints (~21 warps a
// multiprocessor) a keypoint's chain is what takes the time, so four warps
// share it; at S = 8 rows of 192 the multiprocessors are full, so each
// keypoint takes one warp and no duplicated window rows
// (tools/image_tuning.py, PERF.md section 6).  kDescSums: a lane's float64
// partial sums of a moment, the rows in turn.
constexpr int kDescThreads = 128;
constexpr int kDescWideKeypoints = 1024;
constexpr int kDescSums = 4;
static_assert(kWin <= 64 && kSide <= 32, "a column of the window a lane, two for a few lanes");

// K8: a table's bins (a thread each in the table kernel's block, whose
// size the pixel kernel shares) and the tiles a side at most.  The pixel
// kernel's rows a band at most, and its bands a tile: more where the
// frames' tiles would give the multiprocessors fewer than kClaheBandFill
// blocks each.  The loads a thread issues together: the table kernel's
// kClaheCountUnroll (2: 32 registers, 8 blocks a multiprocessor), the
// pixel kernel's kClaheUnroll rows; the pixel kernel's blocks a
// multiprocessor (3: 80 registers), its grid kClaheApplyBlocks a
// multiprocessor at most.
constexpr int kClaheBins = 256;
constexpr int kClaheThreads = kClaheBins;
constexpr int kClaheWarps = kClaheThreads / 32;
constexpr int kMaxTiles = 256;
constexpr int kClaheBandRows = 64;
constexpr int kClaheBandFill = 2;
constexpr int kClaheCountUnroll = 2;
constexpr int kClaheUnroll = 4;
constexpr int kClaheApplyBlocks = 3;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// torch.clamp: min(max(v, lo), hi)
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  const long long m = v > lo ? v : lo;
  return m < hi ? m : hi;
}
__device__ __forceinline__ float neg_inf() { return -INFINITY; }

// _sep_conv's sum over taps, Python's `sum` starting from 0
__device__ __forceinline__ float tap3(float x0, float x1, float x2, float k0, float k1) {
  return ((0.0f + k0 * x0) + k1 * x1) + k0 * x2;
}
__device__ __forceinline__ float tap5(float x0, float x1, float x2, float x3, float x4, float k0,
                                      float k1, float k2) {
  return ((((0.0f + k0 * x0) + k1 * x1) + k2 * x2) + k1 * x3) + k0 * x4;
}
// tap5 of p[0], p[step], ..., p[4 step] with the binomial's taps
__device__ __forceinline__ float binomial(const float* p, int step) {
  return tap5(p[0], p[step], p[2 * step], p[3 * step], p[4 * step], kBin0, kBin1, kBin2);
}

// The block's dynamic shared memory (the shim's buffer on the CPU).
__device__ __forceinline__ float* dynamic_smem() {
#ifdef CPU_CUDA_SHIM
  return cpu_cuda::dynamic_shared<float>();
#else
  extern __shared__ float smem[];
  return smem;
#endif
}

// ---------------------------------------------------------------------------
// K7: gray conversion and the pyramid
// ---------------------------------------------------------------------------

// The r, g, b of four neighbouring pixels (`p` at the first) from whole
// words: u8 RGBA one 16-byte load, u8 RGB three 4-byte words, float32 four
// or three 16-byte loads.  `p` is aligned as GrayVec<T, C>::kAlign says.
template <typename T, int C>
struct GrayVec {
  static constexpr int kAlign = sizeof(T) == 1 && C == 3 ? 4 : 16;
};

template <typename T, int C>
__device__ __forceinline__ void load_quad(const T* p, float (&c)[4][3]) {
  if constexpr (sizeof(T) == 1) {
    unsigned w[4];
    if constexpr (C == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      w[0] = q[0], w[1] = q[1], w[2] = q[2];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int k = C * i + ch;       // the byte: little-endian within its word
        c[i][ch] = static_cast<float>((w[k / 4] >> (8 * (k % 4))) & 0xFFu);
      }
  } else {
    float v[4 * C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z, v[4 * j + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[i][ch] = v[C * i + ch];
  }
}

// rgba [pixels, C] (C 3 or 4) → out [pixels]: the plain version's ((r
// 0.299 + g 0.587) + b 0.114) on float32 values, four pixels a thread at a
// time over a grid sized to the card.  `wide_in`: rgba is aligned for
// load_quad (else each channel is a load of its own); `wide_out`: out is
// 16-byte aligned (a float4 store); the pixels past the last group of four
// by the first threads of block 0.
template <typename T, int C>
__global__ void __launch_bounds__(kGrayThreads)
    gray_kernel(const T* rgba, long long pixels, int wide_in, int wide_out, float* out) {
  const long long quads = pixels / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kGrayThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kGrayThreads + threadIdx.x;
       q < quads; q += stride) {
    float c[4][3];
    const T* p = rgba + q * 4 * C;
    if (wide_in) {
      load_quad<T, C>(p, c);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c[i][ch] = static_cast<float>(p[C * i + ch]);
    }
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = c[i][0] * kGrayR + c[i][1] * kGrayG + c[i][2] * kGrayB;
    if (wide_out) {
      reinterpret_cast<float4*>(out)[q] = make_float4(g[0], g[1], g[2], g[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[4 * q + i] = g[i];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < pixels % 4) {
    const long long i = quads * 4 + threadIdx.x;
    const T* p = rgba + i * C;
    out[i] = static_cast<float>(p[0]) * kGrayR + static_cast<float>(p[1]) * kGrayG +
             static_cast<float>(p[2]) * kGrayB;
  }
}

// img [B, H, W] → out1 [B, H1, W1] (H1 = ceil(H / 2)) and, unless out2 is
// null, out2 [B, H2, W2] (H2 = ceil(H1 / 2)): the binomial blur at the even
// rows and columns of each level (rows first, then columns, edge-clamped
// at that level's size).  Block (tile, b) owns level-2 rows R0..R0 + 7 and
// columns C0..C0 + 31, so level-1 rows 2 R0..2 R0 + 15 and columns
// 2 C0..2 C0 + 63; the grid is B x ceil(H2 / 8) x ceil(W2 / 32) in x.
__global__ void __launch_bounds__(kPyrThreads)
    pyramid_kernel(const float* img, int H, int W, int H1, int W1, int H2, int W2, float* out1,
                   float* out2) {
  __shared__ float s0[kPyr0Y * kPyr0X];   // level 0 at rows 4 R0 - 6 + i, clamped
  __shared__ float v1[kPyr1Y * kPyr0X];   // level 1's vertical pass
  __shared__ float s1[kPyr1Y * kPyr1X];   // level 1 at rows 2 R0 - 2 + a, clamped to level 1
  __shared__ float v2[kPyrTileY * kPyr1X];
  const int tiles_x = (W2 + kPyrTileX - 1) / kPyrTileX;
  const int tiles = tiles_x * ((H2 + kPyrTileY - 1) / kPyrTileY);
  const long long b = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x - b * tiles);
  const int R0 = (t / tiles_x) * kPyrTileY, C0 = (t % tiles_x) * kPyrTileX;
  const float* im = img + b * H * W;
  {
    float v[kPyrLoads];              // every load issued before the first store
#pragma unroll
    for (int k = 0; k < kPyrLoads; ++k) {
      const int i = threadIdx.x + k * kPyrThreads;
      const int y = clampi(4 * R0 - 6 + i / kPyr0X, 0, H - 1);
      const int x = clampi(4 * C0 - 6 + i % kPyr0X, 0, W - 1);
      v[k] = i < kPyr0Y * kPyr0X ? im[static_cast<long long>(y) * W + x] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPyrLoads; ++k) {
      const int i = threadIdx.x + k * kPyrThreads;
      if (i < kPyr0Y * kPyr0X) s0[i] = v[k];
    }
  }
  __syncthreads();
  // level-1 row a is clamp(2 R0 - 2 + a) of level 1, whose taps are level-0
  // rows 2 r1 - 2 + d: staged rows 2 r1 - 4 R0 + 4 + d
  for (int i = threadIdx.x; i < kPyr1Y * kPyr0X; i += kPyrThreads) {
    const int a = i / kPyr0X, j = i % kPyr0X;
    const int r1 = clampi(2 * R0 - 2 + a, 0, H1 - 1);
    v1[i] = binomial(s0 + (2 * r1 - 4 * R0 + 4) * kPyr0X + j, kPyr0X);
  }
  __syncthreads();
  float* o1 = out1 + b * H1 * W1;
  for (int i = threadIdx.x; i < kPyr1Y * kPyr1X; i += kPyrThreads) {
    const int a = i / kPyr1X, c = i % kPyr1X;
    const int c1 = clampi(2 * C0 - 2 + c, 0, W1 - 1);
    const float v = binomial(v1 + a * kPyr0X + 2 * c1 - 4 * C0 + 4, 1);
    s1[i] = v;
    const int y = 2 * R0 - 2 + a, x = 2 * C0 - 2 + c;     // owned: the tile's own, inside
    if (a >= 2 && a < 2 + 2 * kPyrTileY && c >= 2 && c < 2 + 2 * kPyrTileX && y < H1 && x < W1)
      o1[static_cast<long long>(y) * W1 + x] = v;
  }
  if (out2 == nullptr) return;        // one level: every thread of every block returns here
  __syncthreads();
  // level-2 row R0 + a2 takes level-1 rows 2 (R0 + a2) - 2 + d, shared row 2 a2 + d
  for (int i = threadIdx.x; i < kPyrTileY * kPyr1X; i += kPyrThreads) {
    const int a2 = i / kPyr1X, c = i % kPyr1X;
    v2[i] = binomial(s1 + 2 * a2 * kPyr1X + c, kPyr1X);
  }
  __syncthreads();
  float* o2 = out2 + b * H2 * W2;
  for (int i = threadIdx.x; i < kPyrTileY * kPyrTileX; i += kPyrThreads) {
    const int a2 = i / kPyrTileX, c2 = i % kPyrTileX;
    const int y = R0 + a2, x = C0 + c2;
    if (y < H2 && x < W2)
      o2[static_cast<long long>(y) * W2 + x] = binomial(v2 + a2 * kPyr1X + 2 * c2, 1);
  }
}

// ---------------------------------------------------------------------------
// K5: grid Shi-Tomasi detection
// ---------------------------------------------------------------------------

// torch.argmax's order: NaN above every number, ties to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (bv != bv) return v != v && i < bi;
  if (v != v) return true;
  return v > bv || (v == bv && i < bi);
}

// The block's argmax of (v, i) over its kW warps: every thread gets it.
// `sv` and `si` hold kW entries.
template <int kW>
__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, m);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, i, m);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (threadIdx.x % 32 == 0) {
    sv[threadIdx.x / 32] = v;
    si[threadIdx.x / 32] = i;
  }
  __syncthreads();
  if (threadIdx.x < 32) {             // warp 0 reduces the warps' (v, i) the same way
    v = threadIdx.x < kW ? sv[threadIdx.x] : neg_inf();
    i = threadIdx.x < kW ? si[threadIdx.x] : 0x7FFFFFFF;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, m);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, i, m);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (threadIdx.x == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

// Floats of shared memory the stages of a chunk x chunk sub-tile take: the
// image (chunk + 6)^2 and the blur (chunk + 4)^2, which the box means'
// three vertical passes, chunk (chunk + 2) each, overwrite; then Sobel's
// dx and dy, (chunk + 2)^2 each.
__host__ __device__ __forceinline__ int stage_floats(int chunk) {
  const int a = (chunk + 6) * (chunk + 6) + (chunk + 4) * (chunk + 4);
  const int v = 3 * chunk * (chunk + 2);
  return (a > v ? a : v) + 2 * (chunk + 2) * (chunk + 2);
}

// The stages of one sub-tile of the response (`response_chunk`), each a
// pass over a tile in shared memory whose entry (i, j) is the stage's value
// at the clamped coordinate of (origin + i, origin + j).  The block's
// threads are kCellRows rows of kCellCols columns: column lx of a stage (at
// most chunk + 6 <= kCellCols wide) is thread lx's, its rows ly, ly +
// kCellRows, ...; the loops are unrolled so that a thread's rows overlap,
// which the restrict-qualified tiles allow.

// `gaussian_blur3` of the image tile (origin (a - 3, b - 3), stride iw)
// into g (origin (a - 2, b - 2), gh x gw): [0.25, 0.5, 0.25] rows first.
__device__ __forceinline__ void blur_stage(const float* __restrict__ si, float* __restrict__ sg,
                                           int H, int W, int a, int b, int iw, int gh, int gw,
                                           int lx, int ly) {
  if (lx >= gw) return;
  const int x = clampi(b - 2 + lx, 0, W - 1);
  const int c0 = clampi(x - 1, 0, W - 1) - b + 3, c1 = x - b + 3;
  const int c2 = clampi(x + 1, 0, W - 1) - b + 3;
#pragma unroll kStageUnroll
  for (int r = ly; r < gh; r += kCellRows) {
    const int y = clampi(a - 2 + r, 0, H - 1);
    const float* r0 = si + (clampi(y - 1, 0, H - 1) - a + 3) * iw;
    const float* r1 = si + (y - a + 3) * iw;
    const float* r2 = si + (clampi(y + 1, 0, H - 1) - a + 3) * iw;
    const float v0 = tap3(r0[c0], r1[c0], r2[c0], 0.25f, 0.5f);
    const float v1 = tap3(r0[c1], r1[c1], r2[c1], 0.25f, 0.5f);
    const float v2 = tap3(r0[c2], r1[c2], r2[c2], 0.25f, 0.5f);
    sg[r * gw + lx] = tap3(v0, v1, v2, 0.25f, 0.5f);
  }
}

// `sobel_gradients` of g (origin (a - 2, b - 2), stride gw) into dx and dy
// (origin (a - 1, b - 1), dh x dw): the central difference first, then the
// [1, 2, 1] smoothing across it.
__device__ __forceinline__ void sobel_stage(const float* __restrict__ sg, float* __restrict__ sdx,
                                            float* __restrict__ sdy, int H, int W, int a, int b,
                                            int gw, int dh, int dw, int lx, int ly) {
  if (lx >= dw) return;
  const int x = clampi(b - 1 + lx, 0, W - 1);
  const int xm = clampi(x - 1, 0, W - 1) - b + 2, xc = x - b + 2;
  const int xp = clampi(x + 1, 0, W - 1) - b + 2;
#pragma unroll kStageUnroll
  for (int r = ly; r < dh; r += kCellRows) {
    const int y = clampi(a - 1 + r, 0, H - 1);
    const float* gm = sg + (clampi(y - 1, 0, H - 1) - a + 2) * gw;
    const float* gc = sg + (y - a + 2) * gw;
    const float* gp = sg + (clampi(y + 1, 0, H - 1) - a + 2) * gw;
    const float d0 = gm[xp] - gm[xm], d1 = gc[xp] - gc[xm], d2 = gp[xp] - gp[xm];
    sdx[r * dw + lx] = (d0 + 2.0f * d1) + d2;
    const float e0 = gp[xm] - gm[xm], e1 = gp[xc] - gm[xc], e2 = gp[xp] - gm[xp];
    sdy[r * dw + lx] = (e0 + 2.0f * e1) + e2;
  }
}

// The box means' vertical pass over dx dx, dy dy, dx dy (dx, dy at origin
// (a - 1, b - 1), stride dw) at rows [a, a + ty), columns from b - 1 (vw
// wide): into v[0], v[1], v[2].
__device__ __forceinline__ void vertical_stage(const float* __restrict__ sdx,
                                               const float* __restrict__ sdy,
                                               float* __restrict__ vxx, float* __restrict__ vyy,
                                               float* __restrict__ vxy, int H, int a, int ty,
                                               int dw, int vw, int lx, int ly) {
  if (lx >= vw) return;
#pragma unroll kStageUnroll
  for (int r = ly; r < ty; r += kCellRows) {
    const int y = a + r;
    const int i0 = (clampi(y - 1, 0, H - 1) - a + 1) * dw + lx, i1 = (r + 1) * dw + lx;
    const int i2 = (clampi(y + 1, 0, H - 1) - a + 1) * dw + lx;
    const float x0 = sdx[i0], x1 = sdx[i1], x2 = sdx[i2];
    const float y0 = sdy[i0], y1 = sdy[i1], y2 = sdy[i2];
    vxx[r * vw + lx] = tap3(x0 * x0, x1 * x1, x2 * x2, kThird, kThird);
    vyy[r * vw + lx] = tap3(y0 * y0, y1 * y1, y2 * y2, kThird, kThird);
    vxy[r * vw + lx] = tap3(x0 * y0, x1 * y1, x2 * y2, kThird, kThird);
  }
}

// The response of rows [a, a + ty) x columns [b, b + tx) (inside the
// image) into the tile rt (stride rw, origin (ry, rx)) and, for the pixels
// of the cell [y0, y0 + cell) x [x0, x0 + cell), into rs [H, W] and the
// thread's running best (bv, bi) in `better`'s order (tile index dy cell +
// dx).
__device__ void response_chunk(const float* im, int H, int W, int a, int b, int ty, int tx,
                               float* sa, float* sdx, float* sdy, float* rt, int rw, int ry,
                               int rx, int y0, int x0, int cell, float* rs, float& bv, int& bi) {
  const int lx = threadIdx.x % kCellCols, ly = threadIdx.x / kCellCols;
  // the image at origin (a - 3, b - 3): every load issued before the first store
  const int iw = tx + 6, ih = ty + 6;
  {
    const int x = clampi(b - 3 + lx, 0, W - 1);
    float v[kCellLoads];
#pragma unroll
    for (int k = 0; k < kCellLoads; ++k) {
      const int r = ly + k * kCellRows;
      v[k] = r < ih && lx < iw ? im[static_cast<long long>(clampi(a - 3 + r, 0, H - 1)) * W + x]
                               : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kCellLoads; ++k) {
      const int r = ly + k * kCellRows;
      if (r < ih && lx < iw) sa[r * iw + lx] = v[k];
    }
  }
  __syncthreads();
  const int gw = tx + 4, gh = ty + 4, dw = tx + 2, dh = ty + 2, vw = tx + 2;
  blur_stage(sa, sa + ih * iw, H, W, a, b, iw, gh, gw, lx, ly);
  __syncthreads();
  sobel_stage(sa + ih * iw, sdx, sdy, H, W, a, b, gw, dh, dw, lx, ly);
  __syncthreads();
  // (overwriting the image and the blur)
  float* vxx = sa;
  float* vyy = vxx + ty * vw;
  float* vxy = vyy + ty * vw;
  vertical_stage(sdx, sdy, vxx, vyy, vxy, H, a, ty, dw, vw, lx, ly);
  __syncthreads();
  // their horizontal pass and the min-eig
  if (lx < tx) {
    const int x = b + lx;
    const int cm = clampi(x - 1, 0, W - 1) - b + 1, cc = lx + 1;
    const int cp = clampi(x + 1, 0, W - 1) - b + 1;
    const bool own_x = x >= x0 && x < x0 + cell;
#pragma unroll kStageUnroll
    for (int r = ly; r < ty; r += kCellRows) {
      const int y = a + r, row = r * vw;
      const float sxx = tap3(vxx[row + cm], vxx[row + cc], vxx[row + cp], kThird, kThird);
      const float syy = tap3(vyy[row + cm], vyy[row + cc], vyy[row + cp], kThird, kThird);
      const float sxy = tap3(vxy[row + cm], vxy[row + cc], vxy[row + cp], kThird, kThird);
      const float half_trace = 0.5f * (sxx + syy);
      const float t = (sxx - syy) * 0.5f;
      const float v = (half_trace - sqrtf(t * t + sxy * sxy)) * kCvNorm;
      rt[(y - ry) * rw + x - rx] = v;
      if (own_x && y >= y0 && y < y0 + cell) {
        rs[static_cast<long long>(y) * W + x] = v;
        const int idx = (y - y0) * cell + x - x0;
        if (better(v, idx, bv, bi)) {
          bv = v;
          bi = idx;
        }
      }
    }
  }
  __syncthreads();      // the next chunk's image overwrites the vertical passes
}

// Block (cell, s): the response of the cell's pixels into resp [S, H, W]
// and of them and a 2-pixel ring into the tile (min(cell, H) + 4) x
// (min(cell, W) + 4) (dynamic shared memory, or `tiles` [S, C, that
// tile] when not null), in sub-tiles of at most chunk x chunk;
// `grid_argmax2`'s best peak over the cell x cell tile (-inf past the
// image: an in-image pixel, index 0 at worst, always wins over those, so
// the best is taken over the in-image pixels as the response is computed)
// and its second peak outside the disc of radius cell / 4 around the
// best; each peak's subpixel fit and gates; the cell's occupancy and the
// peaks' proximity (each thread the live keypoints k = thread, thread +
// kCellThreads, ..., the first loaded before the response, then the
// block's OR).  kSharedTile: the tile is in shared memory (else `tiles`).  Writes the row's scratch: cand [S, 6C] (x at j, y at 2C +
// j, score at 4C + j, with j = cid for the best peak and C + cid for the
// second) and flags [S, 3C] (the peak passing the border, occupancy,
// proximity and finiteness gates at j, the cell occupied at 2C + cid).
template <bool kSharedTile>
__global__ void __launch_bounds__(kCellThreads, kCellBlocks)
    detect_cells_kernel(const float* img, const float* ex_xy, const bool* ex_valid, int H, int W,
                        int K, int cell, int border, int gw, int C, int chunk, float* tiles,
                        float* resp, float* cand, int* flags) {
  __shared__ float sv[kCellWarps];
  __shared__ int si[kCellWarps];
  __shared__ int votes[kCellWarps];
  const long long s = blockIdx.y;
  const int cid = blockIdx.x;
  const int y0 = (cid / gw) * cell, x0 = (cid % gw) * cell;
  const int rh = imin(cell, H) + 4, rw = imin(cell, W) + 4;
  const float* im = img + s * H * W;
  float* const sa = dynamic_smem();
  const int dn = (chunk + 2) * (chunk + 2);
  float* const sdx = sa + stage_floats(chunk) - 2 * dn;
  float* const sdy = sdx + dn;
  float* const rt = kSharedTile ? sdy + dn : tiles + (s * C + cid) * (rh * rw);
  const float* ex = ex_xy + s * K * 2;
  const bool* exv = ex_valid + s * K;
  // this thread's first live keypoint, loaded while the image comes in
  const int k0 = threadIdx.x;
  const bool live0 = k0 < K && exv[k0];
  const float ex0 = k0 < K ? ex[2 * k0] : 0.0f, ey0 = k0 < K ? ex[2 * k0 + 1] : 0.0f;

  const int ry = y0 - 2, rx = x0 - 2;
  const int ya = imax(ry, 0), yb = imin(y0 + cell + 2, H);
  const int xa = imax(rx, 0), xb = imin(x0 + cell + 2, W);
  const int n = cell * cell;
  float v1 = neg_inf();
  int i1 = n;
  for (int a = ya; a < yb; a += chunk)
    for (int b = xa; b < xb; b += chunk)
      response_chunk(im, H, W, a, b, imin(chunk, yb - a), imin(chunk, xb - b), sa, sdx, sdy, rt,
                     rw, ry, rx, y0, x0, cell, resp + s * H * W, v1, i1);
  block_argmax<kCellWarps>(v1, i1, sv, si);

  // the second peak, thread (ly, lx) taking rows ly + kCellRows k, columns
  // lx + kCellCols m of the cell
  const int lx = threadIdx.x % kCellCols, ly = threadIdx.x / kCellCols;
  const int iy = i1 / cell, ix = i1 % cell, r = cell / 4;
  float v2 = neg_inf();
  int i2 = n;
  for (int dy = ly; dy < cell; dy += kCellRows)
    for (int dx = lx; dx < cell; dx += kCellCols) {
      const long long d2 = static_cast<long long>(dy - iy) * (dy - iy) +
                           static_cast<long long>(dx - ix) * (dx - ix);
      const float v = d2 <= static_cast<long long>(r) * r || y0 + dy >= H || x0 + dx >= W
                          ? neg_inf()
                          : rt[(dy + 2) * rw + dx + 2];
      if (better(v, dy * cell + dx, v2, i2)) {
        v2 = v;
        i2 = dy * cell + dx;
      }
    }
  block_argmax<kCellWarps>(v2, i2, sv, si);

  // each peak's subpixel fit on the tile (every thread alike)
  float px[2], py[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = p == 0 ? i1 : i2;
    const int x = clampi(x0 + t % cell, 1, W - 2), y = clampi(y0 + t / cell, 1, H - 2);
    const float* at = rt + (y - ry) * rw + x - rx;    // at[dy * rw + dx]: the 3 x 3 neighbourhood
    const float c0 = at[0];
    const float dxx = (at[1] + at[-1]) - 2.0f * c0;
    const float dyy = (at[rw] + at[-rw]) - 2.0f * c0;
    const float dxy = 0.25f * (((at[rw + 1] - at[rw - 1]) - at[-rw + 1]) + at[-rw - 1]);
    const float gx = 0.5f * (at[1] - at[-1]);
    const float gy = 0.5f * (at[rw] - at[-rw]);
    float det = dxx * dyy - dxy * dxy;
    det = fabsf(det) < kDetFloor ? kDetFloor : det;
    float ox = -(dyy * gx - dxy * gy) / det;
    float oy = -(dxx * gy - dxy * gx) / det;
    const bool good = fabsf(ox) <= 1.0f && fabsf(oy) <= 1.0f;
    px[p] = static_cast<float>(x) + (good ? ox : 0.0f);
    py[p] = static_cast<float>(y) + (good ? oy : 0.0f);
  }
  // the cell's occupancy and each peak's proximity over the live keypoints
  const double q4 = cell / 4.0;
  const float near2 = static_cast<float>(q4 * q4);
  bool occ = false, close1 = false, close2 = false;
  for (int k = k0; k < K; k += kCellThreads) {
    const bool live = k == k0 ? live0 : exv[k];
    const float ex_x = k == k0 ? ex0 : ex[2 * k], ex_y = k == k0 ? ey0 : ex[2 * k + 1];
    if (!live) continue;
    const long long kx = clampll(static_cast<long long>(ex_x), 0, W - 1);
    const long long ky = clampll(static_cast<long long>(ex_y), 0, H - 1);
    occ = occ || (ky / cell) * gw + kx / cell == cid;
    const float ax = px[0] - ex_x, ay = py[0] - ex_y, bx = px[1] - ex_x, by = py[1] - ex_y;
    close1 = close1 || ax * ax + ay * ay < near2;
    close2 = close2 || bx * bx + by * by < near2;
  }
  // the block's OR of the three flags: a ballot a warp, one barrier
  const unsigned bits = (__ballot_sync(0xFFFFFFFFu, occ) != 0 ? 1u : 0u) |
                        (__ballot_sync(0xFFFFFFFFu, close1) != 0 ? 2u : 0u) |
                        (__ballot_sync(0xFFFFFFFFu, close2) != 0 ? 4u : 0u);
  if (threadIdx.x % 32 == 0) votes[threadIdx.x / 32] = static_cast<int>(bits);
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned any = 0;
  for (int w = 0; w < kCellWarps; ++w) any |= static_cast<unsigned>(votes[w]);
  occ = any & 1u;
  close1 = any & 2u;
  close2 = any & 4u;
  float* cf = cand + s * kScratchF * C;
  int* fl = flags + s * kScratchI * C;
  fl[2 * C + cid] = occ;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = p * C + cid;
    const float sc = p == 0 ? v1 : v2;
    const bool in_border = px[p] >= static_cast<float>(border) &&
                           px[p] < static_cast<float>(W - border) &&
                           py[p] >= static_cast<float>(border) &&
                           py[p] < static_cast<float>(H - border);
    cf[j] = px[p];
    cf[2 * C + j] = py[p];
    cf[4 * C + j] = sc;
    fl[j] = in_border && !occ && !(p == 0 ? close1 : close2) && fabsf(sc) < INFINITY;
  }
}

// Sums of kN ints over the block's kW warps, into tot (shared, kN), every
// thread's `v` its share; `part` holds kW * kN ints.
template <int kW, int kN>
__device__ __forceinline__ void block_sums(int (&v)[kN], int* part, int* tot) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], m);
  }
  if (threadIdx.x % 32 == 0)
    for (int k = 0; k < kN; ++k) part[(threadIdx.x / 32) * kN + k] = v[k];
  __syncthreads();
  if (threadIdx.x < kN) {
    int t = 0;
    for (int w = 0; w < kW; ++w) t += part[w * kN + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// Candidate j's priority at threshold `thresh`: first peaks before second
// ones, then by score; -inf where it fails.
__device__ __forceinline__ float priority(const int* ok, const float* score, int j, int C,
                                          float thresh) {
  const float sc = score[j];
  if (!ok[j] || !(sc >= thresh)) return neg_inf();
  const float clipped = sc < 0.0f ? 0.0f : sc > 999.0f ? 999.0f : sc;
  return (j < C ? 1000.0f : 0.0f) + clipped;
}

// Block (x, s): the rest of `detect_grid` on row s from the cell kernel's
// scratch: the ladder's counts (every block of the row alike, each thread's
// loads issued at once), the rung and the new threshold (new_quality [S],
// from block 0), and the stable rank of candidates kRankPer x .. kRankPer x
// + kRankPer - 1 among the row's 2C, a warp per candidate counting over
// the priorities a tile of kRankTile at a time; a candidate of rank r < C
// goes to xy [S, C, 2], score [S, C] and valid [S, C] at r.
__global__ void __launch_bounds__(kRankThreads)
    detect_rank_kernel(const float* cand, const int* flags, const float* quality,
                       float quality_value, int C, float* xy, float* score_out, bool* valid_out,
                       float* new_quality) {
  constexpr int kPerWarp = kRankPer / kRankWarps;
  static_assert(kPerWarp * kRankWarps == kRankPer, "whole candidates a warp");
  __shared__ int part[kRankWarps * (1 + 2 * kRungs)];
  __shared__ int tot[1 + 2 * kRungs];
  __shared__ float tile[kRankTile];
  const long long s = blockIdx.y;
  const int C2 = 2 * C;
  const float* cf = cand + s * kScratchF * C;
  const float* score = cf + 4 * C;
  const int* ok = flags + s * kScratchI * C;
  const int* occ = ok + C2;
  const float q0 = quality != nullptr ? quality[s] : quality_value;

  float ladder[kRungs];
  for (int r = 0; r < kRungs; ++r) ladder[r] = q0 * static_cast<float>(1.0 / (1 << r));
  int counts[1 + 2 * kRungs] = {};
  for (int j = threadIdx.x; j < C2; j += kRankThreads) {
    const int okj = ok[j], oc = j < C ? occ[j] : 0;
    const float sc = score[j];
    const int first = j < C;
    counts[0] += oc;
#pragma unroll
    for (int r = 0; r < kRungs; ++r) {       // first peaks' counts, then second ones'
      const int hit = okj && sc >= ladder[r];
      counts[1 + r] += hit & first;
      counts[1 + kRungs + r] += hit & !first;
    }
  }
  block_sums<kRankWarps>(counts, part, tot);

  // the ladder's rung and the new threshold
  const float empty = static_cast<float>(C - tot[0]);
  float n_eff[kRungs];
  int rung = kRungs - 1;
  for (int r = kRungs - 1; r >= 0; --r) {
    const float n1 = static_cast<float>(tot[1 + r]), n2 = static_cast<float>(tot[1 + kRungs + r]);
    const float spare = empty - n1 > 0.0f ? empty - n1 : 0.0f;
    n_eff[r] = n1 + (n2 < spare ? n2 : spare);
    if (n_eff[r] >= kFill * empty) rung = r;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float factor = n_eff[kRungs - 1] < kStarve * empty ? 0.5f
                         : n_eff[0] > kFill * empty          ? 1.5f
                                                             : 1.0f;
    const float q = q0 * factor;
    new_quality[s] = q < kQualityMin ? kQualityMin : q > 1.0f ? 1.0f : q;
  }

  // ops/topk.py's stable descending sort: the block's candidates' ranks
  const float thresh = ladder[rung];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int js[kPerWarp], rank[kPerWarp];
  float pj[kPerWarp];
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    js[m] = blockIdx.x * kRankPer + m * kRankWarps + warp;
    pj[m] = js[m] < C2 ? priority(ok, score, js[m], C, thresh) : 0.0f;
    rank[m] = 0;
  }
  for (int t0 = 0; t0 < C2; t0 += kRankTile) {
    const int n = imin(kRankTile, C2 - t0);
    for (int i = threadIdx.x; i < n; i += kRankThreads)
      tile[i] = priority(ok, score, t0 + i, C, thresh);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPerWarp; ++m) {
      if (js[m] >= C2) continue;
      for (int i = lane; i < n; i += 32) {
        const float q = tile[i];
        rank[m] += q > pj[m] || (q == pj[m] && t0 + i < js[m]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) rank[m] += __shfl_xor_sync(0xFFFFFFFFu, rank[m], k);
    const int j = js[m];
    if (lane != 0 || j >= C2 || rank[m] >= C) continue;
    const long long o = s * C + rank[m];
    const bool v = pj[m] != neg_inf();
    xy[2 * o] = cf[j];
    xy[2 * o + 1] = cf[C2 + j];
    score_out[o] = v ? score[j] : 0.0f;
    valid_out[o] = v;
  }
}

// ---------------------------------------------------------------------------
// K3: ORB describe
// ---------------------------------------------------------------------------

// Block (x, s): keypoints kPer x .. kPer x + kPer - 1 of row s (kPer = 4 /
// kWarps), warps kWarps t .. kWarps t + kWarps - 1 keypoint t's, warp b of
// them rows kBand b .. of its 31 x 31 footprint (the last band padded past
// row 30 with rows of the patch that nothing reads: every warp runs the
// same straight-line code, no branch per row).  img [S, H,
// W], xy [S, N, 2], valid [S, N], taps [30, 256] (each bin's steered pairs,
// flat patch indices i0 | i1 << 16) → desc [S, N, 8] (zeros where
// invalid), angle [S, N].  A keypoint past N computes keypoint N - 1 and
// stores nothing, so that every warp meets the block's barriers.
template <int kWarps>
__global__ void __launch_bounds__(kDescThreads)
    describe_kernel(const float* img, int H, int W, const float* xy, const bool* valid,
                    const unsigned* taps, int N, int blur, unsigned* desc, float* angle) {
  constexpr int kPer = kDescThreads / 32 / kWarps;        // keypoints a block
  constexpr int kBand = (kSide + kWarps - 1) / kWarps;    // rows a warp
  constexpr int kRows = kBand * kWarps;                   // a keypoint's tile rows: 31 or 32
  constexpr int kWords = kBits / 32 / kWarps;             // descriptor words a warp
  static_assert(kPer * kWarps * 32 == kDescThreads && kWords * kWarps * 32 == kBits,
                "whole keypoints a block, whole words a warp");
  static_assert(kRows + 4 <= kPatch, "a band's window rows lie inside the patch");
  __shared__ float tiles[kPer][kRows * kPatch];           // the vertical pass, then the patch
  __shared__ double part[kPer][kWarps][2];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int team = warp / kWarps, band = warp % kWarps;
  const int k = blockIdx.x * kPer + team;
  const bool live = k < N;
  const long long s = blockIdx.y;
  const long long n = s * N + (live ? k : N - 1);
  const float* im = img + s * H * W;
  // `_patch_centers`: the rounded keypoint, clamped so the patch stays inside
  const long long px = static_cast<long long>(floorf(xy[2 * n] + 0.5f));
  const long long py = static_cast<long long>(floorf(xy[2 * n + 1] + 0.5f));
  const int cx = static_cast<int>(clampll(px, kPatchLo, W - (kPatch - kPatchLo)));
  const int cy = static_cast<int>(clampll(py, kPatchLo, H - (kPatch - kPatchLo)));
  const bool ok = valid[n];
  float* const tile = tiles[team];
  const int r0 = band * kBand;                    // the band's first footprint row
  // the patch from row 2 - 2 + r0 (the window): footprint pixel (i, j) is
  // image pixel (cy - 15 + i, cx - 15 + j); every row and column read below
  // lies in the patch, so inside the image
  const float* win = im + static_cast<long long>(cy - kRadius - 2 + r0) * W + cx - kRadius - 2;
  float p[kBand];                                 // footprint column `lane` of the band
  if (blur) {      // `_sep_conv(img, [0.2] * 5)`: rows first, then columns
    // window columns lane and, for lanes 0-2, lane + 32 (the others load
    // column 35 and drop it), every load issued before the first sum
    const int c2 = imin(lane + 32, kWin);
    float a[kBand + 4], b[kBand + 4];
#pragma unroll
    for (int r = 0; r < kBand + 4; ++r) {
      a[r] = win[r * W + lane];
      b[r] = win[r * W + c2];
    }
#pragma unroll
    for (int r = 0; r < kBand; ++r) {
      float* t = tile + (r0 + r) * kPatch + lane;
      t[0] = tap5(a[r], a[r + 1], a[r + 2], a[r + 3], a[r + 4], kFifth, kFifth, kFifth);
      const float v = tap5(b[r], b[r + 1], b[r + 2], b[r + 3], b[r + 4], kFifth, kFifth, kFifth);
      if (c2 < kWin) t[32] = v;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kBand; ++r) {    // lane 31's sums read column 35, never written
      const float* q = tile + (r0 + r) * kPatch + lane;
      p[r] = tap5(q[0], q[1], q[2], q[3], q[4], kFifth, kFifth, kFifth);
    }
    __syncwarp();  // the band's vertical pass read: its patch rows take its place
  } else {
#pragma unroll
    for (int r = 0; r < kBand; ++r) p[r] = win[(r + 2) * W + lane + 2];
  }

  // `_moment_angle`: each term the plain version's float32 product (lane
  // 31's column and the padding rows lie outside the circle: zero terms),
  // summed in float64 down the lane's column in kDescSums partial sums, then
  // over the warp (every lane gets the sum) and the keypoint's warps in order
  double s10[kDescSums], s01[kDescSums];
#pragma unroll
  for (int j = 0; j < kDescSums; ++j) s10[j] = s01[j] = 0.0;
  const int ox = lane - kRadius;
#pragma unroll
  for (int r = 0; r < kBand; ++r) {
    const int oy = r0 + r - kRadius;
    tile[(r0 + r) * kPatch + lane] = p[r];
    const float v = ox * ox + oy * oy <= kRadius * kRadius ? p[r] : 0.0f;
    s10[r % kDescSums] += static_cast<double>(v * static_cast<float>(ox));
    s01[r % kDescSums] += static_cast<double>(v * static_cast<float>(oy));
  }
  double m10 = s10[0], m01 = s01[0];
#pragma unroll
  for (int j = 1; j < kDescSums; ++j) {
    m10 += s10[j];
    m01 += s01[j];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    m10 += __shfl_xor_sync(0xFFFFFFFFu, m10, m);
    m01 += __shfl_xor_sync(0xFFFFFFFFu, m01, m);
  }
  if (kWarps > 1 && lane == 0) {
    part[team][band][0] = m10;
    part[team][band][1] = m01;
  }
  // the patch (and, with several warps, their sums) in shared memory
  if (kWarps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  if (kWarps > 1) {
    m10 = m01 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      m10 += part[team][w][0];
      m01 += part[team][w][1];
    }
  }
  const float ang = atan2f(static_cast<float>(m01), static_cast<float>(m10));
  // torch.remainder(angle, 2 pi), then the card's division by a Python
  // float (a product with its float32 reciprocal), the bin rounded
  float rem = fmodf(ang, kTwoPi);
  if (rem < 0.0f) rem += kTwoPi;
  const float f = floorf(rem * (1.0f / kTwoPi) * static_cast<float>(kAngleBins) + 0.5f);
  const long long bl = static_cast<long long>(f) % kAngleBins;
  const int bin = static_cast<int>(bl < 0 ? bl + kAngleBins : bl);
  if (live && band == 0 && lane == 0) angle[n] = ang;

  // the band's words: bit 32 w + lane of word w from a steered compare of
  // bf16-rounded pixels, the pairs' loads issued together
  const unsigned* tb = taps + bin * kBits + band * kWords * 32 + lane;
  unsigned pairs[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) pairs[j] = __ldg(tb + 32 * j);
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const float* t0 = tile + (pairs[j] & 0xFFFFu) - kTileBase;
    const float* t1 = tile + (pairs[j] >> 16) - kTileBase;
    const float v0 = __bfloat162float(__float2bfloat16_rn(*t0));
    const float v1 = __bfloat162float(__float2bfloat16_rn(*t1));
    const unsigned word = __ballot_sync(0xFFFFFFFFu, v1 - v0 > 0.0f);
    if (lane == j) mine = word;
  }
  if (live && lane < kWords) desc[n * 8 + band * kWords + lane] = ok ? mine : 0u;
}


// ---------------------------------------------------------------------------
// K8: CLAHE
// ---------------------------------------------------------------------------

// torch.clamp(torch.round(x), 0, 255) as an int: rintf rounds half to even,
// as torch.round does
__device__ __forceinline__ int clahe_bin(float x) {
  return static_cast<int>(fminf(fmaxf(rintf(x), 0.0f), static_cast<float>(kClaheBins - 1)));
}

// V consecutive floats at p (V = 4: one 16-byte load or store, p 16-byte
// aligned; V = 1: one float)
template <int V>
__device__ __forceinline__ void clahe_load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void clahe_store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// A band's first row and its rows: `n` rows split into `parts` bands, the
// first n % parts of them a row longer
__device__ __forceinline__ int clahe_band(int n, int parts, int band, int& rows) {
  const int base = n / parts, extra = n - base * parts;
  rows = base + (band < extra ? 1 : 0);
  return band * base + imin(band, extra);
}

// Count the rounded pixels of `rows` rows of `cols` at p (row pitch W
// floats) into `hist`, V pixels a load (V = 4: cols a multiple of 4, p
// 16-byte aligned): thread k takes loads k, k + kClaheThreads, ...,
// kClaheCountUnroll of them issued together before their counts, each load's
// row and column stepped from the last without a division.
template <int V>
__device__ __forceinline__ void clahe_count(const float* p, int rows, int cols, int W,
                                            unsigned* hist) {
  const int q = cols / V, dr = kClaheThreads / q, dc = kClaheThreads - dr * q;
  const long long n = static_cast<long long>(rows) * q;
  int r = threadIdx.x / q, c = threadIdx.x - r * q;
  for (long long i = threadIdx.x; i < n; i += kClaheCountUnroll * kClaheThreads) {
    float v[kClaheCountUnroll][V];
#pragma unroll
    for (int u = 0; u < kClaheCountUnroll; ++u) {
      if (i + u * kClaheThreads < n) clahe_load<V>(p + static_cast<long long>(r) * W + c * V, v[u]);
      c += dc;
      r += dr;
      if (c >= q) {
        c -= q;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kClaheCountUnroll; ++u)
      if (i + u * kClaheThreads < n)
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(&hist[clahe_bin(v[u][j])], 1u);
  }
}

// One table of img [B, H, W] → lut [B, tiles * tiles, kClaheBins]: a
// block per (tile t = ty * tiles + tx, image b), its pixels counted into
// its warps' histograms (integer atomics: the counts do not depend on
// their order), their sum a bin in thread k.  Then thread k on bin k: the
// clip's excess, sum of max(h - c, 0), by a shuffle sum a warp and the
// warps' sums in order; min(h, c) + excess / 256; its prefix in float64
// by a shuffle scan a warp and the totals of the warps before (exact in
// any order: at these tiles' sizes the partial sums need ~40 of float64's
// 53 bits), each entry rounded once to float32; then (cdf - cdf0) /
// max(cdfN - cdf0, 1) * 255 in float32, the plain version's order.
// `wide`: 16-byte loads (the tile side a multiple of 4, img 16-byte
// aligned).
__global__ void __launch_bounds__(kClaheThreads)
    clahe_lut_kernel(const float* img, int H, int W, int tiles, int wide, float clip_limit,
                     float* lut) {
  __shared__ unsigned warp_hist[kClaheWarps][kClaheBins];   // each warp's own histogram
  __shared__ double scan[kClaheWarps];                      // each warp's prefix total
  __shared__ float excess_of[kClaheWarps];                  // each warp's excess sum
  __shared__ float first;                                   // bin 0's entry: the CDF's first value
  const int k = threadIdx.x, warp = k / 32, lane = k % 32;
  const int t = blockIdx.x, b = blockIdx.y;
  unsigned* hists = &warp_hist[0][0];
  for (int i = k; i < kClaheWarps * kClaheBins; i += kClaheThreads) hists[i] = 0u;
  __syncthreads();
  const int th = H / tiles, tw = W / tiles, ty = t / tiles, tx = t - ty * tiles;
  const float* tile = img + (static_cast<long long>(b) * H + static_cast<long long>(ty) * th) * W +
                      static_cast<long long>(tx) * tw;
  if (wide)
    clahe_count<4>(tile, th, tw, W, warp_hist[warp]);
  else
    clahe_count<1>(tile, th, tw, W, warp_hist[warp]);
  __syncthreads();
  unsigned n = 0;
#pragma unroll
  for (int w = 0; w < kClaheWarps; ++w) n += warp_hist[w][k];
  const float h = static_cast<float>(n);
  float e = fmaxf(h - clip_limit, 0.0f);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) e += __shfl_xor_sync(0xFFFFFFFFu, e, m);
  if (lane == 0) excess_of[warp] = e;
  __syncthreads();
  float excess = 0.0f;
#pragma unroll
  for (int w = 0; w < kClaheWarps; ++w) excess += excess_of[w];
  const float v = fminf(h, clip_limit) + excess / 256.0f;
  double sum = static_cast<double>(v);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double x = __shfl_up_sync(0xFFFFFFFFu, sum, d);
    if (lane >= d) sum += x;
  }
  if (lane == 31) scan[warp] = sum;
  if (k == 0) first = v;
  __syncthreads();
  double before = 0.0, total = 0.0;
#pragma unroll
  for (int w = 0; w < kClaheWarps; ++w) {
    if (w < warp) before += scan[w];
    total += scan[w];
  }
  const float cdf = static_cast<float>(before + sum), cdf0 = first;
  lut[(static_cast<long long>(b) * tiles * tiles + t) * kClaheBins + k] =
      (cdf - cdf0) / fmaxf(static_cast<float>(total) - cdf0, 1.0f) * 255.0f;
}

// A row's (or column's) two tiles and the weight of the second, as the
// plain version computes them: (i + 0.5) / side - 0.5 in float32 (IEEE
// division), its floor clamped to [0, tiles - 1], the next tile clamped
// too, the fraction clamped to [0, 1].
__device__ __forceinline__ float clahe_weight(int i, int side, int tiles, int& t0, int& t1) {
  const float u = (static_cast<float>(i) + 0.5f) / static_cast<float>(side) - 0.5f;
  t0 = static_cast<int>(fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(tiles - 1)));
  t1 = imin(t0 + 1, tiles - 1);
  return fminf(fmaxf(u - static_cast<float>(t0), 0.0f), 1.0f);
}

// img [B, H, W] → out [B, H, W]: blocks striding over the stack's bands
// (frame b, tile (ty, tx), one of `bands` bands of its rows, at most
// kClaheBandRows each; band fastest, then tile, then frame).  A block
// stages the tables of the 3 x 3 tiles around its tile that exist (slot 3
// (sy - ty + 1) + (sx - tx + 1)) by 16-byte loads, and its rows' weights
// and slots, in shared memory; a thread takes V columns (V = 4: the tile
// side a multiple of 4, img and out 16-byte aligned: one 16-byte load and
// store), their weights and slots in registers (taken before the tables
// are staged), and every step-th row of the band, kClaheUnroll rows' loads
// issued together; each pixel's four tables are read at its rounded value
// and blended as v00 (1 - fy) (1 - fx) + v01 (1 - fy) fx + v10 fy (1 - fx)
// + v11 fy fx, left to right.
template <int V>
__global__ void __launch_bounds__(kClaheThreads, kClaheApplyBlocks)
    clahe_apply_kernel(const float* img, const float* lut, int B, int H, int W, int tiles,
                       int bands, float* out) {
  constexpr int kQuads = kClaheBins / 4;
  __shared__ float4 staged[9 * kQuads];
  __shared__ float row_w[kClaheBandRows];
  __shared__ int row_slots[kClaheBandRows];
  const float* table = reinterpret_cast<const float*>(staged);
  const int k = threadIdx.x;
  const int th = H / tiles, tw = W / tiles, q = tw / V, per_frame = tiles * tiles * bands;
  const int lanes = imin(q, kClaheThreads), step = kClaheThreads / lanes;  // a row's threads, rows a pass
  const int c0 = k % lanes;
  int b = static_cast<int>(blockIdx.x / per_frame), at = static_cast<int>(blockIdx.x % per_frame);
  for (; b < B; at += gridDim.x) {
    while (at >= per_frame) {
      at -= per_frame;
      ++b;
    }
    if (b >= B) break;
    const int band = at % bands, t = at / bands, ty = t / tiles, tx = t - ty * tiles;
    int rows;
    const int y = ty * th + clahe_band(th, bands, band, rows), x = tx * tw;
    const long long frame = static_cast<long long>(b) * H;
    const float* src = img + (frame + y) * W + x;
    float* dst = out + (frame + y) * W + x;
    float fx[V];
    int s0[V], s1[V];
    const auto columns = [&](int c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        int a0, a1;
        fx[j] = clahe_weight(x + c * V + j, tw, tiles, a0, a1);
        s0[j] = (a0 - tx + 1) * kClaheBins;
        s1[j] = (a1 - tx + 1) * kClaheBins;
      }
    };
    columns(c0);
    __syncthreads();      // the previous band's reads are done
    for (int i = k; i < 9 * kQuads; i += kClaheThreads) {
      const int j = i / kQuads, sy = ty - 1 + j / 3, sx = tx - 1 + j % 3;
      if (sy >= 0 && sy < tiles && sx >= 0 && sx < tiles)
        staged[i] = __ldg(reinterpret_cast<const float4*>(
                              lut + ((static_cast<long long>(b) * tiles + sy) * tiles + sx) *
                                        kClaheBins) +
                          i % kQuads);
    }
    for (int r = k; r < rows; r += kClaheThreads) {
      int a0, a1;
      row_w[r] = clahe_weight(y + r, th, tiles, a0, a1);
      row_slots[r] = (3 * (a0 - ty + 1) * kClaheBins) | (3 * (a1 - ty + 1) * kClaheBins) << 12;
    }
    __syncthreads();
    if (k >= step * lanes) continue;
    for (int c = c0; c < q; c += lanes) {
      if (c != c0) columns(c);
      for (int r = k / lanes; r < rows; r += kClaheUnroll * step) {
        float v[kClaheUnroll][V];
#pragma unroll
        for (int u = 0; u < kClaheUnroll; ++u)
          if (r + u * step < rows)
            clahe_load<V>(src + static_cast<long long>(r + u * step) * W + c * V, v[u]);
#pragma unroll
        for (int u = 0; u < kClaheUnroll; ++u) {
          const int rr = r + u * step;
          if (rr >= rows) break;
          const float fy = row_w[rr], gy = 1.0f - fy;
          const float* t0 = table + (row_slots[rr] & 0xFFF);
          const float* t1 = table + (row_slots[rr] >> 12);
          float o[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int bin = clahe_bin(v[u][j]);
            const float gx = 1.0f - fx[j];
            o[j] = t0[s0[j] + bin] * gy * gx + t0[s1[j] + bin] * gy * fx[j] +
                   t1[s0[j] + bin] * fy * gx + t1[s1[j] + bin] * fy * fx[j];
          }
          clahe_store<V>(dst + static_cast<long long>(rr) * W + c * V, o);
        }
      }
    }
  }
}


unsigned blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// K5's launch for H x W images at `cell`: the sub-tiles' side (the
// response region's larger side split evenly into pieces of at most
// kMaxChunk), the cell kernel's dynamic shared memory, and the response
// tile's floats, which stay in shared memory where they fit.
struct DetectPlan {
  int chunk;
  int smem_bytes;
  bool shared_tile;
  long long tile_floats;
};

DetectPlan detect_plan(int H, int W, int cell) {
  const int rh = (cell < H ? cell : H) + 4, rw = (cell < W ? cell : W) + 4;
  const int side = rh > rw ? rh : rw;
  const int pieces = (side + kMaxChunk - 1) / kMaxChunk;
  const int chunk = (side + pieces - 1) / pieces;
  const long long stage = stage_floats(chunk), tile = static_cast<long long>(rh) * rw;
  const bool shared = (stage + tile) * 4 <= kCellSmemBytes;
  return {chunk, static_cast<int>((stage + (shared ? tile : 0)) * 4), shared, tile};
}

}  // namespace

// out [pixels] float32 from rgba [pixels, channels] (channels 3 or 4; u8
// when `is_float` is 0, float32 otherwise) on `stream`.
extern "C" int image_gray_launch(const void* rgba, int is_float, int channels, long long pixels,
                                 void* out, void* stream) {
  if (channels < 3 || channels > 4 || pixels < 0 || pixels > (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long quads = pixels / 4;
  long long grid = (quads + kGrayThreads - 1) / kGrayThreads;
  grid = grid > static_cast<long long>(kGrayBlocksPerSm) * sms ? kGrayBlocksPerSm * sms : grid;
  const unsigned g = static_cast<unsigned>(grid < 1 ? 1 : grid);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto at = [&](int align) {
    return static_cast<int>(reinterpret_cast<unsigned long long>(rgba) % align == 0);
  };
  const int wide_out = reinterpret_cast<unsigned long long>(out) % 16 == 0;
  float* o = static_cast<float*>(out);
  if (is_float) {
    const auto p = static_cast<const float*>(rgba);
    if (channels == 4) {
      const auto kernel = gray_kernel<float, 4>;
      kernel<<<g, kGrayThreads, 0, st>>>(p, pixels, at(GrayVec<float, 4>::kAlign), wide_out, o);
    } else {
      const auto kernel = gray_kernel<float, 3>;
      kernel<<<g, kGrayThreads, 0, st>>>(p, pixels, at(GrayVec<float, 3>::kAlign), wide_out, o);
    }
  } else {
    const auto p = static_cast<const unsigned char*>(rgba);
    if (channels == 4) {
      const auto kernel = gray_kernel<unsigned char, 4>;
      kernel<<<g, kGrayThreads, 0, st>>>(p, pixels, at(GrayVec<unsigned char, 4>::kAlign),
                                         wide_out, o);
    } else {
      const auto kernel = gray_kernel<unsigned char, 3>;
      kernel<<<g, kGrayThreads, 0, st>>>(p, pixels, at(GrayVec<unsigned char, 3>::kAlign),
                                         wide_out, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The next `levels` (1 or 2) pyramid levels of img [B, H, W] float32 on
// `stream`: out1 [B, ceil(H / 2), ceil(W / 2)] and, with 2, out2 [B,
// ceil(H1 / 2), ceil(W1 / 2)] from it.
extern "C" int image_pyramid_launch(const void* img, int B, int H, int W, int levels, void* out1,
                                    void* out2, void* stream) {
  if (B < 0 || H < 1 || W < 1 || levels < 1 || levels > 2 || (levels == 2 && out2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2, H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
  const long long tiles = static_cast<long long>((H2 + kPyrTileY - 1) / kPyrTileY) *
                          ((W2 + kPyrTileX - 1) / kPyrTileX);
  const long long n = tiles * B;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  pyramid_kernel<<<static_cast<unsigned>(n), kPyrThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, H1, W1, H2, W2, static_cast<float*>(out1),
      levels == 2 ? static_cast<float*>(out2) : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The floats of global scratch per row and cell that `detect_grid_launch`
// needs for the response tiles at H x W and `cell`: 0 where each tile
// fits in its block's shared memory.
extern "C" long long detect_tile_floats(int H, int W, int cell) {
  if (H < 1 || W < 1 || cell < 1) return -1;
  const DetectPlan p = detect_plan(H, W, cell);
  return p.shared_tile ? 0 : p.tile_floats;
}

// `detect_grid` on S rows in two launches: img [S, H, W] float32, ex_xy
// [S, K, 2] float32, ex_valid [S, K] bool, quality [S] float32 or null
// (then `quality_value` for every row); wsf [S, kScratchF C] float32, wsi
// [S, kScratchI C] int32 and tiles [S, C, detect_tile_floats(H, W, cell)]
// float32 (null where that is 0) are scratch; resp [S, H, W] float32 (the
// response), xy [S, C, 2] float32, score [S, C] float32, valid [S, C]
// bool, new_quality [S] float32, with C = ceil(H / cell) ceil(W / cell).
extern "C" int detect_grid_launch(const void* img, const void* ex_xy, const void* ex_valid,
                                  const void* quality, float quality_value, int S, int H, int W,
                                  int K, int cell, int border, void* tiles, void* resp, void* wsf,
                                  void* wsi, void* xy, void* score, void* valid,
                                  void* new_quality, void* stream) {
  if (S < 1 || S > kMaxRows || H < 3 || W < 3 || K < 0 || cell < 1 || cell > 46340)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gh = (H + cell - 1) / cell, gw = (W + cell - 1) / cell;
  const long long C = static_cast<long long>(gh) * gw;
  const DetectPlan p = detect_plan(H, W, cell);
  if (C > (1 << 24) || p.tile_floats > 0x7FFFFFFFLL || (!p.shared_tile && tiles == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const auto cells = p.shared_tile ? detect_cells_kernel<true> : detect_cells_kernel<false>;
  if (p.smem_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(cells, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* f = static_cast<float*>(wsf);
  int* n = static_cast<int*>(wsi);
  cells<<<dim3(static_cast<unsigned>(C), S), kCellThreads, p.smem_bytes, st>>>(
      static_cast<const float*>(img), static_cast<const float*>(ex_xy),
      static_cast<const bool*>(ex_valid), H, W, K, cell, border, gw, static_cast<int>(C), p.chunk,
      p.shared_tile ? nullptr : static_cast<float*>(tiles), static_cast<float*>(resp), f, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  detect_rank_kernel<<<dim3(blocks(2 * C, kRankPer), S), kRankThreads, 0, st>>>(
      f, n, static_cast<const float*>(quality), quality_value, static_cast<int>(C),
      static_cast<float*>(xy), static_cast<float*>(score), static_cast<bool*>(valid),
      static_cast<float*>(new_quality));
  return static_cast<int>(cudaGetLastError());
}

// `describe` on S rows of N keypoints: img [S, H, W] float32 (H, W >= 36),
// xy [S, N, 2] float32, valid [S, N] bool, taps [30, 256] int32 (each pair's
// flat patch indices i0 | i1 << 16) → desc [S, N, 8] int32, angle [S, N]
// float32, on `stream`.
extern "C" int describe_launch(const void* img, const void* xy, const void* valid,
                               const void* taps, int S, int H, int W, int N, int blur,
                               void* desc, void* angle, void* stream) {
  if (S < 1 || S > kMaxRows || H < kPatch || W < kPatch || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const long long keypoints = static_cast<long long>(S) * N;
  const int warps = keypoints <= kDescWideKeypoints ? 4 : 1;
  const auto kernel = warps == 4 ? describe_kernel<4> : describe_kernel<1>;
  kernel<<<dim3(blocks(N, kDescThreads / 32 / warps), S), kDescThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(xy),
      static_cast<const bool*>(valid), static_cast<const unsigned*>(taps), N, blur,
      static_cast<unsigned*>(desc), static_cast<float*>(angle));
  return static_cast<int>(cudaGetLastError());
}

// CLAHE of img [B, H, W] float32 (H and W multiples of `tiles`) in two
// launches on `stream` (the current device's): lut [B, tiles * tiles,
// 256] float32 (a block a tile), then out [B, H, W] float32 (at most
// kClaheApplyBlocks blocks a multiprocessor striding over the tiles'
// bands).  `clip_limit` is max(clip th tw / 256, 1) rounded to float32.
extern "C" int image_clahe_launch(const void* img, int B, int H, int W, int tiles,
                                  float clip_limit, void* lut, void* out, void* stream) {
  if (B < 1 || B > kMaxRows || tiles < 1 || tiles > kMaxTiles || H < tiles || W < tiles ||
      H % tiles != 0 || W % tiles != 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const float*>(img);
  float* table = static_cast<float*>(lut);
  const int th = H / tiles, tw = W / tiles;
  const auto aligned = [](const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; };
  const bool wide = tw % 4 == 0 && aligned(img);
  clahe_lut_kernel<<<dim3(tiles * tiles, B), kClaheThreads, 0, st>>>(
      in, H, W, tiles, static_cast<int>(wide), clip_limit, table);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tile_count = static_cast<long long>(B) * tiles * tiles;
  int bands = (th + kClaheBandRows - 1) / kClaheBandRows;
  const long long band_fill = static_cast<long long>(kClaheBandFill) * sms;
  const long long more = (band_fill + tile_count - 1) / tile_count;
  if (more > bands) bands = static_cast<int>(more < th ? more : th);
  const long long items = tile_count * bands, most = static_cast<long long>(kClaheApplyBlocks) * sms;
  const unsigned grid = static_cast<unsigned>(items > most ? most : items);
  const auto apply = wide && aligned(out) ? clahe_apply_kernel<4> : clahe_apply_kernel<1>;
  apply<<<grid, kClaheThreads, 0, st>>>(in, table, B, H, W, tiles, bands,
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The limits the wrappers check before a launch, and K5's scratch per row
// in units of C that they allocate (ops/image_kernels.py).
extern "C" int image_kernel_limits(int* max_rows, int* patch, int* bits, int* angle_bins,
                                   int* scratch_f, int* scratch_i, int* max_tiles) {
  *max_rows = kMaxRows;
  *patch = kPatch;
  *bits = kBits;
  *angle_bins = kAngleBins;
  *scratch_f = kScratchF;
  *scratch_i = kScratchI;
  *max_tiles = kMaxTiles;
  return 0;
}
