// The image kernels of the frame and of the keyframe pass, the port's
// counterparts of three XLA formulations of the JAX package (none of them a
// Pallas kernel; the JAX package compiles them into its jitted step):
//
// * K7, alvaar_tpu/ops/image.py:23-63: `rgba_to_gray` (BT.601 luma of an
//   RGB(A) frame, u8 or float32) as `gray_kernel`, and `pyr_down` (the
//   5-tap binomial blur and 2x decimation of one pyramid level) as
//   `pyr_down_kernel`, over a stack of B images in one launch.
// * K5, alvaar_tpu/ops/detect.py:159-252: the whole of `detect_grid` in
//   three launches: `detect_blur_kernel` (the 3x3 Gaussian pre-blur),
//   `detect_cells_kernel` (a block per grid cell: the Shi-Tomasi response
//   of every pixel of the cell, written out, then the cell's best and
//   second peak), `detect_select_kernel` (a block per row: the subpixel
//   fit of the 2C peaks, the occupancy, proximity, border and finiteness
//   gates, the 5-rung threshold ladder, the new threshold, and the
//   priority selection of C of the 2C candidates).
// * K3, alvaar_tpu/ops/orb.py:96-149: `describe`, a block per keypoint:
//   the 0.2 box blur of the 40 x 40 window the keypoint's 36 x 36 patch
//   needs, the intensity-centroid angle over the 31-px circle, its
//   steering bin, and 256 steered compares of bf16-rounded pixels, a
//   warp's ballot per descriptor word.
//
// Each computes what its plain version (alvaar_tpu_torch/ops/image.py,
// detect.py, orb.py) computes, operation for operation: the stencils'
// taps in `_sep_conv`'s order (rows first, then columns, ((0 + k0 x0) +
// k1 x1) + ...), edge-clamped indices at every stage, Sobel's difference
// first, the box means, the min-eig; build with --fmad=false, so that no
// multiply-add is contracted.  So K7 and K5 are bit-equal to their plain
// versions.  K3's moments are 961-term sums, which the plain version takes
// with torch.sum in an order no kernel reproduces: here each term is the
// plain version's float32 product, summed in float64 and rounded once, so
// the angle is within a few float32 ulps of the plain one and a
// descriptor can differ only where that angle lies on a steering-bin
// boundary.
//
// The per-cell argmax follows torch.argmax: NaN above every number, ties
// to the first index, cells past the image's edge padded with -inf (an
// all -inf cell gives index 0).  The selection is ops/topk.py's stable
// descending sort of the 2C priorities: a candidate's rank is the count of
// greater priorities plus equal ones at lower indices.  No atomics: every
// output has one owner in its launch.
//
// Every kernel takes a leading S (or B) rows, so one launch serves a
// stack of frames or the rows of a torch.func.vmap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // the pixel kernels, the cell kernel, K3 (one per bit)
constexpr int kSelectThreads = 512;   // the selection: a block per row
constexpr int kWarps = kThreads / 32;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kMaxRows = 65535;       // S: grid.y of the cell and describe kernels

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
// K5's scratch per row, in units of C: floats (the peaks' scores, x, y,
// priorities, 2C each) and ints (the peaks' tile indices 2C, the occupied
// cells C, the candidates' flags 2C)
constexpr int kScratchF = 8;
constexpr int kScratchI = 5;

// ORB's geometry (ops/orb.py)
constexpr int kPatch = 36;            // _PSZ: the patch covers [-17, +18] around its centre
constexpr int kPatchLo = 17;          // _PLO
constexpr int kRadius = 15;           // PATCH_RADIUS: the moments' circle
constexpr int kWin = kPatch + 4;      // the blur's window: 2 more pixels a side
constexpr int kBits = 256;
constexpr int kAngleBins = 30;

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

// ---------------------------------------------------------------------------
// K7: gray conversion and one pyramid level
// ---------------------------------------------------------------------------

// rgba [pixels, channels] (channels 3 or 4) → out [pixels]: the plain
// version's ((r 0.299 + g 0.587) + b 0.114) on float32 values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gray_kernel(const T* rgba, int channels, long long pixels, float* out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pixels) return;
  const T* p = rgba + i * channels;
  out[i] = static_cast<float>(p[0]) * kGrayR + static_cast<float>(p[1]) * kGrayG +
           static_cast<float>(p[2]) * kGrayB;
}

// img [B, H, W] → out [B, Ho, Wo], Ho = ceil(H / 2): the binomial blur at
// the even rows and columns (rows first, then columns, edge-clamped).
__global__ void __launch_bounds__(kThreads)
    pyr_down_kernel(const float* img, int H, int W, int Ho, int Wo, long long outputs,
                    float* out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= outputs) return;
  const long long b = i / (static_cast<long long>(Ho) * Wo);
  const int rem = static_cast<int>(i - b * Ho * Wo);
  const int r = 2 * (rem / Wo), c = 2 * (rem % Wo);
  const float* im = img + b * H * W;
  int rows[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) rows[d] = clampi(r + d - 2, 0, H - 1) * W;
  float x[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const int col = clampi(c + d - 2, 0, W - 1);
    x[d] = tap5(im[rows[0] + col], im[rows[1] + col], im[rows[2] + col], im[rows[3] + col],
                im[rows[4] + col], kBin0, kBin1, kBin2);
  }
  out[i] = tap5(x[0], x[1], x[2], x[3], x[4], kBin0, kBin1, kBin2);
}

// ---------------------------------------------------------------------------
// K5: grid Shi-Tomasi detection
// ---------------------------------------------------------------------------

// img [S, H, W] → g [S, H, W]: `gaussian_blur3`, [0.25, 0.5, 0.25] rows
// first, then columns.
__global__ void __launch_bounds__(kThreads)
    detect_blur_kernel(const float* img, int H, int W, long long pixels, float* g) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pixels) return;
  const long long s = i / (static_cast<long long>(H) * W);
  const int rem = static_cast<int>(i - s * H * W);
  const int r = rem / W, c = rem % W;
  const float* im = img + s * H * W;
  const int r0 = clampi(r - 1, 0, H - 1) * W, r1 = r * W, r2 = clampi(r + 1, 0, H - 1) * W;
  const int cols[3] = {clampi(c - 1, 0, W - 1), c, clampi(c + 1, 0, W - 1)};
  float x[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    x[d] = tap3(im[r0 + cols[d]], im[r1 + cols[d]], im[r2 + cols[d]], 0.25f, 0.5f);
  g[i] = tap3(x[0], x[1], x[2], 0.25f, 0.5f);
}

// `sobel_gradients` of g at (y, x): the central difference first, then
// the [1, 2, 1] smoothing across it, each index clamped to the image.
__device__ __forceinline__ void sobel(const float* g, int H, int W, int y, int x, float& dx,
                                      float& dy) {
  const int ym = clampi(y - 1, 0, H - 1) * W, y0 = y * W, yp = clampi(y + 1, 0, H - 1) * W;
  const int xm = clampi(x - 1, 0, W - 1), xp = clampi(x + 1, 0, W - 1);
  const float d0 = g[ym + xp] - g[ym + xm], d1 = g[y0 + xp] - g[y0 + xm];
  const float d2 = g[yp + xp] - g[yp + xm];
  dx = (d0 + 2.0f * d1) + d2;
  const float e0 = g[yp + xm] - g[ym + xm], e1 = g[yp + x] - g[ym + x];
  const float e2 = g[yp + xp] - g[ym + xp];
  dy = (e0 + 2.0f * e1) + e2;
}

// `_sep_conv(p, [1/3] * 3)` at the centre of p[row][col], the 3 x 3
// neighbourhood at clamped indices: rows first, then columns.
__device__ __forceinline__ float box3(const float (&p)[3][3]) {
  float x[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) x[b] = tap3(p[0][b], p[1][b], p[2][b], kThird, kThird);
  return tap3(x[0], x[1], x[2], kThird, kThird);
}

// `shi_tomasi_response` at (r, c) from the blurred image g.
__device__ float response(const float* g, int H, int W, int r, int c) {
  const int ys[3] = {clampi(r - 1, 0, H - 1), r, clampi(r + 1, 0, H - 1)};
  const int xs[3] = {clampi(c - 1, 0, W - 1), c, clampi(c + 1, 0, W - 1)};
  float pxx[3][3], pyy[3][3], pxy[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float dx, dy;
      sobel(g, H, W, ys[a], xs[b], dx, dy);
      pxx[a][b] = dx * dx;
      pyy[a][b] = dy * dy;
      pxy[a][b] = dx * dy;
    }
  }
  const float sxx = box3(pxx), syy = box3(pyy), sxy = box3(pxy);
  const float half_trace = 0.5f * (sxx + syy);
  const float t = (sxx - syy) * 0.5f;
  const float disc = sqrtf(t * t + sxy * sxy);
  return (half_trace - disc) * kCvNorm;
}

// torch.argmax's order: NaN above every number, ties to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (bv != bv) return v != v && i < bi;
  if (v != v) return true;
  return v > bv || (v == bv && i < bi);
}

// The block's argmax of (v, i): every thread gets it.  `sv` and `si`
// hold kWarps entries.
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
  v = sv[0];
  i = si[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(sv[w], si[w], v, i)) {
      v = sv[w];
      i = si[w];
    }
  __syncthreads();
}

// Block (cell, s): the response of the cell's pixels into resp [S, H, W],
// then `grid_argmax2`'s best peak over the cell x cell tile (-inf past the
// image) and its second peak outside the disc of radius cell / 4 around
// the best: their scores to the first 2C floats of the row's scratch
// (best at cid, second at C + cid), their tile indices to its first 2C
// ints.
__global__ void __launch_bounds__(kThreads)
    detect_cells_kernel(const float* g, int H, int W, int cell, int gw, int C, float* resp,
                        float* score, int* peak) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const long long s = blockIdx.y;
  const int cid = blockIdx.x;
  const int y0 = (cid / gw) * cell, x0 = (cid % gw) * cell;
  const int n = cell * cell;
  const float* gs = g + s * H * W;
  float* rs = resp + s * H * W;

  float v1 = neg_inf();
  int i1 = n;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int y = y0 + idx / cell, x = x0 + idx % cell;
    float v = neg_inf();
    if (y < H && x < W) {
      v = response(gs, H, W, y, x);
      rs[y * W + x] = v;
    }
    if (better(v, idx, v1, i1)) {
      v1 = v;
      i1 = idx;
    }
  }
  block_argmax(v1, i1, sv, si);       // its barriers also publish the responses written

  const int iy = i1 / cell, ix = i1 % cell, r = cell / 4;
  float v2 = neg_inf();
  int i2 = n;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int dy = idx / cell, dx = idx % cell;
    const int y = y0 + dy, x = x0 + dx;
    const long long d2 = static_cast<long long>(dy - iy) * (dy - iy) +
                         static_cast<long long>(dx - ix) * (dx - ix);
    const float v = d2 <= static_cast<long long>(r) * r || y >= H || x >= W ? neg_inf()
                                                                           : rs[y * W + x];
    if (better(v, idx, v2, i2)) {
      v2 = v;
      i2 = idx;
    }
  }
  block_argmax(v2, i2, sv, si);
  if (threadIdx.x == 0) {
    float* sc = score + s * kScratchF * C;
    int* pk = peak + s * kScratchI * C;
    sc[cid] = v1;
    sc[C + cid] = v2;
    pk[cid] = i1;
    pk[C + cid] = i2;
  }
}

// Sums of kN ints over the block, into tot (shared, kN), every thread's
// `v` its share; `part` holds kSelectWarps * kN ints.
template <int kN>
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
    for (int w = 0; w < kSelectWarps; ++w) t += part[w * kN + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// Block s: the rest of `detect_grid` on row s, from the responses and the
// cells' peaks.  wsf [S, kScratchF C] (the peaks' scores as the cell
// kernel left them; x, y after the subpixel fit; priorities) and wsi [S,
// kScratchI C] (the peaks' tile indices; the occupied cells; the
// candidates passing the gates) are the launch's scratch.  Writes xy [S,
// C, 2], score [S, C], valid [S, C] and new_quality [S].
__global__ void __launch_bounds__(kSelectThreads)
    detect_select_kernel(const float* resp, const float* ex_xy, const bool* ex_valid,
                         const float* quality, float quality_value, int H, int W, int K,
                         int cell, int border, int gw, int C, float* wsf, int* wsi, float* xy,
                         float* score_out, bool* valid_out, float* new_quality) {
  __shared__ int part[kSelectWarps * (1 + 2 * kRungs)];
  __shared__ int tot[1 + 2 * kRungs];
  const long long s = blockIdx.x;
  const int C2 = 2 * C;
  float* score = wsf + s * kScratchF * C;
  float* cx = score + C2;
  float* cy = cx + C2;
  float* prio = cy + C2;
  const int* peak = wsi + s * kScratchI * C;
  int* occ = wsi + s * kScratchI * C + C2;
  int* ok = occ + C;
  const float* rs = resp + s * H * W;
  const float* ex = ex_xy + s * K * 2;
  const bool* exv = ex_valid + s * K;
  const float q0 = quality != nullptr ? quality[s] : quality_value;

  // the cells holding a live keypoint
  for (int c = threadIdx.x; c < C; c += kSelectThreads) occ[c] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kSelectThreads) {
    if (!exv[k]) continue;
    const long long kx = clampll(static_cast<long long>(ex[2 * k]), 0, W - 1);
    const long long ky = clampll(static_cast<long long>(ex[2 * k + 1]), 0, H - 1);
    occ[(ky / cell) * gw + kx / cell] = 1;   // every writer writes 1
  }
  __syncthreads();

  // each candidate's subpixel fit and gates; the counts per rung
  const double q4 = cell / 4.0;
  const float near2 = static_cast<float>(q4 * q4);
  float ladder[kRungs];
  for (int r = 0; r < kRungs; ++r) ladder[r] = q0 * static_cast<float>(1.0 / (1 << r));
  int counts[1 + 2 * kRungs] = {};
  for (int c = threadIdx.x; c < C; c += kSelectThreads) counts[0] += occ[c];
  for (int j = threadIdx.x; j < C2; j += kSelectThreads) {
    const int cid = j < C ? j : j - C;
    const int t = peak[j];
    const int xi = (cid % gw) * cell + t % cell, yi = (cid / gw) * cell + t / cell;
    const int x = clampi(xi, 1, W - 2), y = clampi(yi, 1, H - 2);
    const float* at = rs + y * W + x;      // at[dy * W + dx]: the 3 x 3 neighbourhood
    const float c0 = at[0];
    const float dxx = (at[1] + at[-1]) - 2.0f * c0;
    const float dyy = (at[W] + at[-W]) - 2.0f * c0;
    const float dxy = 0.25f * (((at[W + 1] - at[W - 1]) - at[-W + 1]) + at[-W - 1]);
    const float gx = 0.5f * (at[1] - at[-1]);
    const float gy = 0.5f * (at[W] - at[-W]);
    float det = dxx * dyy - dxy * dxy;
    det = fabsf(det) < kDetFloor ? kDetFloor : det;
    float ox = -(dyy * gx - dxy * gy) / det;
    float oy = -(dxx * gy - dxy * gx) / det;
    const bool good = fabsf(ox) <= 1.0f && fabsf(oy) <= 1.0f;
    ox = good ? ox : 0.0f;
    oy = good ? oy : 0.0f;
    const float px = static_cast<float>(x) + ox, py = static_cast<float>(y) + oy;
    cx[j] = px;
    cy[j] = py;
    bool close = false;
    for (int k = 0; k < K && !close; ++k) {
      const float ddx = px - ex[2 * k], ddy = py - ex[2 * k + 1];
      close = exv[k] && ddx * ddx + ddy * ddy < near2;
    }
    const float sc = score[j];
    const bool in_border = px >= static_cast<float>(border) &&
                           px < static_cast<float>(W - border) &&
                           py >= static_cast<float>(border) && py < static_cast<float>(H - border);
    const bool base = in_border && !occ[cid] && !close && fabsf(sc) < INFINITY;
    ok[j] = base;
    int* n = counts + 1 + (j < C ? 0 : kRungs);     // first peaks' counts, then second ones'
    for (int r = 0; r < kRungs; ++r) n[r] += base && sc >= ladder[r];
  }
  block_sums(counts, part, tot);

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
  if (threadIdx.x == 0) {
    const float factor = n_eff[kRungs - 1] < kStarve * empty ? 0.5f
                         : n_eff[0] > kFill * empty          ? 1.5f
                                                             : 1.0f;
    const float q = q0 * factor;
    new_quality[s] = q < kQualityMin ? kQualityMin : q > 1.0f ? 1.0f : q;
  }

  // priorities: first peaks before second ones, then by score
  const float thresh = ladder[rung];
  for (int j = threadIdx.x; j < C2; j += kSelectThreads) {
    const float sc = score[j];
    const bool v = ok[j] && sc >= thresh;
    ok[j] = v;
    const float clipped = sc < 0.0f ? 0.0f : sc > 999.0f ? 999.0f : sc;
    prio[j] = v ? (j < C ? 1000.0f : 0.0f) + clipped : neg_inf();
  }
  __syncthreads();

  // ops/topk.py's stable descending sort: the first C ranks are written
  for (int j = threadIdx.x; j < C2; j += kSelectThreads) {
    const float p = prio[j];
    int rank = 0;
    for (int i = 0; i < C2; ++i) {
      const float q = prio[i];
      rank += q > p || (q == p && i < j);
    }
    if (rank >= C) continue;
    const long long o = s * C + rank;
    xy[2 * o] = cx[j];
    xy[2 * o + 1] = cy[j];
    score_out[o] = ok[j] ? score[j] : 0.0f;
    valid_out[o] = ok[j] != 0;
  }
}

// ---------------------------------------------------------------------------
// K3: ORB describe
// ---------------------------------------------------------------------------

// Block (n, s): keypoint n of row s.  img [S, H, W], xy [S, N, 2], valid
// [S, N], taps [30, 256, 2] (flat in-patch indices of each bin's steered
// pairs) → desc [S, N, 8] (zeros where invalid), angle [S, N].
__global__ void __launch_bounds__(kThreads)
    describe_kernel(const float* img, int H, int W, const float* xy, const bool* valid,
                    const int* taps, int N, int blur, unsigned* desc, float* angle) {
  __shared__ float win[kWin * kWin];
  __shared__ float rows[kPatch * kWin];
  __shared__ float patch[kPatch * kPatch];
  __shared__ double part[2][kWarps];
  __shared__ int s_bin;
  const long long s = blockIdx.y;
  const long long n = s * N + blockIdx.x;
  const float* im = img + s * H * W;
  // `_patch_centers`: the rounded keypoint, clamped so the patch stays inside
  const long long px = static_cast<long long>(floorf(xy[2 * n] + 0.5f));
  const long long py = static_cast<long long>(floorf(xy[2 * n + 1] + 0.5f));
  const int cx = static_cast<int>(clampll(px, kPatchLo, W - (kPatch - kPatchLo)));
  const int cy = static_cast<int>(clampll(py, kPatchLo, H - (kPatch - kPatchLo)));
  for (int i = threadIdx.x; i < kWin * kWin; i += kThreads) {
    const int y = clampi(cy - kPatchLo - 2 + i / kWin, 0, H - 1);
    const int x = clampi(cx - kPatchLo - 2 + i % kWin, 0, W - 1);
    win[i] = im[y * W + x];
  }
  __syncthreads();
  if (blur) {      // `_sep_conv(img, [0.2] * 5)`, clamped at the image's edges
    for (int i = threadIdx.x; i < kPatch * kWin; i += kThreads) {
      const float* w = win + i;             // window row i / kWin is patch row i / kWin - 2
      rows[i] = tap5(w[0], w[kWin], w[2 * kWin], w[3 * kWin], w[4 * kWin], kFifth, kFifth,
                     kFifth);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPatch * kPatch; i += kThreads) {
      const float* w = rows + (i / kPatch) * kWin + i % kPatch;
      patch[i] = tap5(w[0], w[1], w[2], w[3], w[4], kFifth, kFifth, kFifth);
    }
  } else {
    for (int i = threadIdx.x; i < kPatch * kPatch; i += kThreads)
      patch[i] = win[(i / kPatch + 2) * kWin + i % kPatch + 2];
  }
  __syncthreads();

  // `_moment_angle`: each term the plain version's float32 product, summed in float64
  double m10 = 0.0, m01 = 0.0;
  constexpr int kSide = 2 * kRadius + 1;
  for (int i = threadIdx.x; i < kSide * kSide; i += kThreads) {
    const int oy = i / kSide - kRadius, ox = i % kSide - kRadius;
    if (ox * ox + oy * oy > kRadius * kRadius) continue;
    const float v = patch[(oy + kPatchLo) * kPatch + ox + kPatchLo];
    m10 += static_cast<double>(v * static_cast<float>(ox));
    m01 += static_cast<double>(v * static_cast<float>(oy));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    m10 += __shfl_xor_sync(0xFFFFFFFFu, m10, m);
    m01 += __shfl_xor_sync(0xFFFFFFFFu, m01, m);
  }
  if (threadIdx.x % 32 == 0) {
    part[0][threadIdx.x / 32] = m10;
    part[1][threadIdx.x / 32] = m01;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += part[0][w];
      b += part[1][w];
    }
    const float ang = atan2f(static_cast<float>(b), static_cast<float>(a));
    // torch.remainder(angle, 2 pi), then the card's division by a Python
    // float (a product with its float32 reciprocal), the bin rounded
    float rem = fmodf(ang, kTwoPi);
    if (rem < 0.0f) rem += kTwoPi;
    const float f = floorf(rem * (1.0f / kTwoPi) * static_cast<float>(kAngleBins) + 0.5f);
    const long long bin = static_cast<long long>(f) % kAngleBins;
    s_bin = static_cast<int>(bin < 0 ? bin + kAngleBins : bin);
    angle[n] = ang;
  }
  __syncthreads();

  // 256 steered compares of bf16-rounded pixels, bit b of word k from thread 32 k + b
  const int* tap = taps + (s_bin * kBits + threadIdx.x) * 2;
  const float v0 = __bfloat162float(__float2bfloat16_rn(patch[tap[0]]));
  const float v1 = __bfloat162float(__float2bfloat16_rn(patch[tap[1]]));
  const unsigned word = __ballot_sync(0xFFFFFFFFu, v1 - v0 > 0.0f);
  if (threadIdx.x % 32 == 0) desc[n * 8 + threadIdx.x / 32] = valid[n] ? word : 0u;
}

unsigned blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// out [pixels] float32 from rgba [pixels, channels] (channels 3 or 4; u8
// when `is_float` is 0, float32 otherwise) on `stream`.
extern "C" int image_gray_launch(const void* rgba, int is_float, int channels, long long pixels,
                                 void* out, void* stream) {
  if (channels < 3 || channels > 4 || pixels < 0 || pixels > (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_float) {
    const auto kernel = gray_kernel<float>;
    kernel<<<blocks(pixels, kThreads), kThreads, 0, st>>>(static_cast<const float*>(rgba),
                                                           channels, pixels,
                                                           static_cast<float*>(out));
  } else {
    const auto kernel = gray_kernel<unsigned char>;
    kernel<<<blocks(pixels, kThreads), kThreads, 0, st>>>(
        static_cast<const unsigned char*>(rgba), channels, pixels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// out [B, ceil(H / 2), ceil(W / 2)] from img [B, H, W] float32 on `stream`.
extern "C" int image_pyr_down_launch(const void* img, int B, int H, int W, void* out,
                                     void* stream) {
  if (B < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long outputs = static_cast<long long>(B) * Ho * Wo;
  if (outputs == 0) return 0;
  pyr_down_kernel<<<blocks(outputs, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, Ho, Wo, outputs, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `detect_grid` on S rows in three launches: img [S, H, W] float32,
// ex_xy [S, K, 2] float32, ex_valid [S, K] bool, quality [S] float32 or
// null (then `quality_value` for every row); g and resp [S, H, W] float32,
// wsf [S, kScratchF C] float32 and wsi [S, kScratchI C] int32 are scratch
// (resp keeps the response); xy [S, C, 2] float32, score [S, C] float32, valid [S, C]
// bool, new_quality [S] float32, with C = ceil(H / cell) ceil(W / cell).
extern "C" int detect_grid_launch(const void* img, const void* ex_xy, const void* ex_valid,
                                  const void* quality, float quality_value, int S, int H, int W,
                                  int K, int cell, int border, void* g, void* resp, void* wsf,
                                  void* wsi, void* xy, void* score, void* valid,
                                  void* new_quality, void* stream) {
  if (S < 1 || S > kMaxRows || H < 3 || W < 3 || K < 0 || cell < 1 || cell > 46340)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gh = (H + cell - 1) / cell, gw = (W + cell - 1) / cell;
  const long long C = static_cast<long long>(gh) * gw;
  if (C > (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long pixels = static_cast<long long>(S) * H * W;
  detect_blur_kernel<<<blocks(pixels, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(img), H, W, pixels, static_cast<float*>(g));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* f = static_cast<float*>(wsf);
  int* n = static_cast<int*>(wsi);
  detect_cells_kernel<<<dim3(static_cast<unsigned>(C), S), kThreads, 0, st>>>(
      static_cast<const float*>(g), H, W, cell, gw, static_cast<int>(C),
      static_cast<float*>(resp), f, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  detect_select_kernel<<<S, kSelectThreads, 0, st>>>(
      static_cast<const float*>(resp), static_cast<const float*>(ex_xy),
      static_cast<const bool*>(ex_valid), static_cast<const float*>(quality), quality_value, H,
      W, K, cell, border, gw, static_cast<int>(C), f, n, static_cast<float*>(xy),
      static_cast<float*>(score), static_cast<bool*>(valid), static_cast<float*>(new_quality));
  return static_cast<int>(cudaGetLastError());
}

// `describe` on S rows of N keypoints: img [S, H, W] float32 (H, W >= 36),
// xy [S, N, 2] float32, valid [S, N] bool, taps [30, 256, 2] int32 → desc
// [S, N, 8] int32, angle [S, N] float32, on `stream`.
extern "C" int describe_launch(const void* img, const void* xy, const void* valid,
                               const void* taps, int S, int H, int W, int N, int blur,
                               void* desc, void* angle, void* stream) {
  if (S < 1 || S > kMaxRows || H < kPatch || W < kPatch || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  describe_kernel<<<dim3(N, S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(xy),
      static_cast<const bool*>(valid), static_cast<const int*>(taps), N, blur,
      static_cast<unsigned*>(desc), static_cast<float*>(angle));
  return static_cast<int>(cudaGetLastError());
}

// The limits the wrappers check before a launch, and K5's scratch per row
// in units of C that they allocate (ops/image_kernels.py).
extern "C" int image_kernel_limits(int* max_rows, int* patch, int* bits, int* angle_bins,
                                   int* scratch_f, int* scratch_i) {
  *max_rows = kMaxRows;
  *patch = kPatch;
  *bits = kBits;
  *angle_bins = kAngleBins;
  *scratch_f = kScratchF;
  *scratch_i = kScratchI;
  return 0;
}
