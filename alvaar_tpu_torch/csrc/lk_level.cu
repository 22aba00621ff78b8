// One KLT pyramid-level pass (correlation-volume Lucas-Kanade) for Hopper.
//
// Replaces the TPU kernel alvaar_tpu/ops/pallas/lk_kernel.py
// (`_kernel`, launched by `lk_level_pallas`), together with the patch
// extraction the JAX package runs in front of it (ops/klt.py `_lk_level`,
// ops/image.py `extract_patches_pl`).  It computes what `_lk_level`
// computes: from one pyramid level of the previous and current image,
// the previous points, the initial guesses and a validity mask, it returns
// the tracked positions, a status and the window L1 error.
//
// Per point:
//   1. template: a (win+3)^2 patch of img_prev at the clipped integer
//      base, the bilinear fractional blend, central-difference gradients,
//      the 2x2 structure tensor and its min-eigenvalue trackability gate;
//   2. a (2R+win)^2 search patch of img_cur at the clipped rounded guess;
//   3. correlation volumes Cx, Cy over all (2R+1)^2 integer shifts;
//   4. `iters` Gauss-Newton steps, each a tent-weight (bilinear) read of the
//      volumes, with the eps freeze and the clip to +-(R - 1.001);
//   5. the final window L1 error by tent reads of the search patch, and
//      the at_edge / started_edge / in-border status rules.
//
// What bounds it on this card: on the main path N <= 192 points per call
// (one block each, about 1.5 blocks per SM), and each point's work is a
// short serial chain (patch loads, an 81-tap correlation, 12-16 dependent
// GN steps).  Bytes (< 4 KB per point) and FLOPs (< 60 k per point) are
// tiny against the card's bandwidth and rate, so the call is latency and
// launch bound.  The design keeps every intermediate in shared memory
// (nothing goes back to device memory but the three outputs), fuses the
// patch gathers into the kernel, and spends the block's threads on the
// parallel parts (patch loads, the blend, one volume entry per thread).
// The serial parts (the 81-term sums and the GN loop) run on one thread in
// the same order as the plain twin in ops/lk_level.py, so that with
// `--fmad=false` the two agree bit for bit; making those parallel is work
// for a later, measured change.
//
// Plain C entry point, built with nvcc into a shared library and loaded
// with ctypes (ops/lk_level.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWinMax = 15;
constexpr int kRMax = 12;
constexpr int kTplMax = kWinMax + 3;
constexpr int kBlendMax = kWinMax + 2;
constexpr int kCrMax = 2 * kRMax + 1;
constexpr int kSMax = 2 * kRMax + kWinMax;
constexpr int kThreads = 256;

__device__ __forceinline__ float tent(int i, float d) {
  return fmaxf(0.0f, 1.0f - fabsf(static_cast<float>(i) - d));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) lk_level_kernel(
    const float* __restrict__ img_prev, const float* __restrict__ img_cur,
    int H, int W, const float* __restrict__ pts_prev,
    const float* __restrict__ guess, const bool* __restrict__ valid, int N,
    int win, int R, int iters, float eps_sq, float min_eig,
    float* __restrict__ xy_out, bool* __restrict__ ok_out,
    float* __restrict__ err_out) {
  __shared__ float tp[kTplMax * kTplMax];
  __shared__ float t11[kBlendMax * kBlendMax];
  __shared__ float T[kWinMax * kWinMax];
  __shared__ float gx[kWinMax * kWinMax];
  __shared__ float gy[kWinMax * kWinMax];
  __shared__ float Jp[kSMax * kSMax];
  __shared__ float Cx[kCrMax * kCrMax];
  __shared__ float Cy[kCrMax * kCrMax];
  __shared__ float absres[kWinMax * kWinMax];
  __shared__ float s_dx, s_dy;
  __shared__ bool s_trackable;

  const int n = blockIdx.x;
  if (n >= N) return;  // the grid is exactly N blocks; guard the edge anyway
  const int tid = threadIdx.x;

  const int r = win / 2;
  const int tpl = win + 3;
  const int blend = win + 2;
  const int cr = 2 * R + 1;
  const int S = cr + win - 1;
  const int margin = R + r + 1;
  const float Rf = static_cast<float>(R);
  const float lim = static_cast<float>(static_cast<double>(R) - 1.001);
  const float edge = static_cast<float>(static_cast<double>(R) - 1.001 - 1e-3);

  // ---- integer bases (the JAX package's clip rules) ----
  const float px = pts_prev[2 * n], py = pts_prev[2 * n + 1];
  const int btx = clampi(static_cast<int>(floorf(px)), r + 2, W - r - 4);
  const int bty = clampi(static_cast<int>(floorf(py)), r + 2, H - r - 4);
  const float ftx = clampf(px - static_cast<float>(btx), 0.0f, 1.0f);
  const float fty = clampf(py - static_cast<float>(bty), 0.0f, 1.0f);

  const float gux = guess[2 * n], guy = guess[2 * n + 1];
  const int bjx = clampi(static_cast<int>(floorf(gux + 0.5f)), margin, W - margin - 1);
  const int bjy = clampi(static_cast<int>(floorf(guy + 0.5f)), margin, H - margin - 1);
  const float dx0 = clampf(gux - static_cast<float>(bjx), -lim, lim);
  const float dy0 = clampf(guy - static_cast<float>(bjy), -lim, lim);

  // ---- patch gathers straight from the level images ----
  for (int i = tid; i < tpl * tpl; i += blockDim.x) {
    const int p = i / tpl, q = i % tpl;
    tp[i] = img_prev[(bty + p - (r + 1)) * W + (btx + q - (r + 1))];
  }
  for (int i = tid; i < S * S; i += blockDim.x) {
    const int p = i / S, q = i % S;
    Jp[i] = img_cur[(bjy + p - (margin - 1)) * W + (bjx + q - (margin - 1))];
  }
  __syncthreads();

  // ---- template blend: t11[p, q] = tp[p + fty, q + ftx] ----
  for (int i = tid; i < blend * blend; i += blockDim.x) {
    const int p = i / blend, q = i % blend;
    const float* row0 = tp + p * tpl + q;
    const float* row1 = row0 + tpl;
    t11[i] = row0[0] * (1.0f - fty) * (1.0f - ftx) + row0[1] * (1.0f - fty) * ftx
             + row1[0] * fty * (1.0f - ftx) + row1[1] * fty * ftx;
  }
  __syncthreads();

  for (int i = tid; i < win * win; i += blockDim.x) {
    const int p = i / win, q = i % win;
    T[i] = t11[(p + 1) * blend + q + 1];
    gx[i] = 0.5f * (t11[(p + 1) * blend + q + 2] - t11[(p + 1) * blend + q]);
    gy[i] = 0.5f * (t11[(p + 2) * blend + q + 1] - t11[p * blend + q + 1]);
  }
  __syncthreads();

  // ---- correlation volumes: one entry per thread, taps in row order ----
  for (int i = tid; i < cr * cr; i += blockDim.x) {
    const int p = i / cr, q = i % cr;
    float ax = 0.0f, ay = 0.0f;
    for (int wy = 0; wy < win; ++wy) {
      for (int wx = 0; wx < win; ++wx) {
        const float js = Jp[(p + wy) * S + q + wx];
        ax = ax + js * gx[wy * win + wx];
        ay = ay + js * gy[wy * win + wx];
      }
    }
    Cx[i] = ax;
    Cy[i] = ay;
  }
  __syncthreads();

  // ---- structure tensor + Gauss-Newton on the volumes (serial) ----
  if (tid == 0) {
    const int nw = win * win;
    float gxx = gx[0] * gx[0], gxy = gx[0] * gy[0], gyy = gy[0] * gy[0];
    float c0x = T[0] * gx[0], c0y = T[0] * gy[0];
    for (int i = 1; i < nw; ++i) {
      gxx = gxx + gx[i] * gx[i];
      gxy = gxy + gx[i] * gy[i];
      gyy = gyy + gy[i] * gy[i];
      c0x = c0x + T[i] * gx[i];
      c0y = c0y + T[i] * gy[i];
    }
    const float det = gxx * gyy - gxy * gxy;
    const float trc = gxx + gyy;
    const float eig_min = 0.5f * (trc - sqrtf(fmaxf(trc * trc - 4.0f * det, 0.0f)));
    const bool trackable = eig_min / static_cast<float>(nw) > min_eig;
    const float det_safe = fabsf(det) < 1e-9f ? 1e-9f : det;
    const float i00 = gyy / det_safe;
    const float i01 = -gxy / det_safe;
    const float i11 = gxx / det_safe;

    bool frozen = !(valid[n] && trackable);
    float dx = dx0, dy = dy0;
    for (int it = 0; it < iters; ++it) {
      const float ey = dy + Rf, ex = dx + Rf;
      const int iy = static_cast<int>(floorf(ey));
      const int ix = static_cast<int>(floorf(ex));
      const float wy0 = tent(iy, ey), wy1 = tent(iy + 1, ey);
      const float wx0 = tent(ix, ex), wx1 = tent(ix + 1, ex);
      const int a = iy * cr + ix, b = a + cr;
      const float tx0 = wy0 * Cx[a] + wy1 * Cx[b];
      const float tx1 = wy0 * Cx[a + 1] + wy1 * Cx[b + 1];
      const float ty0 = wy0 * Cy[a] + wy1 * Cy[b];
      const float ty1 = wy0 * Cy[a + 1] + wy1 * Cy[b + 1];
      const float bx = (tx0 * wx0 + tx1 * wx1) - c0x;
      const float by = (ty0 * wx0 + ty1 * wx1) - c0y;
      float sx = -(i00 * bx + i01 * by);
      float sy = -(i01 * bx + i11 * by);
      if (frozen) {
        sx = 0.0f;
        sy = 0.0f;
      }
      dx = clampf(dx + sx, -lim, lim);
      dy = clampf(dy + sy, -lim, lim);
      frozen = frozen || (sx * sx + sy * sy < eps_sq);
    }
    s_dx = dx;
    s_dy = dy;
    s_trackable = trackable;
  }
  __syncthreads();

  // ---- final window L1 error: tent reads of the search patch ----
  const float dx = s_dx, dy = s_dy;
  for (int i = tid; i < win * win; i += blockDim.x) {
    const int ri = i / win, ci = i % win;
    const float ey = (dy + Rf) + static_cast<float>(ri);
    const float ex = (dx + Rf) + static_cast<float>(ci);
    const int iy = static_cast<int>(floorf(ey));
    const int ix = static_cast<int>(floorf(ex));
    const float wy0 = tent(iy, ey), wy1 = tent(iy + 1, ey);
    const float wx0 = tent(ix, ex), wx1 = tent(ix + 1, ex);
    const float* p0 = Jp + iy * S + ix;
    const float* p1 = p0 + S;
    const float t0 = p0[0] * wy0 + p1[0] * wy1;
    const float t1 = p0[1] * wy0 + p1[1] * wy1;
    const float v = t0 * wx0 + t1 * wx1;
    absres[i] = fabsf(v - T[i]);
  }
  __syncthreads();

  if (tid == 0) {
    float acc = absres[0];
    for (int i = 1; i < win * win; ++i) acc = acc + absres[i];
    const float err = acc / static_cast<float>(win * win);

    const float x = static_cast<float>(bjx) + dx;
    const float y = static_cast<float>(bjy) + dy;
    const float rb = static_cast<float>(r + 1);
    const bool inb = (x >= rb) && (x < static_cast<float>(W) - rb)
                     && (y >= rb) && (y < static_cast<float>(H) - rb);
    const bool at_edge = (fabsf(dx) >= edge) || (fabsf(dy) >= edge);
    const bool started_edge = (fabsf(dx0) >= edge) || (fabsf(dy0) >= edge);
    const bool trackable = s_trackable;
    xy_out[2 * n] = x;
    xy_out[2 * n + 1] = y;
    err_out[n] = err;
    ok_out[n] = valid[n] && trackable && inb && (!at_edge || started_edge);
  }
}

}  // namespace

extern "C" int lk_level_launch(const float* img_prev, const float* img_cur,
                               int H, int W, const float* pts_prev,
                               const float* guess, const bool* valid, int N,
                               int win, int R, int iters, float eps_sq,
                               float min_eig, float* xy_out, bool* ok_out,
                               float* err_out, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  lk_level_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img_prev, img_cur, H, W, pts_prev, guess, valid, N, win, R, iters,
      eps_sq, min_eig, xy_out, ok_out, err_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lk_level_limits(int* win_max, int* r_max) {
  *win_max = kWinMax;
  *r_max = kRMax;
  return 0;
}
