// Forward-backward pyramidal KLT for Hopper: one launch per `fb_klt_track`
// call.
//
// Replaces the TPU kernel alvaar_tpu/ops/pallas/lk_kernel.py (`_kernel`,
// launched once per pyramid level by `lk_level_pallas`), together with what
// the JAX package runs around it: the patch extraction (ops/image.py
// `extract_patches_pl`) and the pyramid and round-trip glue of ops/klt.py
// (`klt_pyramidal`, `fb_klt_track`).  For each point the kernel runs a
// schedule of level passes and computes what that composition computes:
//
//   * forward passes from the coarsest level down to level 0: the points
//     scaled by 2^-l, the guess doubled between levels, the same `valid`
//     at every level, ok &= ok_level, then status = ok & (err <= err_max);
//   * then, if scheduled, the backward pass at level 0 (images swapped)
//     from the forward result with valid = the forward status, and the
//     round-trip gate |backward - start| <= fb_dist.
//   With `gated` = 0 the schedule is one forward pass whose status is the
//   level's own ok (ops/lk_level.py `lk_level`).
//
// One level pass (the correlation-volume Lucas-Kanade of the JAX package):
//   1. template: a (win+3)^2 patch of the previous image at the clipped
//      integer base, the bilinear fractional blend, central-difference
//      gradients, the 2x2 structure tensor and its min-eigenvalue gate;
//   2. a (2R+win)^2 search patch of the current image at the clipped
//      rounded guess;
//   3. correlation volumes Cx, Cy over all (2R+1)^2 integer shifts;
//   4. `iters` Gauss-Newton steps, each a tent-weight (bilinear) read of the
//      volumes, with the eps freeze and the clip to +-(R - 1.001);
//   5. the window L1 error by tent reads of the search patch, and the
//      at_edge / started_edge / in-border rules.
//
// What bounds it on this card.  A call needs a few hundred KB and
// 7-33 MFLOP (main path, N = 192), a bound well under a microsecond; what
// takes the time is each point's dependent chain: patch loads, the volume
// sums, up to 12-16 Gauss-Newton steps, per pass, 2-4 passes in a row, and
// the call lasts as long as its slowest point.  So:
//   * 128 threads (four warps) per point, one point per block: of 32, 64
//     and 128 threads per point, 128 was fastest at both main-path calls
//     (N = 192; PERF.md), the R = 8 volumes having 85 four-entry blocks to
//     spread over the lanes; the block's barrier is the point's own;
//   * per-point scratch in dynamic shared memory sized at launch from
//     (win, the largest R of the schedule, the number of passes);
//   * every forward template depends on the points alone, so all of them
//     and the first search patch are requested with cp.async at the start;
//     a finer level's search patch depends on the pass before it, so it is
//     requested as soon as that pass's Gauss-Newton steps end, into the
//     second of two buffers, and lands during that pass's error and the
//     next pass's template work;
//   * the volume entries are spread over the point's lanes, four
//     neighbouring entries of a row per lane, read as 16-byte row segments
//     so that shared-memory traffic stays below the arithmetic; an invalid
//     point skips them; the five structure-tensor sums run on five lanes
//     at once; every lane runs the Gauss-Newton steps and the error sum on
//     the same shared-memory values, so the per-point scalars stay in
//     registers and need no broadcast, and the steps end when the point
//     freezes (its later steps are zero).
// No TMA: the gathers are a few rows of 12-33 floats (under 3 KB a point)
// at bases that depend on the data, where the copy engine's tiles buy
// nothing.  No tensor cores: the status gates are exact float32
// comparisons that TF32 would break, and a point does only 26-94 k FLOP.
//
// Numerics: the plain version (ops/klt.py over ops/lk_level.py
// `lk_level_plain`) takes every product and sum as its own float32 op, in
// the order used here (the 81-term sums strictly left to right, the volumes
// tap by tap); this file is built with --fmad=false, and the power-of-two
// scalings are exact, so kernel and plain version agree bit for bit.
//
// Streams: one launch serves B streams (multi-stream serving).  Point n
// belongs to stream n / per_image and reads that stream's images, which
// lie `stride` floats apart in each level ([B, H, W] stacks, no copy).
// With B = 1 the offset is zero and the launch is the single-stream one.
//
// Plain C entry point, built with nvcc into a shared library and loaded
// with ctypes (ops/lk_level.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWinMax = 15;
constexpr int kRMax = 12;
constexpr int kLevelsMax = 4;
constexpr int kPassMax = kLevelsMax + 1;
constexpr int kThreads = 128;  // per point, and per block

// Level l of stream s starts at prev[l] + s * stride[l] (and cur[l] + ...);
// points come grouped by stream, per_image of them each.
struct Pyramids {
  const float* prev[kLevelsMax];
  const float* cur[kLevelsMax];
  long long stride[kLevelsMax];
  int h[kLevelsMax];
  int w[kLevelsMax];
  int per_image;
};

struct Pass {
  int level, radius, iters, backward;
};

struct Schedule {
  Pass pass[kPassMax];
  int n_pass, n_forward, r_max, gated;
};

struct Params {
  float eps_sq, min_eig, err_max, fb_dist;
};

__host__ __device__ constexpr int align4(int x) { return (x + 3) & ~3; }

// Row pitch of a search patch for radius R: the volume entries of a row
// come in blocks of four, each reading a 16-byte-aligned row segment of
// align4(win + 3) floats.
__host__ __device__ inline int patch_pitch(int win, int R) {
  return 4 * ((2 * R + 4) / 4) + align4(win - 1);
}

// Per-point shared memory, in floats, every part 16-byte aligned: one
// template slot per pass, the blend, T/gx/gy (rows padded to align4(win)),
// |residual|, two search patches (passes alternate), two volumes, five sums.
struct Layout {
  int tp, t11, T, gx, gy, absres, jp, jp_size, cx, cy, sums, total;
};

__host__ __device__ inline Layout layout(int win, int r_max, int n_pass) {
  const int cr = 2 * r_max + 1, rows = win * align4(win);
  Layout L{};
  int o = 0;
  L.tp = o;
  o += n_pass * align4((win + 3) * (win + 3));
  L.t11 = o;
  o += align4((win + 2) * (win + 2));
  L.T = o;
  o += rows;
  L.gx = o;
  o += rows;
  L.gy = o;
  o += rows;
  L.absres = o;
  o += align4(win * win);
  L.jp = o;
  L.jp_size = (cr + win - 1) * patch_pitch(win, r_max);
  o += 2 * L.jp_size;
  L.cx = o;
  o += align4(cr * cr);
  L.cy = o;
  o += align4(cr * cr);
  L.sums = o;
  L.total = o + 8;
  return L;
}

__device__ __forceinline__ float tent(int i, float d) {
  return fmaxf(0.0f, 1.0f - fabsf(static_cast<float>(i) - d));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// size x size patch of img with its corner at (y0, x0), as cp.async copies,
// into rows of `pitch` floats.
__device__ __forceinline__ void gather_async(float* dst, const float* img, int W, int y0,
                                             int x0, int size, int pitch, int lane) {
  for (int i = lane; i < size * size; i += kThreads) {
    const int p = i / size, q = i - p * size;
    cp_async_f32(dst + p * pitch + q, img + (y0 + p) * W + (x0 + q));
  }
}

// The template's integer base and fraction (the JAX package's clip rules).
__device__ __forceinline__ void template_base(float x, float y, int H, int W, int r, int* bx,
                                              int* by) {
  *bx = clampi(static_cast<int>(floorf(x)), r + 2, W - r - 4);
  *by = clampi(static_cast<int>(floorf(y)), r + 2, H - r - 4);
}

// The correlation volumes Cx, Cy [cr, cr]: C[p, q] = sum over the taps
// (wy, wx), in row order as in the plain version, of
// Jp[p + wy, q + wx] * g[wy, wx].  Each lane takes four neighbouring
// entries of a row at a time: per tap row it reads one row segment of the
// search patch and one row of each gradient as 16-byte loads and reuses
// them for all four, which keeps the shared-memory traffic below the
// arithmetic.  Entries past the row's end read padding and are not stored.
template <int WIN>
__device__ __forceinline__ void correlate(const float* Jp, const float* gx, const float* gy,
                                          float* Cx, float* Cy, int cr, int pitch, int lane) {
  constexpr int kRow = align4(WIN), kSeg = align4(WIN + 3);
  const int blocks = (cr + 3) / 4;
  for (int u = lane; u < cr * blocks; u += kThreads) {
    const int p = u / blocks, q0 = 4 * (u - p * blocks);
    float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int wy = 0; wy < WIN; ++wy) {
      float js[kSeg], g[kRow], h[kRow];
      const float4* jrow = reinterpret_cast<const float4*>(Jp + (p + wy) * pitch + q0);
      const float4* grow = reinterpret_cast<const float4*>(gx + wy * kRow);
      const float4* hrow = reinterpret_cast<const float4*>(gy + wy * kRow);
#pragma unroll
      for (int v = 0; v < kSeg / 4; ++v) {
        const float4 t = jrow[v];
        js[4 * v] = t.x;
        js[4 * v + 1] = t.y;
        js[4 * v + 2] = t.z;
        js[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < kRow / 4; ++v) {
        const float4 a = grow[v], b = hrow[v];
        g[4 * v] = a.x;
        g[4 * v + 1] = a.y;
        g[4 * v + 2] = a.z;
        g[4 * v + 3] = a.w;
        h[4 * v] = b.x;
        h[4 * v + 1] = b.y;
        h[4 * v + 2] = b.z;
        h[4 * v + 3] = b.w;
      }
#pragma unroll
      for (int wx = 0; wx < WIN; ++wx) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ax[k] = ax[k] + js[k + wx] * g[wx];
          ay[k] = ay[k] + js[k + wx] * h[wx];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (q0 + k < cr) {
        Cx[p * cr + q0 + k] = ax[k];
        Cy[p * cr + q0 + k] = ay[k];
      }
    }
  }
}

// The schedule and the level pointers are indexed by pass at run time;
// __grid_constant__ reads them in place instead of copying them to the
// thread's stack.
template <int WIN>
__global__ void __launch_bounds__(kThreads) klt_track_kernel(
    const __grid_constant__ Pyramids pyr, const __grid_constant__ Schedule sch,
    const Params prm, const float* __restrict__ pts,
    const float* __restrict__ prior, const bool* __restrict__ valid,
    float* __restrict__ xy_out, bool* __restrict__ status_out, float* __restrict__ err_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int n = blockIdx.x;

  constexpr int win = WIN, r = WIN / 2, tpl = WIN + 3, blend = WIN + 2, nw = WIN * WIN;
  constexpr int kRow = align4(WIN), kTpl = align4(tpl * tpl);
  const Layout L = layout(WIN, sch.r_max, sch.n_pass);
  float* const base = smem;
  float* const tp0 = base + L.tp;
  float* const t11 = base + L.t11;
  float* const T = base + L.T;
  float* const gx = base + L.gx;
  float* const gy = base + L.gy;
  float* const absres = base + L.absres;
  float* const Cx = base + L.cx;
  float* const Cy = base + L.cy;
  float* const sums = base + L.sums;

  const float px = pts[2 * n], py = pts[2 * n + 1];
  const bool valid_n = valid[n];
  // this point's stream: its images are `sid` strides into each level
  const long long sid = n / pyr.per_image;
  const auto prev = [&](int l) { return pyr.prev[l] + sid * pyr.stride[l]; };
  const auto cur = [&](int l) { return pyr.cur[l] + sid * pyr.stride[l]; };

  // The guess of the coarsest pass: the prior scaled to its level.
  const int l0 = sch.pass[0].level;
  const float inv0 = 1.0f / static_cast<float>(1 << l0);  // a power of two: exact
  float gux = prior[2 * n] * inv0, guy = prior[2 * n + 1] * inv0;

  // cp.async group 0: pass 0's template and search patch; group 1: the
  // templates of the later forward passes.
  for (int p = 0; p < sch.n_forward; ++p) {
    const int l = sch.pass[p].level;
    const float inv = 1.0f / static_cast<float>(1 << l);
    int btx, bty;
    template_base(px * inv, py * inv, pyr.h[l], pyr.w[l], r, &btx, &bty);
    gather_async(tp0 + p * kTpl, prev(l), pyr.w[l], bty - (r + 1), btx - (r + 1), tpl, tpl,
                 lane);
    if (p == 0) {
      const int margin = sch.pass[0].radius + r + 1;
      const int bjx = clampi(static_cast<int>(floorf(gux + 0.5f)), margin, pyr.w[l0] - margin - 1);
      const int bjy = clampi(static_cast<int>(floorf(guy + 0.5f)), margin, pyr.h[l0] - margin - 1);
      gather_async(base + L.jp, cur(l0), pyr.w[l0], bjy - (margin - 1), bjx - (margin - 1),
                   2 * sch.pass[0].radius + win, patch_pitch(win, sch.pass[0].radius), lane);
      cp_async_commit();
    }
  }
  cp_async_commit();

  float fx = 0.0f, fy = 0.0f, ferr = 0.0f;  // the forward result (level 0)
  bool ok = valid_n, fstatus = false, status = false;
  for (int p = 0; p < sch.n_pass; ++p) {
    const Pass ps = sch.pass[p];
    const bool bwd = ps.backward != 0;
    const int l = ps.level, R = ps.radius, cr = 2 * R + 1, pitch = patch_pitch(win, R);
    const int margin = R + r + 1;
    const int H = pyr.h[l], W = pyr.w[l];
    const float Rf = static_cast<float>(R);
    const float lim = static_cast<float>(static_cast<double>(R) - 1.001);
    const float edge = static_cast<float>(static_cast<double>(R) - 1.001 - 1e-3);
    float* const tp = tp0 + p * kTpl;
    float* const Jp = base + L.jp + (p & 1) * L.jp_size;

    // this pass's template point (the backward pass starts where the
    // forward passes ended) and valid mask; gux, guy hold its guess
    const float inv = 1.0f / static_cast<float>(1 << l);
    const float tx = bwd ? fx : px * inv, ty = bwd ? fy : py * inv;
    const bool valid_p = bwd ? fstatus : valid_n;
    int btx, bty;
    template_base(tx, ty, H, W, r, &btx, &bty);
    const float ftx = clampf(tx - static_cast<float>(btx), 0.0f, 1.0f);
    const float fty = clampf(ty - static_cast<float>(bty), 0.0f, 1.0f);
    const int bjx = clampi(static_cast<int>(floorf(gux + 0.5f)), margin, W - margin - 1);
    const int bjy = clampi(static_cast<int>(floorf(guy + 0.5f)), margin, H - margin - 1);
    const float dx0 = clampf(gux - static_cast<float>(bjx), -lim, lim);
    const float dy0 = clampf(guy - static_cast<float>(bjy), -lim, lim);

    // The template work comes first; only the volumes wait for the search
    // patch, which was requested at the end of the previous pass.  A
    // forward template came with the prologue's groups (all but the
    // newest); the backward one came with its search patch.
    if (bwd) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    // ---- template blend: t11[p, q] = tp[p + fty, q + ftx] ----
    for (int i = lane; i < blend * blend; i += kThreads) {
      const int a = i / blend, b = i - a * blend;
      const float* row0 = tp + a * tpl + b;
      const float* row1 = row0 + tpl;
      t11[i] = row0[0] * (1.0f - fty) * (1.0f - ftx) + row0[1] * (1.0f - fty) * ftx
               + row1[0] * fty * (1.0f - ftx) + row1[1] * fty * ftx;
    }
    __syncthreads();

    for (int i = lane; i < nw; i += kThreads) {
      const int a = i / win, b = i - a * win;
      T[a * kRow + b] = t11[(a + 1) * blend + b + 1];
      gx[a * kRow + b] = 0.5f * (t11[(a + 1) * blend + b + 2] - t11[(a + 1) * blend + b]);
      gy[a * kRow + b] = 0.5f * (t11[(a + 2) * blend + b + 1] - t11[a * blend + b + 1]);
    }
    __syncthreads();

    // ---- the five window sums on five lanes, then the volumes on all ----
    if (lane >= kThreads - 5) {
      const int k = lane - (kThreads - 5);  // gx*gx, gx*gy, gy*gy, T*gx, T*gy
      const float* a = k < 2 ? gx : (k == 2 ? gy : T);
      const float* b = (k == 0 || k == 3) ? gx : gy;
      float acc = a[0] * b[0];
#pragma unroll
      for (int i = 1; i < nw; ++i) {
        const int j = (i / win) * kRow + i % win;
        acc = acc + a[j] * b[j];
      }
      sums[k] = acc;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (valid_p) {  // an invalid point stays frozen: its volumes are never read
      correlate<WIN>(Jp, gx, gy, Cx, Cy, cr, pitch, lane);
    }
    __syncthreads();

    // ---- structure tensor + Gauss-Newton: every lane, the same values ----
    const float gxx = sums[0], gxy = sums[1], gyy = sums[2], c0x = sums[3], c0y = sums[4];
    const float det = gxx * gyy - gxy * gxy;
    const float trc = gxx + gyy;
    const float eig_min = 0.5f * (trc - sqrtf(fmaxf(trc * trc - 4.0f * det, 0.0f)));
    const bool trackable = eig_min / static_cast<float>(nw) > prm.min_eig;
    const float tiny = static_cast<float>(1e-9);
    const float det_safe = fabsf(det) < tiny ? tiny : det;
    const float i00 = gyy / det_safe;
    const float i01 = -gxy / det_safe;
    const float i11 = gxx / det_safe;

    bool frozen = !(valid_p && trackable);
    float dx = dx0, dy = dy0;
    // a frozen point's steps are zero and leave it where it is, so the loop
    // ends there (uniformly: every lane holds the same values)
    for (int it = 0; it < ps.iters && !frozen; ++it) {
      // the floors as floats feed the tent weights, as ints the addresses
      const float ey = dy + Rf, ex = dx + Rf;
      const float fly = floorf(ey), flx = floorf(ex);
      const float wy0 = fmaxf(0.0f, 1.0f - fabsf(fly - ey));
      const float wy1 = fmaxf(0.0f, 1.0f - fabsf((fly + 1.0f) - ey));
      const float wx0 = fmaxf(0.0f, 1.0f - fabsf(flx - ex));
      const float wx1 = fmaxf(0.0f, 1.0f - fabsf((flx + 1.0f) - ex));
      const int a = __float2int_rz(fly) * cr + __float2int_rz(flx), b = a + cr;
      const float tx0 = wy0 * Cx[a] + wy1 * Cx[b];
      const float tx1 = wy0 * Cx[a + 1] + wy1 * Cx[b + 1];
      const float ty0 = wy0 * Cy[a] + wy1 * Cy[b];
      const float ty1 = wy0 * Cy[a + 1] + wy1 * Cy[b + 1];
      const float bx = (tx0 * wx0 + tx1 * wx1) - c0x;
      const float by = (ty0 * wx0 + ty1 * wx1) - c0y;
      float sx = -(i00 * bx + i01 * by);
      float sy = -(i01 * bx + i11 * by);
      dx = clampf(dx + sx, -lim, lim);
      dy = clampf(dy + sy, -lim, lim);
      frozen = frozen || (sx * sx + sy * sy < prm.eps_sq);
    }
    const float x = static_cast<float>(bjx) + dx;
    const float y = static_cast<float>(bjy) + dy;

    // ---- request the next pass's patches; they land during the error ----
    if (p + 1 < sch.n_pass) {
      const Pass nx = sch.pass[p + 1];
      const int nl = nx.level, nmargin = nx.radius + r + 1;
      const int nH = pyr.h[nl], nW = pyr.w[nl];
      if (nx.backward) {
        gux = px;
        guy = py;
        int nbx, nby;
        template_base(x, y, nH, nW, r, &nbx, &nby);
        gather_async(tp0 + (p + 1) * kTpl, cur(0), nW, nby - (r + 1), nbx - (r + 1), tpl,
                     tpl, lane);
      } else {
        const float up = static_cast<float>(1 << (l - nl));
        gux = x * up;
        guy = y * up;
      }
      const int nbjx = clampi(static_cast<int>(floorf(gux + 0.5f)), nmargin, nW - nmargin - 1);
      const int nbjy = clampi(static_cast<int>(floorf(guy + 0.5f)), nmargin, nH - nmargin - 1);
      gather_async(base + L.jp + ((p + 1) & 1) * L.jp_size,
                   nx.backward ? prev(0) : cur(nl), nW, nbjy - (nmargin - 1),
                   nbjx - (nmargin - 1), 2 * nx.radius + win, patch_pitch(win, nx.radius), lane);
      cp_async_commit();
    }

    // ---- window L1 error: tent reads of the search patch ----
    for (int i = lane; i < nw; i += kThreads) {
      const int ri = i / win, ci = i - ri * win;
      const float ey = (dy + Rf) + static_cast<float>(ri);
      const float ex = (dx + Rf) + static_cast<float>(ci);
      const int iy = static_cast<int>(floorf(ey));
      const int ix = static_cast<int>(floorf(ex));
      const float wy0 = tent(iy, ey), wy1 = tent(iy + 1, ey);
      const float wx0 = tent(ix, ex), wx1 = tent(ix + 1, ex);
      const float* p0 = Jp + iy * pitch + ix;
      const float* p1 = p0 + pitch;
      const float t0 = p0[0] * wy0 + p1[0] * wy1;
      const float t1 = p0[1] * wy0 + p1[1] * wy1;
      absres[i] = fabsf((t0 * wx0 + t1 * wx1) - T[ri * kRow + ci]);
    }
    __syncthreads();
    float acc = absres[0];
#pragma unroll
    for (int i = 1; i < nw; ++i) acc = acc + absres[i];
    const float err = acc / static_cast<float>(nw);

    const float rb = static_cast<float>(r + 1);
    const bool inb = (x >= rb) && (x < static_cast<float>(W) - rb) && (y >= rb)
                     && (y < static_cast<float>(H) - rb);
    const bool at_edge = (fabsf(dx) >= edge) || (fabsf(dy) >= edge);
    const bool started_edge = (fabsf(dx0) >= edge) || (fabsf(dy0) >= edge);
    const bool ok_level = valid_p && trackable && inb && (!at_edge || started_edge);

    if (!bwd) {
      ok = ok && ok_level;
      if (p == sch.n_forward - 1) {
        fx = x;
        fy = y;
        ferr = err;
        fstatus = sch.gated ? (ok && err <= prm.err_max) : ok;
        status = fstatus;
      }
    } else {
      const bool bstatus = fstatus && ok_level && (err <= prm.err_max);
      const float ddx = x - px, ddy = y - py;
      const float rt = sqrtf(ddx * ddx + ddy * ddy);
      status = fstatus && bstatus && (rt <= prm.fb_dist);
    }
  }

  if (lane == 0) {
    xy_out[2 * n] = fx;
    xy_out[2 * n + 1] = fy;
    err_out[n] = ferr;
    status_out[n] = status;
  }
}

template <int WIN>
cudaError_t launch(const Pyramids& pyr, const Schedule& sch, const Params& prm,
                   const float* pts, const float* prior, const bool* valid, int N, float* xy,
                   bool* status, float* err, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * layout(WIN, sch.r_max, sch.n_pass).total;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(klt_track_kernel<WIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  klt_track_kernel<WIN><<<N, kThreads, bytes, stream>>>(pyr, sch, prm, pts, prior, valid, xy,
                                                        status, err);
  return cudaGetLastError();
}

// The window is a template parameter, so that the win^2-term sums and the
// tap loops unroll and their loads issue ahead of the dependent adds.
cudaError_t launch_any(int win, const Pyramids& pyr, const Schedule& sch, const Params& prm,
                       const float* pts, const float* prior, const bool* valid, int N,
                       float* xy, bool* status, float* err, cudaStream_t s) {
#define KLT_CASE(W) \
  if (win == W) return launch<W>(pyr, sch, prm, pts, prior, valid, N, xy, status, err, s);
  KLT_CASE(3)
  KLT_CASE(5)
  KLT_CASE(7)
  KLT_CASE(9)
  KLT_CASE(11)
  KLT_CASE(13)
  KLT_CASE(15)
#undef KLT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// prev, cur: level l of B streams' images, stream s at prev[l] + s *
// stride[l]; the N points come grouped by stream, per_image = N / B each.
// win: odd, 3 to kWinMax.  passes: n_pass rows of (level, radius, iters,
// backward).  Forward passes run from level levels-1 down to 0, one level
// each; a backward pass, if any, is the last and runs at level 0.  Returns
// a cudaError_t.
extern "C" int klt_track_launch(const float* const* prev, const float* const* cur,
                                const long long* stride, const int* h, const int* w,
                                int levels, int per_image, const int* passes,
                                int n_pass, int gated, int win, float eps_sq, float min_eig,
                                float err_max, float fb_dist, const float* pts,
                                const float* prior, const bool* valid, int N, float* xy,
                                bool* status, float* err, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (levels < 1 || levels > kLevelsMax || n_pass < 1 || n_pass > kPassMax || win < 3
      || win > kWinMax || win % 2 == 0) {
    return bad;
  }
  Pyramids pyr{};
  for (int l = 0; l < levels; ++l) {
    pyr.prev[l] = prev[l];
    pyr.cur[l] = cur[l];
    pyr.stride[l] = stride[l];
    pyr.h[l] = h[l];
    pyr.w[l] = w[l];
  }
  pyr.per_image = per_image;
  Schedule sch{};
  sch.n_pass = n_pass;
  sch.gated = gated;
  for (int p = 0; p < n_pass; ++p) {
    const Pass ps{passes[4 * p], passes[4 * p + 1], passes[4 * p + 2], passes[4 * p + 3]};
    if (ps.radius < 1 || ps.radius > kRMax || ps.iters < 0) return bad;
    if (ps.backward) {
      if (p == 0 || p != n_pass - 1 || ps.level != 0) return bad;
    } else {
      if (p != sch.n_forward) return bad;
      if (p == 0 ? ps.level != levels - 1 : ps.level != sch.pass[p - 1].level - 1) return bad;
      sch.n_forward = p + 1;
    }
    sch.pass[p] = ps;
    sch.r_max = ps.radius > sch.r_max ? ps.radius : sch.r_max;
  }
  if (sch.pass[sch.n_forward - 1].level != 0) return bad;
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (per_image < 1 || N % per_image != 0) return bad;
  const Params prm{eps_sq, min_eig, err_max, fb_dist};
  return launch_any(win, pyr, sch, prm, pts, prior, valid, N, xy, status, err,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int klt_track_limits(int* win_max, int* r_max, int* levels_max) {
  *win_max = kWinMax;
  *r_max = kRMax;
  *levels_max = kLevelsMax;
  return 0;
}
