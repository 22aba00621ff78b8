// Motion-only PnP for Hopper: K9 (`pnp_refine_kernel`), the whole
// `pnp_refine` in one launch.
//
// What it replaces.  The JAX package's `pnp_refine`
// (alvaar_tpu/solvers/pnp.py:156-190) is no Pallas kernel: it is traced into
// the jitted step (alvaar_tpu/frontend/step.py:188), where XLA fuses the
// whole solve into one program and `vmap` batches it across streams.  The
// port's plain version (solvers/pnp.py `_pnp_refine_plain`) runs the same
// code eagerly: ~2.7 k kernel launches a call at 4 LM iterations.  K9 is the
// counterpart of XLA's fusion: per row s of a launch (one stream's problem)
//   1. a Huber IRLS Levenberg-Marquardt over the valid points (`_lm_solve`):
//      one linearisation at pose0, then `iters` iterations, each
//      linearising once at the trial point, with the deferred branch-free
//      accept/reject;
//   2. the chi^2 / positive-depth prune at pose1 (the raw depth z > 0, not
//      the clamped one);
//   3. an L2 LM over the inliers, max(1, iters - 2) iterations (skipped when
//      refine_l2 is 0: pose2 = pose1, cost = sum chi^2 over the inliers);
//   4. the final residuals, inlier flags, their count, the cost and the
//      normalised pose2.
//
// The plain version's arithmetic (built with --fmad=false): each point's
// camera-frame coordinates (`quat_rotate`), the depth clamp |z| < 1e-6, the
// residual and the closed-form 2x6 Jacobian P [I | -hat(X_c)] (the products
// by the generator's zeros dropped: they are exact), the Huber weight and
// rho, the weight multiplied in for masked slots as well (a non-finite
// masked slot poisons the sums as it does in the plain einsums); then, in
// float32 as the plain version, the damping H + lam * clamp_min(diag(diag(H)),
// 1e-8) + 1e-9 I, whose clip also puts lam * 1e-8 on every off-diagonal
// entry, the unrolled Cholesky of `_chol_solve6` with sqrt(max(s, 1e-20)),
// and the retraction Exp(-delta) o pose (`so3_exp`, `_so3_left_jacobian` with
// their small-angle branches at theta^2 < 1e-8, `compose`, `quat_normalize`).
// What differs: each point is evaluated in float64 from the float32 pose and
// point, and its terms are summed in float64 (H and g rounded to float32
// once).  The accept test compares two costs whose difference near
// convergence is below a float32 cost's round-off; on a float32 cost a near
// tie went the other way (ACCURATE's width with outliers: 2.6e-5 from a
// float64 evaluation in t, the plain version 4.9e-8), so the cost, and with
// it H and g, is float64 (as local BA's residual pass, csrc/ba_kernels.cu).
// chip_smoke.py phase 2c holds both versions to a float64 evaluation of the
// plain function.
//
// What bounds it on this card.  A call reads 21 bytes a point and does ~200
// float64 operations a point per linearisation: at N = 192 and 4 LM
// iterations a few KB and a third of a MFLOP, a bound of ten nanoseconds.
// What takes the time is latency: a chain of passes, each a linearisation,
// a block-wide sum and a 6x6 step that the next pass depends on
// (tools/pnp_kernel_timeline.py times each phase).  The design shortens that
// chain:
//   * the prunes ride on the linearisations.  Each pass also computes, from
//     the same float64 r and z, every point's flag valid & chi^2 <= thresh &
//     z > 0 and carries the flags' count and chi^2 sum through the block sum;
//     an accepted trial takes them over with its H and g.  The flags at pose1
//     (the last accepted trial) are then the L2 pass's weights, and those at
//     pose2 the output: no pass re-evaluates a pose (8 passes at 4 LM
//     iterations, not 10).  A thread keeps its first 32 points' flags as bits
//     of a register (three words: the trial's, the best's, the L2 mask); a
//     row of more than 32 points a thread keeps the rest as bytes of three
//     planes in device memory whose roles rotate (the launcher allocates
//     them, rarely: past 4096 points a row at 128 threads);
//   * one barrier per pass.  A warp sums its lanes' 30 sums by a
//     reduce-scatter (at each xor level a lane keeps the half its lane bit
//     selects: 31 shuffles of a double, and lane l ends with sum l), writes
//     them to a double-buffered array of the warps' partials, and after one
//     __syncthreads every warp adds the warps' partials in warp order itself
//     and runs the accept test, the damping update and the 6x6 step on the
//     same float32 operations: every lane of every warp holds the same LM
//     state, so no trial pose goes through shared memory;
//   * no step after an LM's last pass (its trial is never evaluated): 6
//     steps at 4 LM iterations, not 10; the step's divisions and square
//     roots stay IEEE's, `sincosf` gives each angle's sine and cosine;
//   * both LMs as one loop over the passes, so that the pass and the step
//     are each one copy of code that stays in the instruction cache;
//   * each point's float64 reciprocals (1 / z, the Huber weight's 1 / |r|)
//     by Newton steps from the hardware's seed, without IEEE's branches;
//   * a warp per 32 points, 1-4 warps a block (the launcher's choice:
//     solvers/pnp_kernel.py `threads_for`), one block per row; a row's
//     threads stride over its N points (any N), so a row's bits depend on N
//     but not on S or on the other rows of the launch.
// Sums in a fixed order (a thread's points in order, the butterfly's lane
// pairs, the warps in order): no float atomics, the same bits on every run.
// No tensor cores and no library: the system is 6x6.
//
// Plain C entry points, built with nvcc into a shared library and loaded
// with ctypes (solvers/pnp_kernel.py).

#include <cuda_runtime.h>

namespace {

// threads per block at most, one block per row: a warp per SM sub-partition,
// each running the 6x6 step (192 and 256 threads were slower on an H100 at
// every timed shape; PERF.md section 6)
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRegPoints = 32;       // a thread's points whose flags are register bits
// the block sum's 30 sums (21 upper entries of H, 6 of g, the cost, the
// flags' count and their chi^2 sum) and 2 zeros, one a lane after the
// reduce-scatter
constexpr int kSum = 32;
constexpr int kCost = 27, kCount = 28, kChi2 = 29;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Cam {
  float fx, fy, cx, cy;
};

struct Pose {
  float q[4];   // (w, x, y, z)
  float t[3];
};

// The robust loss: Huber at `delta` when `on`, else L2 (the constants as
// the plain version's Python scalars round to float32).
struct Huber {
  bool on = false;
  float delta = 0.0f, two_delta = 0.0f, delta_sq = 0.0f;
};

// One row's inputs.
struct Row {
  const float* pts;     // [N, 3] world points
  const float* obs;     // [N, 2] undistorted pixels
  const bool* valid;    // [N]
  int N;
};

// The outputs, carved out of the launcher's one buffer (pnp_refine_launch).
struct Out {
  float* q;             // [S, 4]
  float* t;             // [S, 3]
  float* cost;          // [S]
  long long* num;       // [S]
  bool* inliers;        // [S, N]
};

// A linearisation's totals: H (21 upper entries) and g rounded to float32,
// the cost, the flags' count and their chi^2 sum in float64.
struct Lin {
  float H[21], g[6];
  double cost, count, chi2;
};

// A thread's inlier flags at three poses: the trial that a pass evaluates,
// the best point so far, and the L2 pass's weights (the flags at pose1).
// Point n = tid + k T of the thread: bit k of a word for k < kRegPoints,
// else byte n - kRegPoints T of one of three planes of the row's spill,
// whose roles rotate.
struct Flags {
  unsigned trial = 0, best = 0, mask = 0;
  unsigned char* spill = nullptr;   // [3][spill_n], null when spill_n <= 0
  long long spill_n = 0;
  int p_trial = 0, p_best = 1, p_mask = 2;

  __device__ unsigned char* plane(int p) const { return spill + p * spill_n; }
  // an accepted trial becomes the best point
  __device__ void take() {
    best = trial;
    const int p = p_trial;
    p_trial = p_best;
    p_best = p;
  }
  // the best point's flags become the L2 pass's weights
  __device__ void freeze_mask() {
    mask = best;
    const int p = p_mask;
    p_mask = p_best;
    p_best = p;
  }
};

// The block's scratch: the warps' partials, double-buffered so that a warp
// that runs ahead into the next pass never overwrites what a slower warp
// still reads, and each warp's totals.
struct alignas(16) Shared {
  double part[2][kMaxWarps][kSum];
  double tot[kMaxWarps][kSum];
  float totf[kMaxWarps][kSum];   // the same rounded to float32, each by its own lane
};

#ifdef PNP_TRACE
// tools/pnp_kernel_timeline.py builds a copy of this source with a tracer
// (`pnp_trace_mark`) defined ahead of it: the cycles of each phase of each
// pass, per warp.
struct Clock {
  long long last = 0;
  int pass = 0;
  __device__ void start(int p) {
    pass = p;
    last = clock64();
  }
  __device__ void mark(int phase) {
    const long long now = clock64();
    pnp_trace_mark(pass, phase, now - last);
    last = now;
  }
};
#else
struct Clock {
  __device__ void start(int) {}
  __device__ void mark(int) {}
};
#endif

// Index of entry (i, j), i <= j, of a symmetric 6x6 block stored as its 21
// upper entries.
__host__ __device__ constexpr int sym(int i, int j) { return i * (11 - i) / 2 + j; }

template <class T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// geom/lie.py `quat_rotate`: v + 2 q_v x (q_v x v + w v).
template <class T>
__device__ __forceinline__ void rotate(const T q[4], const T v[3], T out[3]) {
  const T qv[3] = {q[1], q[2], q[3]};
  T uv[3], s[3], uuv[3];
  cross(qv, v, uv);
#pragma unroll
  for (int j = 0; j < 3; ++j) s[j] = uv[j] + q[0] * v[j];
  cross(qv, s, uuv);
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = v[j] + T(2) * uuv[j];
}

// `quat_normalize`: q / max(|q|, 1e-8).
__device__ __forceinline__ void normalize(float q[4]) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = n < 1e-8f ? 1e-8f : n;
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = q[j] / n;
}

// The point evaluation's float64 reciprocal and reciprocal square root: two
// Newton steps from the hardware's seed, without the branches and calls of
// IEEE's float64 `/` and `sqrt` (within a few units in the last place of
// them: the point's residual, weight and flag stay float64 values).
__device__ __forceinline__ double rcp64(double x) {
#ifdef __CUDA_ARCH__
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
#else
  double y = 1.0 / x;
#endif
  y = fma(y, fma(-x, y, 1.0), y);
  return fma(y, fma(-x, y, 1.0), y);
}

__device__ __forceinline__ double rsqrt64(double x) {
#ifdef __CUDA_ARCH__
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
#else
  double y = 1.0 / sqrt(x);
#endif
  y = y * fma(-0.5 * x, y * y, 1.5);
  return y * fma(-0.5 * x, y * y, 1.5);
}

// One point at a pose: `_residuals_jacobian`'s residual r, Jacobian J and raw
// depth z, evaluated in float64 from the float32 pose and point.
struct Point {
  double r[2];
  double J[2][6];
  double z;
};

__device__ __forceinline__ void evaluate(const Pose& p, const Cam& c, const Row& R, int n,
                                         Point& o) {
  const double P[3] = {R.pts[3 * n], R.pts[3 * n + 1], R.pts[3 * n + 2]};
  const double q[4] = {p.q[0], p.q[1], p.q[2], p.q[3]};
  double X[3];
  rotate(q, P, X);
#pragma unroll
  for (int j = 0; j < 3; ++j) X[j] = X[j] + double(p.t[j]);
  o.z = X[2];
  const double eps = double(1e-6f);
  const double zs = (X[2] < 0.0 ? -X[2] : X[2]) < eps ? eps : X[2];
  const double iz = rcp64(zs);
  const double fx = c.fx, fy = c.fy;
  o.r[0] = fx * X[0] * iz + double(c.cx) - double(R.obs[2 * n]);
  o.r[1] = fy * X[1] * iz + double(c.cy) - double(R.obs[2 * n + 1]);
  // J = P [I | -hat(X)], P = [[a, 0, e], [0, b, d]] the pinhole's 2x3
  const double a = fx * iz, e = -fx * X[0] * iz * iz;
  const double b = fy * iz, d = -fy * X[1] * iz * iz;
  o.J[0][0] = a;
  o.J[0][1] = 0.0;
  o.J[0][2] = e;
  o.J[0][3] = e * X[1];
  o.J[0][4] = a * X[2] - e * X[0];
  o.J[0][5] = -(a * X[1]);
  o.J[1][0] = 0.0;
  o.J[1][1] = b;
  o.J[1][2] = d;
  o.J[1][3] = -(b * X[2]) + d * X[1];
  o.J[1][4] = -(d * X[0]);
  o.J[1][5] = b * X[0];
}

// One level of the warp's reduce-scatter: the lanes l and l ^ M add their
// sums pairwise, and each keeps the half that its lane bit M selects (the
// upper half where the bit is set) in v[0..M-1].
template <int M>
__device__ __forceinline__ void scatter_level(double (&v)[kSum], bool upper) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const double send = upper ? v[i] : v[M + i];
    const double keep = upper ? v[M + i] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, M);
  }
}

// The warp's totals of the kSum sums, scattered: lane l returns the total of
// sum l, in an order fixed by the lane indices.
__device__ __forceinline__ double warp_scatter(double (&v)[kSum]) {
  const int lane = threadIdx.x & 31;
  scatter_level<16>(v, lane & 16);
  scatter_level<8>(v, lane & 8);
  scatter_level<4>(v, lane & 4);
  scatter_level<2>(v, lane & 2);
  scatter_level<1>(v, lane & 1);
  return v[0];
}

// One pass at pose p: every point of the row evaluated once (each thread its
// own points, in order), its terms of `_lm_solve`'s `linearize` (Huber when
// hb.on, else L2; the fixed weights the valid flags, or with `l2` the
// frozen mask) and its inlier flag at p (into f.trial) with its chi^2; the
// sums over the block into `lin`, in every thread.  `buf` picks the
// partials' buffer (the pass's parity).
__device__ void pass(const Pose& p, const Cam& c, const Row& R, bool l2, const Huber& hb,
                     float chi2_thresh, Flags& f, Shared& sh, int buf, Clock& clk, Lin& lin) {
  const int T = blockDim.x;
  double v[kSum];
#pragma unroll
  for (int k = 0; k < kSum; ++k) v[k] = 0.0;
  unsigned bits = 0;
  int k = 0;
  for (int n = threadIdx.x; n < R.N; n += T, ++k) {
    Point o;
    evaluate(p, c, R, n, o);
    const bool valid = R.valid[n];
    const long long sp = n - static_cast<long long>(kRegPoints) * T;   // spill index
    const bool wbit = !l2 ? valid
                      : k < kRegPoints ? ((f.mask >> k) & 1u) != 0
                                       : f.plane(f.p_mask)[sp] != 0;
    const double wf = wbit ? 1.0 : 0.0;
    const double r2 = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    double w = wf, rho = r2;
    if (hb.on) {
      const double r2c = r2 < 1e-12 ? 1e-12 : r2, rs = rsqrt64(r2c), rn = r2c * rs;
      w = (rn <= hb.delta ? 1.0 : hb.delta * rs) * wf;
      rho = rn <= hb.delta ? r2 : hb.two_delta * rn - hb.delta_sq;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double w0 = w * o.J[0][i], w1 = w * o.J[1][i];
#pragma unroll
      for (int j = i; j < 6; ++j) v[sym(i, j)] += w0 * o.J[0][j] + w1 * o.J[1][j];
      v[21 + i] += w0 * o.r[0] + w1 * o.r[1];
    }
    v[kCost] += rho * wf;
    // the prune's flag, from the same r and z
    const bool in = valid && r2 <= chi2_thresh && o.z > 0.0;
    if (k < kRegPoints) {
      bits |= (in ? 1u : 0u) << k;
    } else {
      f.plane(f.p_trial)[sp] = in;
    }
    const double inf = in ? 1.0 : 0.0;
    v[kCount] += inf;
    v[kChi2] += r2 * inf;
  }
  f.trial = bits;
  clk.mark(0);
  const double mine = warp_scatter(v);
  clk.mark(1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sh.part[buf][warp][lane] = mine;
  __syncthreads();
  double s = sh.part[buf][0][lane];
  for (int w = 1; w < (T >> 5); ++w) s += sh.part[buf][w][lane];
  sh.tot[warp][lane] = s;
  sh.totf[warp][lane] = static_cast<float>(s);
  __syncwarp();
  const double* tot = sh.tot[warp];
#pragma unroll
  for (int j = 0; j < 21; ++j) lin.H[j] = sh.totf[warp][j];
#pragma unroll
  for (int j = 0; j < 6; ++j) lin.g[j] = sh.totf[warp][21 + j];
  lin.cost = tot[kCost];
  lin.count = tot[kCount];
  lin.chi2 = tot[kChi2];
  clk.mark(2);
}

// The trial pose from the best point: Exp(-x) o best, x = (damped H)^-1 g by
// `_chol_solve6`'s unrolled Cholesky.  Every thread runs it on the same
// values.
__device__ Pose lm_step(const Pose& best, const Lin& b, float lam) {
  float A[6][6];   // the damped matrix's lower triangle
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float h = b.H[sym(j, i)];
      if (i == j) {
        A[i][i] = (h + lam * (h < 1e-8f ? 1e-8f : h)) + 1e-9f;
      } else {
        A[i][j] = (h + lam * 1e-8f) + 0.0f;
      }
    }
  }
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(s < 1e-20f ? 1e-20f : s) : s / L[j][j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b.g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  // SE3.exp(xi), xi = -x = (rho, phi)
  const float rho[3] = {-x[0], -x[1], -x[2]};
  const float phi[3] = {-x[3], -x[4], -x[5]};
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = th2 < 1e-8f;
  const float th2s = small ? 1.0f : th2;
  const float th = sqrtf(th2s);
  float sh, ch, st, ct;   // sincosf: sinf's and cosf's values in one call
  sincosf(0.5f * th, &sh, &ch);
  sincosf(th, &st, &ct);
  const float k = small ? 0.5f - th2 / 48.0f : sh / th;
  Pose e;
  e.q[0] = small ? 1.0f - th2 / 8.0f : ch;
#pragma unroll
  for (int j = 0; j < 3; ++j) e.q[1 + j] = k * phi[j];
  const float a = small ? 0.5f - th2 / 24.0f : (1.0f - ct) / th2s;
  const float bb = small ? static_cast<float>(1.0 / 6.0) - th2 / 120.0f : (th - st) / (th2s * th);
  const float K[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]},
                         {-phi[1], phi[0], 0.0f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float V = ((i == j ? 1.0f : 0.0f) + a * K[i][j]) + bb * kk;
      acc = j == 0 ? V * rho[0] : acc + V * rho[j];
    }
    e.t[i] = acc;
  }
  // e o best: quat_normalize(quat_mul(e.q, best.q)), rotate(e.q, best.t) + e.t
  const float* p = best.q;
  Pose out;
  float q[4] = {e.q[0] * p[0] - e.q[1] * p[1] - e.q[2] * p[2] - e.q[3] * p[3],
                e.q[0] * p[1] + e.q[1] * p[0] + e.q[2] * p[3] - e.q[3] * p[2],
                e.q[0] * p[2] - e.q[1] * p[3] + e.q[2] * p[0] + e.q[3] * p[1],
                e.q[0] * p[3] + e.q[1] * p[2] - e.q[2] * p[1] + e.q[3] * p[0]};
  normalize(q);
  float rt[3];
  rotate(e.q, best.t, rt);
#pragma unroll
  for (int j = 0; j < 4; ++j) out.q[j] = q[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) out.t[j] = rt[j] + e.t[j];
  return out;
}

// The LM's carried state, the same in every thread.
struct Lm {
  Pose best, trial;
  Lin b;          // the best point's totals
  float lam;
};

__global__ void __launch_bounds__(kMaxThreads)
pnp_refine_kernel(const float* __restrict__ q0, const float* __restrict__ t0,
                  const float* __restrict__ pts, const float* __restrict__ obs,
                  const bool* __restrict__ valid, int N, Cam c, int iters, Huber hb,
                  float chi2_thresh, int refine_l2, Out out, unsigned char* __restrict__ spill) {
  __shared__ Shared sh;
  const long long s = blockIdx.x;
  const int T = blockDim.x;
  const Row R{pts + 3 * s * N, obs + 2 * s * N, valid + s * N, N};
  Flags f;
  f.spill_n = N - static_cast<long long>(kRegPoints) * T;
  if (f.spill_n > 0) f.spill = spill + 3 * s * f.spill_n;
  Lm st;
  double final_chi2 = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) st.trial.q[j] = q0[4 * s + j];
#pragma unroll
  for (int j = 0; j < 3; ++j) st.trial.t[j] = t0[3 * s + j];
  // 1. the Huber LM over the valid points, `_lm_solve`: a linearisation at
  // pose0, then iters iterations, each linearising at the trial; 2. the
  // prune at pose1 is its best point's flags; 3. the L2 LM from pose1 over
  // them.  One loop over both LMs' passes, so that the code of the pass and
  // the step exists once (one copy stays in the instruction cache); the
  // step after an LM's last pass, whose trial nothing evaluates, is skipped.
  const int n_huber = 1 + iters;
  const int n_pass = n_huber + (refine_l2 ? 1 + (iters - 2 > 1 ? iters - 2 : 1) : 0);
  Clock clk;
  Lin lin;
  for (int p = 0; p < n_pass; ++p) {
    const bool l2 = p >= n_huber, first = p == 0 || p == n_huber;
    if (p == n_huber) {
      f.freeze_mask();
      st.trial = st.best;
    }
    clk.start(p);
    pass(st.trial, c, R, l2, l2 ? Huber{} : hb, chi2_thresh, f, sh, p & 1, clk, lin);
    const bool accept = first || lin.cost < st.b.cost;
    if (accept) {
      st.best = st.trial;
      st.b = lin;
      f.take();
    }
    float lam = first ? 1e-3f : accept ? st.lam * 0.33f : st.lam * 10.0f;
    lam = lam < 1e-8f ? 1e-8f : lam;
    st.lam = lam > 1e6f ? 1e6f : lam;
    if (p + 1 != n_huber && p + 1 != n_pass) st.trial = lm_step(st.best, st.b, st.lam);
    clk.mark(3);
    if (p + 1 == n_huber) final_chi2 = st.b.chi2;
  }
  // the cost: the L2 LM's, or without it the inliers' chi^2 sum at pose1
  const double final_cost = refine_l2 ? st.b.cost : final_chi2;
  // 4. the flags at pose2 are the best point's
  int k = 0;
  for (int n = threadIdx.x; n < N; n += T, ++k) {
    out.inliers[s * N + n] = k < kRegPoints ? ((f.best >> k) & 1u) != 0
                                            : f.plane(f.p_best)[n - kRegPoints * T] != 0;
  }
  if (threadIdx.x == 0) {
    float q[4] = {st.best.q[0], st.best.q[1], st.best.q[2], st.best.q[3]};
    normalize(q);
#pragma unroll
    for (int j = 0; j < 4; ++j) out.q[4 * s + j] = q[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) out.t[3 * s + j] = st.best.t[j];
    out.num[s] = static_cast<long long>(st.b.count);
    out.cost[s] = static_cast<float>(final_cost);
  }
}

}  // namespace

// K9 on S rows of N points with `threads` threads a block (a multiple of 32,
// at most kMaxThreads).  `out` is one buffer of out_bytes(S, N, threads)
// bytes: num [S] int64 at 0, q [S, 4] float at 8 S, t [S, 3] at 24 S, cost
// [S] at 36 S, the inlier flags [S, N] bool at 40 S, then the flags' spill
// [S, 3, N - 32 threads] bytes when N > 32 threads.
extern "C" int pnp_refine_launch(const float* q, const float* t, const float* pts,
                                 const float* obs, const bool* valid, int S, int N, int threads,
                                 float fx, float fy, float cx, float cy, int iters,
                                 double huber_delta, float chi2_thresh, int refine_l2, void* out,
                                 void* stream) {
  if (S < 1 || N < 0 || iters < 0 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plain version's Python scalars, each rounded to float32 where it
  // meets a float32 tensor
  const Huber hb{huber_delta > 0.0, static_cast<float>(huber_delta),
                 static_cast<float>(2.0 * huber_delta),
                 static_cast<float>(huber_delta * huber_delta)};
  unsigned char* base = static_cast<unsigned char*>(out);
  const long long s = S;
  const Out o{reinterpret_cast<float*>(base + 8 * s), reinterpret_cast<float*>(base + 24 * s),
              reinterpret_cast<float*>(base + 36 * s), reinterpret_cast<long long*>(base),
              reinterpret_cast<bool*>(base + 40 * s)};
  pnp_refine_kernel<<<S, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, pts, obs, valid, N, Cam{fx, fy, cx, cy}, iters, hb, chi2_thresh, refine_l2, o,
      base + 40 * s + s * N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pnp_kernel_limits(int* threads, int* reg_points) {
  *threads = kMaxThreads;
  *reg_points = kRegPoints;
  return 0;
}
