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
// chip_smoke.py holds both versions to a float64 evaluation of the plain
// function.
//
// What bounds it on this card.  A call reads 21 bytes a point and does ~200
// float64 operations a point per linearisation, 8 linearisations and two
// prunes at 4 LM iterations: at N = 192 that is a few KB and a third of a
// MFLOP, a bound of ten nanoseconds.  What takes the time is latency: each
// LM iteration is a linearisation, a block-wide sum and a 6x6 step that the
// next iteration depends on, 8 of them in a row at 4 iterations.  So:
//   * one block of 256 threads per row; a row's threads stride over its N
//     points (any N), so a row's bits do not depend on S or on the other
//     rows of the launch; S rows are S independent blocks;
//   * each thread sums its points' 28 terms (21 upper entries of H, g, the
//     cost) in point order, in float64; the warps sum by a butterfly of xor
//     shuffles and the warps' partials are added in warp order: no float
//     atomics, the same bits on every run;
//   * the 6x6 work (accept/reject, damping, Cholesky, both triangular
//     solves, retraction) runs in thread 0 on registers and shared memory,
//     the others wait at the barrier; it is ~400 dependent operations, a
//     few microseconds at most.
// No tensor cores and no library: the system is 6x6.
//
// Plain C entry points, built with nvcc into a shared library and loaded
// with ctypes (solvers/pnp_kernel.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // threads per block (one block per row)
constexpr int kWarps = kThreads / 32;
constexpr int kSum = 28;             // the sums: 21 upper entries of H, 6 of g, the cost
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

// The LM's carried state, in shared memory: thread 0 writes it, every thread
// reads the trial pose after the barrier.
struct Lm {
  Pose best, trial;
  float H[21], g[6], lam;
  double cost;
};

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

// One point at a pose: `_residuals_jacobian`'s residual r, Jacobian J and raw
// depth z, evaluated in T from the float32 pose and point.
template <class T>
struct Point {
  T r[2];
  T J[2][6];
  T z;
};

template <class T>
__device__ __forceinline__ void evaluate(const Pose& p, const Cam& c, const Row& R, int n,
                                         Point<T>& o) {
  const T P[3] = {R.pts[3 * n], R.pts[3 * n + 1], R.pts[3 * n + 2]};
  const T q[4] = {p.q[0], p.q[1], p.q[2], p.q[3]};
  T X[3];
  rotate(q, P, X);
#pragma unroll
  for (int j = 0; j < 3; ++j) X[j] = X[j] + T(p.t[j]);
  o.z = X[2];
  const T eps = T(1e-6f);
  const T zs = (X[2] < T(0) ? -X[2] : X[2]) < eps ? eps : X[2];
  const T iz = T(1) / zs;
  const T fx = c.fx, fy = c.fy;
  o.r[0] = fx * X[0] * iz + T(c.cx) - T(R.obs[2 * n]);
  o.r[1] = fy * X[1] * iz + T(c.cy) - T(R.obs[2 * n + 1]);
  // J = P [I | -hat(X)], P = [[a, 0, e], [0, b, d]] the pinhole's 2x3
  const T a = fx * iz, e = -fx * X[0] * iz * iz;
  const T b = fy * iz, d = -fy * X[1] * iz * iz;
  o.J[0][0] = a;
  o.J[0][1] = T(0);
  o.J[0][2] = e;
  o.J[0][3] = e * X[1];
  o.J[0][4] = a * X[2] - e * X[0];
  o.J[0][5] = -(a * X[1]);
  o.J[1][0] = T(0);
  o.J[1][1] = b;
  o.J[1][2] = d;
  o.J[1][3] = -(b * X[2]) + d * X[1];
  o.J[1][4] = -(d * X[0]);
  o.J[1][5] = b * X[0];
}

// Sum v over the warp's lanes: a butterfly of xor shuffles; every lane ends
// with the same totals, in an order fixed by lane indices.
template <int N, class T>
__device__ __forceinline__ void warp_sum(T (&v)[N]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(kFull, v[n], m);
  }
}

// Sum v over the block: the warp sums, then the warps' partials added in warp
// order (`red` holds kWarps x N floats); the N totals land in `tot`, which
// every thread may read after the call.
template <int N, class T>
__device__ void block_sum(T (&v)[N], T* red, T* tot) {
  warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if ((n & 31) == lane) red[warp * N + n] = v[n];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// `_lm_solve`'s `linearize` at pose p with the fixed weights `mask`: H (21
// upper entries), g (6) and the cost into tot[0..27].  Huber when delta > 0,
// else L2.  Each point in float64, its terms summed in float64.
__device__ void linearize(const Pose& p, const Cam& c, const Row& R, const bool* mask,
                          const Huber& hb, double* red, double* tot) {
  double v[kSum];
#pragma unroll
  for (int k = 0; k < kSum; ++k) v[k] = 0.0;
  for (int n = threadIdx.x; n < R.N; n += kThreads) {
    Point<double> o;
    evaluate(p, c, R, n, o);
    const double wf = mask[n] ? 1.0 : 0.0;
    const double r2 = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    double w = wf, rho = r2;
    if (hb.on) {
      const double rn = sqrt(r2 < 1e-12 ? 1e-12 : r2);
      w = (rn <= hb.delta ? 1.0 : hb.delta / rn) * wf;
      rho = rn <= hb.delta ? r2 : hb.two_delta * rn - hb.delta_sq;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double w0 = w * o.J[0][i], w1 = w * o.J[1][i];
#pragma unroll
      for (int j = i; j < 6; ++j) v[sym(i, j)] += w0 * o.J[0][j] + w1 * o.J[1][j];
      v[21 + i] += w0 * o.r[0] + w1 * o.r[1];
    }
    v[27] += rho * wf;
  }
  block_sum(v, red, tot);
}

// The trial pose from the carried best: Exp(-x) o best, x = (damped H)^-1 g
// by `_chol_solve6`'s unrolled Cholesky.  Thread 0 only.
__device__ void lm_step(Lm& st) {
  float A[6][6];   // the damped matrix's lower triangle
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float h = st.H[sym(j, i)];
      if (i == j) {
        A[i][i] = (h + st.lam * (h < 1e-8f ? 1e-8f : h)) + 1e-9f;
      } else {
        A[i][j] = (h + st.lam * 1e-8f) + 0.0f;
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
    float s = st.g[i];
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
  const float half = 0.5f * th;
  const float k = small ? 0.5f - th2 / 48.0f : sinf(half) / th;
  Pose e;
  e.q[0] = small ? 1.0f - th2 / 8.0f : cosf(half);
#pragma unroll
  for (int j = 0; j < 3; ++j) e.q[1 + j] = k * phi[j];
  const float a = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2s;
  const float b = small ? static_cast<float>(1.0 / 6.0) - th2 / 120.0f
                        : (th - sinf(th)) / (th2s * th);
  const float K[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]},
                         {-phi[1], phi[0], 0.0f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float V = ((i == j ? 1.0f : 0.0f) + a * K[i][j]) + b * kk;
      acc = j == 0 ? V * rho[0] : acc + V * rho[j];
    }
    e.t[i] = acc;
  }
  // e o best: quat_normalize(quat_mul(e.q, best.q)), rotate(e.q, best.t) + e.t
  const float* p = st.best.q;
  float q[4] = {e.q[0] * p[0] - e.q[1] * p[1] - e.q[2] * p[2] - e.q[3] * p[3],
                e.q[0] * p[1] + e.q[1] * p[0] + e.q[2] * p[3] - e.q[3] * p[2],
                e.q[0] * p[2] - e.q[1] * p[3] + e.q[2] * p[0] + e.q[3] * p[1],
                e.q[0] * p[3] + e.q[1] * p[2] - e.q[2] * p[1] + e.q[3] * p[0]};
  normalize(q);
  float rt[3];
  rotate(e.q, st.best.t, rt);
#pragma unroll
  for (int j = 0; j < 4; ++j) st.trial.q[j] = q[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) st.trial.t[j] = rt[j] + e.t[j];
}

// Thread 0: take the linearisation in tot as the best point (H and g rounded
// to float32, the cost kept in float64 for the accept test).
__device__ __forceinline__ void take(Lm& st, const double* tot) {
#pragma unroll
  for (int n = 0; n < 21; ++n) st.H[n] = static_cast<float>(tot[n]);
#pragma unroll
  for (int n = 0; n < 6; ++n) st.g[n] = static_cast<float>(tot[21 + n]);
  st.cost = tot[27];
}

// `_lm_solve` from st.trial (the start pose, set by the caller): the result
// in st.best and st.cost.
__device__ void lm_solve(Lm& st, const Cam& c, const Row& R, const bool* mask, int iters,
                         const Huber& hb, double* red, double* tot) {
  linearize(st.trial, c, R, mask, hb, red, tot);
  if (threadIdx.x == 0) {
    st.best = st.trial;
    take(st, tot);
    st.lam = 1e-3f;
    lm_step(st);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    linearize(st.trial, c, R, mask, hb, red, tot);
    if (threadIdx.x == 0) {
      const bool accept = tot[27] < st.cost;
      if (accept) {
        st.best = st.trial;
        take(st, tot);
      }
      float lam = accept ? st.lam * 0.33f : st.lam * 10.0f;
      lam = lam < 1e-8f ? 1e-8f : lam;
      st.lam = lam > 1e6f ? 1e6f : lam;
      lm_step(st);
    }
    __syncthreads();
  }
}

// The prune at pose p: flags[n] = valid & chi^2 <= thresh & z > 0 (each
// point in float64), each thread its own points; the flags' count and the
// sum of chi^2 over them into tot[0..1].
__device__ void prune(const Pose& p, const Cam& c, const Row& R, float chi2_thresh, bool* flags,
                      double* red, double* tot) {
  double v[2] = {0.0, 0.0};
  for (int n = threadIdx.x; n < R.N; n += kThreads) {
    Point<double> o;
    evaluate(p, c, R, n, o);
    const double chi2 = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    const bool in = R.valid[n] && chi2 <= chi2_thresh && o.z > 0.0;
    flags[n] = in;
    v[0] += in ? 1.0 : 0.0;
    v[1] += chi2 * (in ? 1.0 : 0.0);
  }
  block_sum(v, red, tot);
}

__global__ void __launch_bounds__(kThreads)
pnp_refine_kernel(const float* __restrict__ q0, const float* __restrict__ t0,
                  const float* __restrict__ pts, const float* __restrict__ obs,
                  const bool* __restrict__ valid, int N, Cam c, int iters, Huber hb,
                  float chi2_thresh, int refine_l2, float* __restrict__ q_out,
                  float* __restrict__ t_out, bool* __restrict__ inl, long long* __restrict__ num,
                  float* __restrict__ cost) {
  __shared__ double red[kWarps * kSum];
  __shared__ double tot[kSum];
  __shared__ Lm st;
  const long long s = blockIdx.x;
  const Row R{pts + 3 * s * N, obs + 2 * s * N, valid + s * N, N};
  bool* flags = inl + s * N;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st.trial.q[j] = q0[4 * s + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) st.trial.t[j] = t0[3 * s + j];
  }
  __syncthreads();
  // 1. Huber LM over the valid points
  lm_solve(st, c, R, R.valid, iters, hb, red, tot);
  // 2. the prune at pose1 (the flags are each thread's own points: the L2
  // pass reads them back by the same stride)
  prune(st.best, c, R, chi2_thresh, flags, red, tot);
  double final_cost = tot[1];
  // 3. L2 LM over the inliers
  if (refine_l2) {
    __syncthreads();
    if (threadIdx.x == 0) st.trial = st.best;
    __syncthreads();
    lm_solve(st, c, R, flags, iters - 2 > 1 ? iters - 2 : 1, Huber{}, red, tot);
    final_cost = st.cost;
  }
  // 4. the final flags at pose2
  prune(st.best, c, R, chi2_thresh, flags, red, tot);
  if (threadIdx.x == 0) {
    float q[4] = {st.best.q[0], st.best.q[1], st.best.q[2], st.best.q[3]};
    normalize(q);
#pragma unroll
    for (int j = 0; j < 4; ++j) q_out[4 * s + j] = q[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) t_out[3 * s + j] = st.best.t[j];
    num[s] = static_cast<long long>(tot[0]);
    cost[s] = static_cast<float>(final_cost);
  }
}

}  // namespace

extern "C" int pnp_refine_launch(const float* q, const float* t, const float* pts,
                                 const float* obs, const bool* valid, int S, int N, float fx,
                                 float fy, float cx, float cy, int iters, double huber_delta,
                                 float chi2_thresh, int refine_l2, float* q_out, float* t_out,
                                 bool* inliers, long long* num_inliers, float* cost,
                                 void* stream) {
  if (S < 1 || N < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the plain version's Python scalars, each rounded to float32 where it
  // meets a float32 tensor
  const Huber hb{huber_delta > 0.0, static_cast<float>(huber_delta),
                 static_cast<float>(2.0 * huber_delta),
                 static_cast<float>(huber_delta * huber_delta)};
  pnp_refine_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, pts, obs, valid, N, Cam{fx, fy, cx, cy}, iters, hb, chi2_thresh, refine_l2, q_out,
      t_out, inliers, num_inliers, cost);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pnp_kernel_limits(int* threads) {
  *threads = kThreads;
  return 0;
}
