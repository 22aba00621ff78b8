// Local bundle adjustment's linearisation and Schur assembly for Hopper:
// K6a `ba_linearize_kernel` and K6b `ba_schur_kernel`.
//
// What they replace.  The JAX package's `local_ba` (alvaar_tpu/solvers/ba.py)
// is one jitted XLA program with no Pallas kernel in it.  K6a is the XLA
// formulation of `_residuals_jacobians` + `_linearize` (ba.py:172-206 and
// :288-345: per-observation Jacobians by `jax.jacfwd` under `vmap`, then the
// blockwise normal-equation einsums) and of its Jacobian-free residual pass
// `_residuals_fast` with the Huber cost (the trial cost of every LM
// iteration and the two pruning passes).  K6b is the Schur reduction of
// `_solve_lm` (ba.py:347-410, up to the Cholesky).  Their plain versions are
// `_linearize`, `_residual_pass` and `_schur_plain` in solvers/ba.py.
//
// K6a, per row s of a launch (one local-BA problem: a [W, K] window) and
// per observation (w, k): the reprojection residual, the closed-form 2x13
// Jacobian at the zero retraction, tangents (rho, phi) as in geom/lie.py,
//   observer  P [I | -hat(X_c)]
//   anchor    P R_o R_a^T [-I | hat(X_a)]
//   depth     -P R_o R_a^T X_a / lambda
// with P the pinhole's 2x3 at X_c (a clamped depth z is a constant there, so
// its column is 0; a clamped lambda zeroes the depth column, as forward-mode
// AD through the clamps gives), the Huber weight and cost, the zeroing of
// constant observers and anchors and of invalid slots; and in the same
// launch every block `_linearize` returns: H_cc [6W, 6W], g_c [6W], u
// [W, K, 6], va [W, K, 6], D [W, K], g_l [W, K] and the cost.  Neither the
// [W, K, 2, 13] Jacobian nor a [W, W, 6, 6] intermediate reaches device
// memory: a Jacobian lives in registers from its evaluation to its last
// product.  In cost-only mode it writes the residual pass: cost, r^2, z and
// the observation's inverse depth.  (The linearisation writes no cost: LM
// takes both of its costs from the residual pass.)
//
// K6b, per row s and pose pair (x, y): block (x, y) of the reduced system
// S = H_cc + damping - H_cl^T D^-1 H_cl and, on the diagonal, g_s[x], with the
// free-pose mask applied, from the carried blocks and the virtual-landmark
// indices (first observing row, anchor slot) instead of the dense one-hot
// tensors; the landmark coupling G, T_uu, T_uv and T_vv are formed on the fly.
//
// What bounds them on this card.  A call moves well under a megabyte and
// does a few MFLOP (W = 30, K = 192-352): its bound is a fraction of a
// microsecond, and what takes the time is latency: each block's dependent
// chain of index loads, Jacobian evaluations and block-wide reductions.  The
// eager PyTorch formulation launched ~1.3 k kernels per LM iteration
// (PERF.md); these two launches take their place.  So the design is the
// simple one that keeps the launch count down and the sums deterministic:
//   * K6a: one block of 128 threads per (s, x) window row (in cost-only
//     mode one block per s).  Block x owns everything that lands in row x of
//     the outputs: as observer it sweeps row x (H_oo, g_c's observer part,
//     u[x]); for each y it sweeps row x's observations anchored at y and row
//     y's anchored at x (H_cc block (x, y), H_aa and g_c's anchor part); as
//     representative it sweeps the observations whose virtual landmark is
//     (x, k) (va, D, g_l).  An observation's Jacobian is evaluated again in
//     each of its (at most four) roles instead of being stored;
//   * K6b: one block of 128 threads per (s, x, y), sweeping the K columns
//     (and, on the diagonal, the anchor scan over [W, K]);
//   * no float atomics: every sum is a per-thread sum over a fixed stride
//     then a fixed-order tree in shared memory, so the same inputs give the
//     same bits on every run, and a row's result does not depend on how
//     many rows the launch holds.
// No tensor cores: a 6x6 block is a sum of rank-2 updates of scattered
// observations, and TF32 is off in this program anyway.
//
// Numerics: the cost-only mode's r^2 and z follow `_residuals_fast`'s order
// of products and sums in float32 (built with --fmad=false), so they equal
// the plain pass's on the card.  The linearisation evaluates each
// observation's geometry, residual and closed-form Jacobian in float64 and
// rounds them to float32 once (`linearise`); its products and sums are
// float32.  The cost-only mode's cost is the plain pass's function evaluated
// and summed in float64 (`residual_pass` says why).  The plain version takes
// forward-mode AD and its cost in float32, so the two differ by the plain
// version's own round-off: chip_smoke.py holds both to a float64 evaluation.
//
// Plain C entry points, built with nvcc into a shared library and loaded
// with ctypes (solvers/ba_kernels.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWMax = 64;       // window rows a launch takes
constexpr int kThreads = 128;   // threads per block, both kernels (a power of two)
constexpr int kRed = 42;        // the widest block sum: a 6x6 block and a 6-vector

struct Cam {
  float fx, fy, cx, cy;
  float delta;        // Huber threshold
};

// One row of K6a's inputs.
struct LinRow {
  const float* lam_v;              // [W, K]
  const bool* valid;               // [W, K]
  const float* px;                 // [W, K, 2]
  const float* mxy;                // [W, K, 2]
  const long long* first;          // [W, K]  virtual landmark's row, W for none
  const long long* a_idx;          // [W, K]  anchor slot
  int W, K;
};

struct Poses {
  float q[kWMax][4];
  float t[kWMax][3];
  bool constant[kWMax];
};

// v + 2 q x (q x v + w v) on component values (solvers/ba.py `_rot_soa`).
template <class T>
__device__ __forceinline__ void rot(T qw, T qx, T qy, T qz, T vx, T vy, T vz, T out[3]) {
  const T cx = qy * vz - qz * vy + qw * vx;
  const T cy = qz * vx - qx * vz + qw * vy;
  const T cz = qx * vy - qy * vx + qw * vz;
  out[0] = vx + T(2) * (qy * cz - qz * cy);
  out[1] = vy + T(2) * (qz * cx - qx * cz);
  out[2] = vz + T(2) * (qx * cy - qy * cx);
}

template <class T>
struct Geometry {
  T r[2];
  T z;
  T Xa[3];        // anchor-frame point
  T Xc[3];        // observer-frame point
  T lam_s, z_s;   // after the clamps
};

// `_residuals_fast` for one observation: observer pose (qo, to), anchor pose
// (qa, ta), inverse depth lam, in T: float repeats the plain pass's every
// rounding, double is the linearisation's.  The clamps compare against
// float32's 1e-6, as the plain version does.
template <class T, class Q>
__device__ __forceinline__ void residual(const Q* qo, const Q* qa, const float* to,
                                         const float* ta, const Cam& c, float lam, float mx,
                                         float my, float px, float py, Geometry<T>& o) {
  const T eps = T(1e-6f);
  o.lam_s = fabsf(lam) < 1e-6f ? eps : T(lam);
  o.Xa[0] = T(mx) / o.lam_s;
  o.Xa[1] = T(my) / o.lam_s;
  o.Xa[2] = T(1) / o.lam_s;
  T Xw[3];
  rot<T>(qa[0], -qa[1], -qa[2], -qa[3], o.Xa[0] - T(ta[0]), o.Xa[1] - T(ta[1]),
         o.Xa[2] - T(ta[2]), Xw);
  T Xr[3];
  rot<T>(qo[0], qo[1], qo[2], qo[3], Xw[0], Xw[1], Xw[2], Xr);
  o.Xc[0] = Xr[0] + T(to[0]);
  o.Xc[1] = Xr[1] + T(to[1]);
  o.Xc[2] = Xr[2] + T(to[2]);
  o.z = o.Xc[2];
  o.z_s = (o.z < T(0) ? -o.z : o.z) < eps ? eps : o.z;
  o.r[0] = T(c.fx) * o.Xc[0] / o.z_s + T(c.cx) - T(px);
  o.r[1] = T(c.fy) * o.Xc[1] / o.z_s + T(c.cy) - T(py);
}

// `_huber_w` at r^2.
__device__ __forceinline__ float huber_w(float r2, const Cam& c) {
  const float rn = sqrtf(r2 < 1e-12f ? 1e-12f : r2);
  return rn <= c.delta ? 1.0f : (1.0f / rn) * c.delta;
}

__device__ __forceinline__ void unit(const float q[4], double out[4]) {
  const double n = sqrt(double(q[0]) * q[0] + double(q[1]) * q[1] + double(q[2]) * q[2]
                        + double(q[3]) * q[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = q[j] / n;
}

__device__ __forceinline__ void cross(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// One usable observation linearised: residual, Huber weight, the closed-form
// Jacobian blocks (zeroed for constant observer / anchor).
struct Obs {
  float r[2];
  float wt;
  float Jo[2][6];
  float Ja[2][6];
  float Jl[2];
};

// The geometry (unit quaternions) and the Jacobian in float64, rounded to
// float32 once: a
// residual is a difference of coordinates of 10^2 pixels, so near
// convergence the gradients are sums that cancel, and a point near the image
// plane scales its Jacobian by 1/z^2; in float32 both carry the pose chain's
// round-off, amplified (the plain float32 version's too: chip_smoke.py holds
// both to a float64 evaluation).
__device__ void linearise(const Poses& P, const Cam& c, const LinRow& in, int w, int k,
                          Obs& o) {
  const int i = w * in.K + k;
  const int a = static_cast<int>(in.a_idx[i]);
  const float lam = in.lam_v[static_cast<int>(in.first[i]) * in.K + k];
  // unit quaternions, as `_linearize`'s retraction leaves them (SE3.compose
  // normalises)
  double qo[4], qa[4];
  unit(P.q[w], qo);
  unit(P.q[a], qa);
  Geometry<double> R;
  residual<double>(qo, qa, P.t[w], P.t[a], c, lam, in.mxy[2 * i], in.mxy[2 * i + 1],
                   in.px[2 * i], in.px[2 * i + 1], R);
  o.r[0] = static_cast<float>(R.r[0]);
  o.r[1] = static_cast<float>(R.r[1]);
  o.wt = huber_w(static_cast<float>(R.r[0] * R.r[0] + R.r[1] * R.r[1]), c);

  // the pinhole's 2x3 at X_c; a clamped z is a constant (no z column)
  const bool z_clamped = (R.z < 0 ? -R.z : R.z) < double(1e-6f);
  const double iz = 1.0 / R.z_s;
  const double Pm[2][3] = {
      {c.fx * iz, 0.0, z_clamped ? 0.0 : -c.fx * R.Xc[0] * iz * iz},
      {0.0, c.fy * iz, z_clamped ? 0.0 : -c.fy * R.Xc[1] * iz * iz}};
  const bool lam_clamped = fabsf(lam) < 1e-6f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // observer: P [I | -hat(X_c)]; row r of P (-hat(X_c)) is X_c x P_r
    double oc[3];
    cross(R.Xc, Pm[r], oc);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o.Jo[r][j] = P.constant[w] ? 0.0f : static_cast<float>(Pm[r][j]);
      o.Jo[r][3 + j] = P.constant[w] ? 0.0f : static_cast<float>(oc[j]);
    }
    // PM_r = P_r R_o R_a^T, i.e. PM_r^T = R_a (R_o^T P_r^T)
    double t1[3], pm[3];
    rot<double>(qo[0], -qo[1], -qo[2], -qo[3], Pm[r][0], Pm[r][1], Pm[r][2], t1);
    rot<double>(qa[0], qa[1], qa[2], qa[3], t1[0], t1[1], t1[2], pm);
    // anchor: PM [-I | hat(X_a)]; row r of PM hat(X_a) is PM_r x X_a
    double ac[3];
    cross(pm, R.Xa, ac);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o.Ja[r][j] = P.constant[a] ? 0.0f : static_cast<float>(-pm[j]);
      o.Ja[r][3 + j] = P.constant[a] ? 0.0f : static_cast<float>(ac[j]);
    }
    // inverse depth: -PM X_a / lambda (0 where lambda is clamped)
    const double d = pm[0] * R.Xa[0] + pm[1] * R.Xa[1] + pm[2] * R.Xa[2];
    o.Jl[r] = lam_clamped ? 0.0f : static_cast<float>(-d / R.lam_s);
  }
}

// Sum v over the block's threads: a fixed-order tree in `buf` (kRed x
// kThreads floats); the N sums land in `tot`, which every thread may read
// after the call.
template <int N>
__device__ void block_sum(const float (&v)[N], float* buf, float* tot) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int n = 0; n < N; ++n) buf[n * kThreads + tid] = v[n];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int n = 0; n < N; ++n) buf[n * kThreads + tid] += buf[n * kThreads + tid + s];
    }
    __syncthreads();
  }
  if (tid < N) tot[tid] = buf[tid * kThreads];
  __syncthreads();
}

__device__ void load_poses(const float* q, const float* t, const bool* constant, int W,
                           Poses& P) {
  for (int i = threadIdx.x; i < W; i += kThreads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) P.q[i][j] = q[4 * i + j];
#pragma unroll
    for (int j = 0; j < 3; ++j) P.t[i][j] = t[3 * i + j];
    P.constant[i] = constant != nullptr && constant[i];
  }
  __syncthreads();
}

// A double summed over the block's threads in the same fixed-order tree
// (`buf` holds kThreads doubles); every thread gets the sum.
__device__ double block_sum_d(double v, double* buf) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] += buf[tid + s];
    __syncthreads();
  }
  const double out = buf[0];
  __syncthreads();
  return out;
}

// The residual pass over the whole row (cost-only mode): per slot r^2, z and
// the observation's inverse depth in the plain pass's float32 arithmetic
// (the pruning's inputs, equal to the plain pass's on the card), and the
// Huber cost over the usable slots, the same function evaluated and summed
// in float64 and written as float64.  LM accepts a step when this cost
// falls.  Near convergence a step lowers a cost of ~10^3 by ~10^-5, under
// a float32 ulp of the total, and a float32 cost of a few thousand slots
// carries more round-off than that: accepting on it stalls (equal costs
// reject every step) or walks along the noise, ~1e-4 from the optimum in t
// on W = 30 windows.
__device__ void residual_pass(const Poses& P, const Cam& c, const LinRow& in, double* buf,
                              double* cost, float* r2_out, float* z_out, float* lam_out) {
  double acc = 0.0;
  const double delta = c.delta;
  const int n = in.W * in.K;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int w = i / in.K, k = i % in.K;
    const int g = static_cast<int>(in.first[i]);
    const float lam_obs = g < in.W ? in.lam_v[g * in.K + k] : 0.0f;
    const bool ok = in.valid[i];
    const int a = static_cast<int>(in.a_idx[i]);
    const float lam = ok ? lam_obs : 1.0f;
    const float mx = in.mxy[2 * i], my = in.mxy[2 * i + 1];
    const float px = in.px[2 * i], py = in.px[2 * i + 1];
    Geometry<float> R;
    residual<float>(P.q[w], P.q[a], P.t[w], P.t[a], c, lam, mx, my, px, py, R);
    r2_out[i] = R.r[0] * R.r[0] + R.r[1] * R.r[1];
    z_out[i] = R.z;
    lam_out[i] = lam_obs;
    if (ok) {
      Geometry<double> Rd;
      residual<double>(P.q[w], P.q[a], P.t[w], P.t[a], c, lam, mx, my, px, py, Rd);
      const double e2 = Rd.r[0] * Rd.r[0] + Rd.r[1] * Rd.r[1];
      const double rn = sqrt(e2 < 1e-12 ? 1e-12 : e2);
      acc += rn <= delta ? e2 : 2.0 * delta * rn - delta * delta;
    }
  }
  const double total = block_sum_d(acc, buf);
  if (threadIdx.x == 0) *cost = total;
}

struct LinOut {
  float* H;      // [6W, 6W]
  float* g_c;    // [6W]
  float* u;      // [W, K, 6]
  float* va;     // [W, K, 6]
  float* D;      // [W, K]
  float* g_l;    // [W, K]
};

__global__ void __launch_bounds__(kThreads)
ba_linearize_kernel(const float* __restrict__ q, const float* __restrict__ t,
                    const float* __restrict__ lam_v, const bool* __restrict__ valid,
                    const float* __restrict__ px, const float* __restrict__ mxy,
                    const long long* __restrict__ first, const long long* __restrict__ a_idx,
                    const bool* __restrict__ constant, int W, int K, Cam c, int cost_only,
                    float* H, float* g_c, float* u, float* va, float* D, float* g_l,
                    double* cost, float* r2, float* z, float* lam_obs) {
  __shared__ Poses P;
  __shared__ __align__(8) float buf[kRed * kThreads];   // doubles in cost-only mode
  __shared__ float hg_tot[42], hxx[36], tot[42];
  const int s = blockIdx.y;
  const int x = blockIdx.x;
  const long long WK = static_cast<long long>(W) * K;
  const LinRow in{lam_v + s * WK, valid + s * WK, px + 2 * s * WK, mxy + 2 * s * WK,
                  first + s * WK, a_idx + s * WK, W, K};
  load_poses(q + 4 * s * W, t + 3 * s * W, constant != nullptr ? constant + s * W : nullptr, W,
             P);
  const int tid = threadIdx.x;

  if (cost_only) {
    residual_pass(P, c, in, reinterpret_cast<double*>(buf), cost + s, r2 + s * WK, z + s * WK,
                  lam_obs + s * WK);
    return;
  }
  const long long C = 6LL * W;
  const LinOut o{H + s * C * C, g_c + s * C, u + 6 * s * WK, va + 6 * s * WK, D + s * WK,
                 g_l + s * WK};
  Obs ob;

  // 1. observer role: row x's observations (H_oo, g_c's observer part, u)
  float hg[42];
#pragma unroll
  for (int n = 0; n < 42; ++n) hg[n] = 0.0f;
  for (int k = tid; k < K; k += kThreads) {
    float* uk = o.u + 6 * (x * K + k);
    if (!in.valid[x * K + k]) {
#pragma unroll
      for (int i = 0; i < 6; ++i) uk[i] = 0.0f;
      continue;
    }
    linearise(P, c, in, x, k, ob);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float w0 = ob.wt * ob.Jo[0][i], w1 = ob.wt * ob.Jo[1][i];
#pragma unroll
      for (int j = 0; j < 6; ++j) hg[6 * i + j] += w0 * ob.Jo[0][j] + w1 * ob.Jo[1][j];
      hg[36 + i] += w0 * ob.r[0] + w1 * ob.r[1];
      uk[i] = (ob.wt * ob.Jl[0]) * ob.Jo[0][i] + (ob.wt * ob.Jl[1]) * ob.Jo[1][i];
    }
  }
  block_sum<42>(hg, buf, hg_tot);

  // 2. pose pairs: block (x, y) of H_cc from row x's observations anchored
  //    at y (H_oa[x, y]) and row y's anchored at x (H_oa[y, x]^T); the latter
  //    also give H_aa[x] and g_c's anchor part
  float ag[42];
#pragma unroll
  for (int n = 0; n < 42; ++n) ag[n] = 0.0f;
  for (int y = 0; y < W; ++y) {
    float acc[36];
#pragma unroll
    for (int n = 0; n < 36; ++n) acc[n] = 0.0f;
    int hit = 0;
    for (int it = tid; it < 2 * K; it += kThreads) {
      const bool as_observer = it < K;
      const int k = as_observer ? it : it - K;
      const int w = as_observer ? x : y;
      const int i = w * K + k;
      if (!in.valid[i] || static_cast<int>(in.a_idx[i]) != (as_observer ? y : x)) continue;
      hit = 1;
      linearise(P, c, in, w, k, ob);
      if (as_observer) {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float w0 = ob.wt * ob.Jo[0][a], w1 = ob.wt * ob.Jo[1][a];
#pragma unroll
          for (int b = 0; b < 6; ++b) acc[6 * a + b] += w0 * ob.Ja[0][b] + w1 * ob.Ja[1][b];
        }
      } else {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float w0 = ob.wt * ob.Ja[0][a], w1 = ob.wt * ob.Ja[1][a];
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            acc[6 * a + b] += w0 * ob.Jo[0][b] + w1 * ob.Jo[1][b];
            ag[6 * a + b] += w0 * ob.Ja[0][b] + w1 * ob.Ja[1][b];
          }
          ag[36 + a] += w0 * ob.r[0] + w1 * ob.r[1];
        }
      }
    }
    // a pair that no observation couples is zero: skip its sum
    float* dst = y == x ? hxx : tot;
    if (__syncthreads_or(hit)) {
      block_sum<36>(acc, buf, dst);
    } else {
      if (tid < 36) dst[tid] = 0.0f;
      __syncthreads();
    }
    if (y != x && tid < 36) o.H[(6 * x + tid / 6) * C + 6 * y + tid % 6] = tot[tid];
    __syncthreads();
  }
  block_sum<42>(ag, buf, tot);
  if (tid < 36) {
    o.H[(6 * x + tid / 6) * C + 6 * x + tid % 6] = hg_tot[tid] + tot[tid] + hxx[tid];
  } else if (tid < 42) {
    o.g_c[6 * x + tid - 36] = hg_tot[tid] + tot[tid];
  }

  // 3. representative role: the members of virtual landmark (x, k)
  for (int k = tid; k < K; k += kThreads) {
    float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float d = 0.0f, gl = 0.0f;
    if (static_cast<int>(in.first[x * K + k]) == x) {
      for (int w = x; w < W; ++w) {
        const int i = w * K + k;
        if (static_cast<int>(in.first[i]) != x || !in.valid[i]) continue;
        linearise(P, c, in, w, k, ob);
        const float l0 = ob.wt * ob.Jl[0], l1 = ob.wt * ob.Jl[1];
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] += l0 * ob.Ja[0][j] + l1 * ob.Ja[1][j];
        d += ob.wt * (ob.Jl[0] * ob.Jl[0] + ob.Jl[1] * ob.Jl[1]);
        gl += l0 * ob.r[0] + l1 * ob.r[1];
      }
    }
    const int i = x * K + k;
#pragma unroll
    for (int j = 0; j < 6; ++j) o.va[6 * i + j] = v[j];
    o.D[i] = d;
    o.g_l[i] = gl;
  }
}

__global__ void __launch_bounds__(kThreads)
ba_schur_kernel(const float* __restrict__ D, const float* __restrict__ u,
                const float* __restrict__ va, const long long* __restrict__ first,
                const long long* __restrict__ a_idx, const float* __restrict__ H,
                const float* __restrict__ g_c, const float* __restrict__ g_l,
                const float* __restrict__ lam_lm, const bool* __restrict__ free_pose, int W,
                int K, float* S, float* g_s) {
  __shared__ float buf[kRed * kThreads];
  __shared__ float tot[42];
  const int y = blockIdx.x, x = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const long long WK = static_cast<long long>(W) * K;
  const long long C = 6LL * W;
  D += s * WK;
  u += 6 * s * WK;
  va += 6 * s * WK;
  first += s * WK;
  a_idx += s * WK;
  H += s * C * C;
  g_c += s * C;
  g_l += s * WK;
  free_pose += s * W;
  S += s * C * C;
  g_s += s * C;
  const float lam = lam_lm[s];
  const float damp = 1.0f + lam;
  // D^-1 of virtual landmark (g, k): 0 unless it is live (`lm_active`)
  auto inv_d = [&](int g, int k) {
    const int i = g * K + k;
    const float d = D[i];
    return static_cast<int>(first[i]) == g && d > 1e-12f ? 1.0f / (d * damp) : 0.0f;
  };

  float acc[42];
#pragma unroll
  for (int n = 0; n < 42; ++n) acc[n] = 0.0f;
  for (int k = tid; k < K; k += kThreads) {
    const int gx = static_cast<int>(first[x * K + k]);
    const int gy = static_cast<int>(first[y * K + k]);
    const float* ux = u + 6 * (x * K + k);
    const float* uy = u + 6 * (y * K + k);
    if (gx < W) {
      const float ix = inv_d(gx, k);
      // T_uu: observations of one virtual landmark in rows x and y
      if (gx == gy && ix != 0.0f) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += ix * ux[i] * uy[j];
        }
      }
      // T_uv[x, y]: row x's landmark anchored at y
      if (static_cast<int>(a_idx[gx * K + k]) == y && ix != 0.0f) {
        const float* v = va + 6 * (gx * K + k);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += ix * ux[i] * v[j];
        }
      }
    }
    // T_uv[y, x]^T: row y's landmark anchored at x
    if (gy < W && static_cast<int>(a_idx[gy * K + k]) == x) {
      const float iy = inv_d(gy, k);
      if (iy != 0.0f) {
        const float* v = va + 6 * (gy * K + k);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += iy * v[i] * uy[j];
        }
      }
    }
    // the diagonal's g_s: row x's share of H_cl^T D^-1 g_l
    if (x == y && gx < W) {
      const float gld = g_l[gx * K + k] * inv_d(gx, k);
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[36 + i] += gld * ux[i];
    }
  }
  if (x == y) {
    // T_vv and the anchor's share of g_s: every virtual landmark anchored at x
    for (int i = tid; i < W * K; i += kThreads) {
      const int g = i / K, k = i % K;
      if (static_cast<int>(a_idx[i]) != x) continue;
      const float id = inv_d(g, k);
      if (id == 0.0f) continue;
      const float* v = va + 6 * i;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b) acc[6 * a + b] += id * v[a] * v[b];
      }
      const float gld = g_l[i] * id;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[36 + a] += gld * v[a];
    }
  }
  block_sum<42>(acc, buf, tot);
  const bool free_pair = free_pose[x] && free_pose[y];
  if (tid < 36) {
    const int i = tid / 6, j = tid % 6;
    const long long at = (6 * x + i) * C + 6 * y + j;
    float h = H[at];
    if (x == y && i == j) h += lam * (h < 1e-8f ? 1e-8f : h);
    float out = free_pair ? h - tot[tid] : 0.0f;
    if (x == y && i == j) out += free_pose[x] ? 1e-9f : 1.0f;
    S[at] = out;
  } else if (tid < 42 && x == y) {
    const int i = tid - 36;
    g_s[6 * x + i] = free_pose[x] ? g_c[6 * x + i] - tot[tid] : 0.0f;
  }
}

}  // namespace

extern "C" int ba_linearize_launch(const float* q, const float* t, const float* lam_v,
                                   const bool* valid, const float* px, const float* mxy,
                                   const long long* first, const long long* a_idx,
                                   const bool* constant, int S, int W, int K, float fx,
                                   float fy, float cx, float cy, float delta, int cost_only, float* H, float* g_c,
                                   float* u, float* va, float* D, float* g_l, double* cost,
                                   float* r2, float* z, float* lam_obs, void* stream) {
  if (S < 1 || W < 1 || W > kWMax || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Cam c{fx, fy, cx, cy, delta};
  const dim3 grid(cost_only ? 1 : W, S);
  ba_linearize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, lam_v, valid, px, mxy, first, a_idx, constant, W, K, c, cost_only, H, g_c, u, va,
      D, g_l, cost, r2, z, lam_obs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ba_schur_launch(const float* D, const float* u, const float* va,
                               const long long* first, const long long* a_idx, const float* H,
                               const float* g_c, const float* g_l, const float* lam_lm,
                               const bool* free_pose, int S, int W, int K, float* S_out,
                               float* g_s, void* stream) {
  if (S < 1 || S > 65535 || W < 1 || W > kWMax || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(W, W, S);
  ba_schur_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free_pose, W, K, S_out, g_s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ba_kernels_limits(int* w_max, int* threads) {
  *w_max = kWMax;
  *threads = kThreads;
  return 0;
}
