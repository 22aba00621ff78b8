// Local bundle adjustment's linearisation and Schur assembly for Hopper:
// K6a (`ba_linearize_eval_kernel` + `ba_linearize_reduce_kernel`, and the
// residual pass `ba_residuals_kernel` + `ba_residuals_sum_kernel`) and K6b
// (`ba_schur_kernel`).
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
// AD through the clamps gives), the Huber weight, the zeroing of constant
// observers and anchors and of invalid slots; then every block `_linearize`
// returns: H_cc [6W, 6W], g_c [6W], u [W, K, 6], va [W, K, 6], D [W, K],
// g_l [W, K].  The residual pass writes the Huber cost, r^2, z and the
// observation's inverse depth.
//
// K6b, per row s and pose pair (x, y): block (x, y) of the reduced system
// S = H_cc + damping - H_cl^T D^-1 H_cl and, on the diagonal, g_s[x], with the
// free-pose mask applied, from the carried blocks and the virtual-landmark
// indices (first observing row, anchor slot) instead of the dense one-hot
// tensors; the landmark coupling G, T_uu, T_uv and T_vv are formed on the fly.
//
// What bounds them on this card.  A call moves about a megabyte and does a
// few MFLOP (W = 30, K = 192-352; S rows of that under vmap): its bound is a
// few microseconds at most, so these are latency-bound kernels.  What takes
// the time is each thread's chain of dependent loads, float64 evaluations
// and reductions, and how much of the card's 132 SMs the grid keeps busy.
// The design aims at short chains and a full card:
//   * K6a evaluates each observation once.  `ba_linearize_eval_kernel` runs
//     one thread per slot over the whole S x W x K grid (float64 geometry
//     and Jacobian, rounded to float32 once) and writes u, a float32 record
//     per usable observation (Jacobian blocks, weight, residual: 128 bytes)
//     and its depth block's share (32 bytes), and one byte per slot for its
//     anchor (0xFF: not usable) and one for its virtual landmark's row, to a
//     scratch the wrapper allocates (1.7 MB at K = 352; it stays in the 50 MB
//     L2).  `ba_linearize_reduce_kernel` then sums with parallelism over the
//     outputs, one grid of three kinds of blocks per row: a block per
//     diagonal block x (H_oo + H_aa + H_oa + H_oa^T and g_c[x]: it scans the
//     row's anchor bytes for observations in row x or anchored at x), a warp
//     per pose pair x < y (block (x, y) from row x's observations anchored
//     at y and row y's anchored at x, written with its transpose), and a
//     thread per virtual landmark (g, k) walking its column's members (va,
//     D, g_l).  At W = 30 that is 30 + 55 + WK/256 blocks of 256 threads a
//     row;
//   * the residual pass runs a thread per slot over many blocks a row; each
//     block writes its float64 partial of the cost and `ba_residuals_sum_
//     kernel` adds a row's partials in block order;
//   * K6b runs a block per diagonal block x (its K sweep and the scan for
//     the virtual landmarks anchored at x: T_vv and the anchor share of g_s)
//     and a warp per pose pair x < y (written with its transpose);
//   * every sum is a per-thread sum in a fixed order, then a butterfly of
//     `__shfl_xor_sync` within the warp, then, in a block, the warps'
//     partials added in warp order: no float atomics.
//     The same inputs give the same bits on every run, and a row's result
//     does not depend on how many rows the launch holds;
//   * the pose tables are staged in shared memory with `cp.async`.
// No tensor cores: a 6x6 block is a sum of rank-2 updates of scattered
// observations, the blocks are float32 with TF32 off, and the geometry is
// float64.  So K6a's linearisation is two launches and its residual pass
// two; K6b is one.
//
// Numerics: the residual pass's r^2 and z follow `_residuals_fast`'s order
// of products and sums in float32 (built with --fmad=false), so they equal
// the plain pass's on the card.  The linearisation evaluates each
// observation's geometry, residual and closed-form Jacobian in float64 and
// rounds them to float32 once (`linearise`); its products and sums are
// float32.  The residual pass's cost is the plain pass's function evaluated
// and summed in float64 (`residual_slot` says why).  The plain version takes
// forward-mode AD and its cost in float32, so the two differ by the plain
// version's own round-off: chip_smoke.py holds both to a float64 evaluation.
//
// Plain C entry points, built with nvcc into a shared library and loaded
// with ctypes (solvers/ba_kernels.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWMax = 64;         // window rows a launch takes
constexpr int kThreads = 256;     // threads per block of the reducing kernels
constexpr int kWarps = kThreads / 32;
constexpr int kEvalThreads = 128; // threads per block of the evaluation (float64)
constexpr int kRecA = 32;         // floats per observation record: Jo, Ja, wt, r
constexpr int kRecB = 8;          // floats of its depth block's share: v, d, g_l
constexpr int kSym = 27;          // a symmetric 6x6 block (21) and a 6-vector
constexpr unsigned kNone = 0xFF;  // the key byte of a slot that is not usable
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// K6a's scratch, carved from one allocation: per slot an observation record
// and its depth block's share, and per row its anchor and virtual-landmark
// bytes (each row's bytes padded to 16, so that they read as 32-bit words).
struct Scratch {
  float* rec_a;             // [S, W, K, kRecA]
  float* rec_b;             // [S, W, K, kRecB]
  unsigned char* akey;      // [S, KS] anchor slot, kNone if not usable
  unsigned char* fkey;      // [S, KS] virtual landmark's row (W: none)
  long long ks;             // KS
};

__host__ __device__ long long key_stride(int W, int K) {
  return (static_cast<long long>(W) * K + 15) / 16 * 16;
}

__host__ __device__ long long scratch_bytes(int S, int W, int K) {
  const long long slots = static_cast<long long>(S) * W * K;
  return slots * (kRecA + kRecB) * 4 + 2LL * S * key_stride(W, K);
}

__host__ __device__ Scratch carve(void* base, int S, int W, int K) {
  const long long slots = static_cast<long long>(S) * W * K;
  float* a = static_cast<float*>(base);
  float* b = a + slots * kRecA;
  unsigned char* keys = reinterpret_cast<unsigned char*>(b + slots * kRecB);
  const long long ks = key_stride(W, K);
  return Scratch{a, b, keys, keys + S * ks, ks};
}

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
// float32 once: a residual is a difference of coordinates of 10^2 pixels, so
// near convergence the gradients are sums that cancel, and a point near the
// image plane scales its Jacobian by 1/z^2; in float32 both carry the pose
// chain's round-off, amplified (the plain float32 version's too:
// chip_smoke.py holds both to a float64 evaluation).
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

// The row's pose tables into shared memory (cp.async, 4 bytes a copy: the
// tables need not be 16-byte aligned); every thread of the block calls it.
__device__ void load_poses(const float* q, const float* t, const bool* constant, int W,
                           Poses& P) {
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < 4; ++j) __pipeline_memcpy_async(&P.q[i][j], q + 4 * i + j, 4);
#pragma unroll
    for (int j = 0; j < 3; ++j) __pipeline_memcpy_async(&P.t[i][j], t + 3 * i + j, 4);
    P.constant[i] = constant != nullptr && constant[i];
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Index of entry (i, j), i <= j, of a symmetric 6x6 block stored as its 21
// upper entries.
__host__ __device__ constexpr int sym(int i, int j) { return i * (11 - i) / 2 + j; }

// Sum v over the warp's lanes: a butterfly of xor shuffles.  Every lane ends
// with the totals, bit-equal in all lanes (each level adds the same two
// values in every lane that holds them), in an order fixed by lane indices.
template <int N, class T>
__device__ __forceinline__ void warp_sum(T (&v)[N]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(kFull, v[n], m);
  }
}

// Sum v over the block's threads: the warp sums, then the warps' partials
// added in warp order (`red` holds kWarps x N floats); the N totals land in
// `tot`, which every thread may read after the call.
template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* tot) {
  warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if ((n & 31) == lane) red[warp * N + n] = v[n];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Unordered pose pair p of a W-row window, in row-major order of x < y.
__device__ __forceinline__ void pair_of(int p, int W, int& x, int& y) {
  x = 0;
  while (p >= W - 1 - x) {
    p -= W - 1 - x;
    ++x;
  }
  y = x + 1 + p;
}

__host__ __device__ int pair_blocks(int W) {
  return (W * (W - 1) / 2 + kWarps - 1) / kWarps;
}

// ---------------------------------------------------------------------------
// K6a: the evaluation (one thread per slot)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__global__ void __launch_bounds__(kEvalThreads)
ba_linearize_eval_kernel(const float* __restrict__ q, const float* __restrict__ t,
                         const float* __restrict__ lam_v, const bool* __restrict__ valid,
                         const float* __restrict__ px, const float* __restrict__ mxy,
                         const long long* __restrict__ first,
                         const long long* __restrict__ a_idx, const bool* __restrict__ constant,
                         int W, int K, Cam c, float* __restrict__ u, Scratch sc) {
  __shared__ Poses P;
  const int s = blockIdx.y;
  const long long WK = static_cast<long long>(W) * K;
  const LinRow in{lam_v + s * WK, valid + s * WK, px + 2 * s * WK, mxy + 2 * s * WK,
                  first + s * WK, a_idx + s * WK, W, K};
  load_poses(q + 4LL * s * W, t + 3LL * s * W, constant + static_cast<long long>(s) * W, W, P);
  const int i = blockIdx.x * kEvalThreads + threadIdx.x;
  if (i >= WK) return;
  const long long gi = s * WK + i;
  float* uk = u + 6 * gi;
  unsigned char* ak = sc.akey + s * sc.ks + i;
  unsigned char* fk = sc.fkey + s * sc.ks + i;
  // the virtual landmark's row whatever the slot's validity: after the
  // first prune a landmark's first row may be invalid and its others not
  *fk = static_cast<unsigned char>(in.first[i]);
  if (!in.valid[i]) {
#pragma unroll
    for (int j = 0; j < 6; ++j) uk[j] = 0.0f;
    *ak = static_cast<unsigned char>(kNone);
    return;
  }
  Obs ob;
  linearise(P, c, in, i / K, i % K, ob);
  // the record: Jo[2][6], Ja[2][6], wt, r[2] (27 floats of 32), as 7 float4
  float rec[28];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      rec[6 * r + j] = ob.Jo[r][j];
      rec[12 + 6 * r + j] = ob.Ja[r][j];
    }
  }
  rec[24] = ob.wt;
  rec[25] = ob.r[0];
  rec[26] = ob.r[1];
  rec[27] = 0.0f;
  float* ra = sc.rec_a + kRecA * gi;
#pragma unroll
  for (int m = 0; m < 7; ++m) store4(ra + 4 * m, rec[4 * m], rec[4 * m + 1], rec[4 * m + 2], rec[4 * m + 3]);
  // its depth block's share: wt Jl^T Ja, wt Jl^T Jl, wt Jl^T r
  const float l0 = ob.wt * ob.Jl[0], l1 = ob.wt * ob.Jl[1];
  float* rb = sc.rec_b + kRecB * gi;
#pragma unroll
  for (int j = 0; j < 6; ++j) rb[j] = l0 * ob.Ja[0][j] + l1 * ob.Ja[1][j];
  rb[6] = ob.wt * (ob.Jl[0] * ob.Jl[0] + ob.Jl[1] * ob.Jl[1]);
  rb[7] = l0 * ob.r[0] + l1 * ob.r[1];
#pragma unroll
  for (int j = 0; j < 6; ++j) uk[j] = l0 * ob.Jo[0][j] + l1 * ob.Jo[1][j];
  *ak = static_cast<unsigned char>(in.a_idx[i]);
}

// ---------------------------------------------------------------------------
// K6a: the reduction (blocks of three kinds per row)
// ---------------------------------------------------------------------------

struct Rec {
  float Jo[2][6];
  float Ja[2][6];
  float wt, r[2];
};

__device__ __forceinline__ void load_rec(const float* p, Rec& o) {
  const float4* v = reinterpret_cast<const float4*>(p);
  float a[28];
#pragma unroll
  for (int m = 0; m < 7; ++m) {
    const float4 x = v[m];
    a[4 * m] = x.x;
    a[4 * m + 1] = x.y;
    a[4 * m + 2] = x.z;
    a[4 * m + 3] = x.w;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      o.Jo[r][j] = a[6 * r + j];
      o.Ja[r][j] = a[12 + 6 * r + j];
    }
  }
  o.wt = a[24];
  o.r[0] = a[25];
  o.r[1] = a[26];
}

// v[sym] += wt A^T B + wt B^T A over the upper entries (A == B: wt A^T A
// counted once), g += wt A^T r.
__device__ __forceinline__ void add_sym(float* v, const Rec& o, const float (&A)[2][6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = o.wt * A[0][i], w1 = o.wt * A[1][i];
#pragma unroll
    for (int j = i; j < 6; ++j) v[sym(i, j)] += w0 * A[0][j] + w1 * A[1][j];
    v[21 + i] += w0 * o.r[0] + w1 * o.r[1];
  }
}

// Diagonal block x and g_c[x]: H_oo[x] (row x), H_aa[x] and the anchor part
// of g_c (observations anchored at x, any row), H_oa[x, x] + its transpose.
__device__ void lin_diag(int x, int W, int K, const float* rec_a, const unsigned char* keys,
                         float* H, float* g_c, float* red, float* tot) {
  float v[kSym];
#pragma unroll
  for (int n = 0; n < kSym; ++n) v[n] = 0.0f;
  const int WK = W * K, lo = x * K, hi = lo + K;
  const int n_words = (WK + 3) / 4;
  const unsigned* words = reinterpret_cast<const unsigned*>(keys);
  for (int j = threadIdx.x; j < n_words; j += kThreads) {
    const unsigned word = words[j];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * j + b;
      const unsigned a = (word >> (8 * b)) & 0xFFu;
      const bool obs = i >= lo && i < hi && a != kNone;
      const bool anc = a == static_cast<unsigned>(x) && i < WK;
      if (!obs && !anc) continue;
      Rec o;
      load_rec(rec_a + static_cast<long long>(kRecA) * i, o);
      if (obs) add_sym(v, o, o.Jo);
      if (anc) add_sym(v, o, o.Ja);
      if (obs && anc) {
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const float w0 = o.wt * o.Jo[0][p], w1 = o.wt * o.Jo[1][p];
          const float z0 = o.wt * o.Ja[0][p], z1 = o.wt * o.Ja[1][p];
#pragma unroll
          for (int m = p; m < 6; ++m) {
            v[sym(p, m)] += (w0 * o.Ja[0][m] + w1 * o.Ja[1][m])
                            + (z0 * o.Jo[0][m] + z1 * o.Jo[1][m]);
          }
        }
      }
    }
  }
  block_sum(v, red, tot);
  const int C = 6 * W, tid = threadIdx.x;
  if (tid < 36) {
    const int i = tid / 6, j = tid % 6;
    H[(6 * x + i) * C + 6 * x + j] = tot[i <= j ? sym(i, j) : sym(j, i)];
  } else if (tid < 42) {
    g_c[6 * x + tid - 36] = tot[21 + tid - 36];
  }
}

// Off-diagonal block (x, y), x < y, and its transpose (y, x): H_oa[x, y]
// from row x's observations anchored at y, plus H_oa[y, x]^T from row y's
// anchored at x.  One warp.
__device__ void lin_pair(int x, int y, int W, int K, const float* rec_a,
                         const unsigned char* keys, float* H) {
  const int lane = threadIdx.x & 31;
  float acc[36];
#pragma unroll
  for (int n = 0; n < 36; ++n) acc[n] = 0.0f;
  bool hit = false;
  const unsigned* words = reinterpret_cast<const unsigned*>(keys);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int lo = (side ? y : x) * K, hi = lo + K;
    const unsigned want = side ? x : y;
    for (int j = lo / 4 + lane; j < (hi + 3) / 4; j += 32) {
      const unsigned word = words[j];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * j + b;
        if (i < lo || i >= hi || ((word >> (8 * b)) & 0xFFu) != want) continue;
        hit = true;
        Rec o;
        load_rec(rec_a + static_cast<long long>(kRecA) * i, o);
        // side 0: wt Jo^T Ja; side 1: (wt Jo^T Ja)^T = wt Ja^T Jo
        const float(&A)[2][6] = side ? o.Ja : o.Jo;
        const float(&B)[2][6] = side ? o.Jo : o.Ja;
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const float w0 = o.wt * A[0][p], w1 = o.wt * A[1][p];
#pragma unroll
          for (int m = 0; m < 6; ++m) acc[6 * p + m] += w0 * B[0][m] + w1 * B[1][m];
        }
      }
    }
  }
  // a pair that no observation couples is zero: skip its sum
  if (__any_sync(kFull, hit)) warp_sum(acc);
  const int C = 6 * W;
#pragma unroll
  for (int n = 0; n < 36; ++n) {
    if ((n & 31) == lane) {
      const int p = n / 6, m = n % 6;
      H[(6 * x + p) * C + 6 * y + m] = acc[n];
      H[(6 * y + m) * C + 6 * x + p] = acc[n];
    }
  }
}

// Virtual landmark (g, k): the sums of its members' depth-block shares (its
// column's usable slots from row g on whose virtual landmark is g): va, D,
// g_l; zero where (g, k) is no virtual landmark.  Slot (g, k) itself need
// not be usable: the pruning drops slots, never changes `first`.
__device__ void lin_members(int idx, int W, int K, const float* rec_b,
                            const unsigned char* fkey, const unsigned char* akey, float* va,
                            float* D, float* g_l) {
  const int g = idx / K, k = idx % K;
  float v[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) v[n] = 0.0f;
  if (fkey[idx] == static_cast<unsigned>(g)) {
#pragma unroll 4
    for (int w = g; w < W; ++w) {
      const int i = w * K + k;
      if (fkey[i] != static_cast<unsigned>(g) || akey[i] == kNone) continue;
      const float4* b = reinterpret_cast<const float4*>(rec_b + static_cast<long long>(kRecB) * i);
      const float4 lo = b[0], hi = b[1];
      v[0] += lo.x;
      v[1] += lo.y;
      v[2] += lo.z;
      v[3] += lo.w;
      v[4] += hi.x;
      v[5] += hi.y;
      v[6] += hi.z;
      v[7] += hi.w;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) va[6 * idx + j] = v[j];
  D[idx] = v[6];
  g_l[idx] = v[7];
}

__global__ void __launch_bounds__(kThreads)
ba_linearize_reduce_kernel(int W, int K, Scratch sc, float* __restrict__ H,
                           float* __restrict__ g_c, float* __restrict__ va,
                           float* __restrict__ D, float* __restrict__ g_l) {
  __shared__ float red[kWarps * kSym];
  __shared__ float tot[kSym];
  const int s = blockIdx.y, b = blockIdx.x;
  const long long WK = static_cast<long long>(W) * K, C = 6LL * W;
  const float* rec_a = sc.rec_a + s * WK * kRecA;
  const unsigned char* akey = sc.akey + s * sc.ks;
  const int n_pairs = pair_blocks(W);
  if (b < W) {
    lin_diag(b, W, K, rec_a, akey, H + s * C * C, g_c + s * C, red, tot);
  } else if (b < W + n_pairs) {
    const int p = (b - W) * kWarps + (threadIdx.x >> 5);
    if (p >= W * (W - 1) / 2) return;
    int x, y;
    pair_of(p, W, x, y);
    lin_pair(x, y, W, K, rec_a, akey, H + s * C * C);
  } else {
    const int idx = (b - W - n_pairs) * kThreads + threadIdx.x;
    if (idx >= WK) return;
    lin_members(idx, W, K, sc.rec_b + s * WK * kRecB, sc.fkey + s * sc.ks, akey,
                va + 6 * s * WK, D + s * WK, g_l + s * WK);
  }
}

// ---------------------------------------------------------------------------
// K6a: the residual pass (one thread per slot, many blocks per row)
// ---------------------------------------------------------------------------

// Sum v over the block's threads (warp sums, then the warps' partials in
// warp order); thread 0 gets the total.
__device__ double block_sum_d(double v, double* red) {
  double a[1] = {v};
  warp_sum(a);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a[0];
  __syncthreads();
  double s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// One slot of the residual pass: r^2, z and the observation's inverse
// depth in the plain pass's float32 arithmetic (the pruning's inputs, equal
// to the plain pass's on the card), and its Huber cost if it is usable: the
// same function evaluated in float64, which the launch sums in float64.  LM
// accepts a step when this cost falls.  Near convergence a step lowers a
// cost of ~10^3 by ~10^-5, under a float32 ulp of the total, and a float32
// cost of a few thousand slots carries more round-off than that: accepting
// on it stalls (equal costs reject every step) or walks along the noise,
// ~1e-4 from the optimum in t on W = 30 windows.
__device__ double residual_slot(const Poses& P, const Cam& c, const LinRow& in, int i,
                                float* r2_out, float* z_out, float* lam_out) {
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
  if (!ok) return 0.0;
  Geometry<double> Rd;
  residual<double>(P.q[w], P.q[a], P.t[w], P.t[a], c, lam, mx, my, px, py, Rd);
  const double delta = c.delta;
  const double e2 = Rd.r[0] * Rd.r[0] + Rd.r[1] * Rd.r[1];
  const double rn = sqrt(e2 < 1e-12 ? 1e-12 : e2);
  return rn <= delta ? e2 : 2.0 * delta * rn - delta * delta;
}

__global__ void __launch_bounds__(kThreads)
ba_residuals_kernel(const float* __restrict__ q, const float* __restrict__ t,
                    const float* __restrict__ lam_v, const bool* __restrict__ valid,
                    const float* __restrict__ px, const float* __restrict__ mxy,
                    const long long* __restrict__ first, const long long* __restrict__ a_idx,
                    int W, int K, Cam c, float* __restrict__ r2, float* __restrict__ z,
                    float* __restrict__ lam_obs, double* __restrict__ partial) {
  __shared__ Poses P;
  __shared__ double red[kWarps];
  const int s = blockIdx.y;
  const long long WK = static_cast<long long>(W) * K;
  const LinRow in{lam_v + s * WK, valid + s * WK, px + 2 * s * WK, mxy + 2 * s * WK,
                  first + s * WK, a_idx + s * WK, W, K};
  load_poses(q + 4LL * s * W, t + 3LL * s * W, nullptr, W, P);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const double cost = i < WK ? residual_slot(P, c, in, i, r2 + s * WK, z + s * WK,
                                             lam_obs + s * WK)
                             : 0.0;
  const double total = block_sum_d(cost, red);
  if (threadIdx.x == 0) partial[static_cast<long long>(s) * gridDim.x + blockIdx.x] = total;
}

// A row's cost: its blocks' partials added in block order (one warp a row).
__global__ void __launch_bounds__(32)
ba_residuals_sum_kernel(const double* __restrict__ partial, int n_blocks,
                        double* __restrict__ cost) {
  const int s = blockIdx.x;
  double a[1] = {0.0};
  for (int b = threadIdx.x; b < n_blocks; b += 32) {
    a[0] += partial[static_cast<long long>(s) * n_blocks + b];
  }
  warp_sum(a);
  if (threadIdx.x == 0) cost[s] = a[0];
}

// ---------------------------------------------------------------------------
// K6b: the Schur complement (a block per diagonal block, a warp per pair)
// ---------------------------------------------------------------------------

struct SchurRow {
  const float* D;             // [W, K]
  const float* u;             // [W, K, 6]
  const float* va;            // [W, K, 6]
  const long long* first;     // [W, K]
  const long long* a_idx;     // [W, K]
  const float* g_l;           // [W, K]
  int W, K;
  float damp;                 // 1 + lambda_LM
  // D^-1 of virtual landmark (g, k): 0 unless it is live (`lm_active`)
  __device__ float inv_d(int g, int k) const {
    const int i = g * K + k;
    const float d = D[i];
    return static_cast<int>(first[i]) == g && d > 1e-12f ? 1.0f / (d * damp) : 0.0f;
  }
};

// Diagonal block x: T_uu[x, x] + T_uv[x, x] + its transpose and row x's
// share of g_s over the K columns, then T_vv[x] and the anchor's share of
// g_s over every virtual landmark anchored at x.
__device__ void schur_diag(int x, const SchurRow& R, float (&v)[kSym]) {
  const int W = R.W, K = R.K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int gx = static_cast<int>(R.first[x * K + k]);
    if (gx >= W) continue;
    const float ix = R.inv_d(gx, k);
    if (ix == 0.0f) continue;
    const float* ux = R.u + 6 * (x * K + k);
    const bool anchored = static_cast<int>(R.a_idx[gx * K + k]) == x;
    const float* vv = R.va + 6 * (gx * K + k);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        float add = ix * ux[i] * ux[j];
        if (anchored) add += ix * ux[i] * vv[j] + ix * vv[i] * ux[j];
        v[sym(i, j)] += add;
      }
    }
    const float gld = R.g_l[gx * K + k] * ix;
#pragma unroll
    for (int i = 0; i < 6; ++i) v[21 + i] += gld * ux[i];
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < W * K; i += kThreads) {
    if (static_cast<int>(R.a_idx[i]) != x) continue;
    const float id = R.inv_d(i / K, i % K);
    if (id == 0.0f) continue;
    const float* vv = R.va + 6 * i;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) v[sym(a, b)] += id * vv[a] * vv[b];
    }
    const float gld = R.g_l[i] * id;
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] += gld * vv[a];
  }
}

// Block (x, y), x < y, of H_cl^T D^-1 H_cl: T_uu (one virtual landmark in
// rows x and y), T_uv[x, y] (row x's landmark anchored at y) and T_uv[y,
// x]^T.  One warp; the lanes take the K columns.
__device__ bool schur_pair(int x, int y, const SchurRow& R, float (&acc)[36]) {
  const int W = R.W, K = R.K;
  bool hit = false;
  for (int k = threadIdx.x & 31; k < K; k += 32) {
    const int gx = static_cast<int>(R.first[x * K + k]);
    const int gy = static_cast<int>(R.first[y * K + k]);
    const float* ux = R.u + 6 * (x * K + k);
    const float* uy = R.u + 6 * (y * K + k);
    if (gx < W) {
      const float ix = R.inv_d(gx, k);
      if (gx == gy && ix != 0.0f) {
        hit = true;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += ix * ux[i] * uy[j];
        }
      }
      if (static_cast<int>(R.a_idx[gx * K + k]) == y && ix != 0.0f) {
        hit = true;
        const float* vv = R.va + 6 * (gx * K + k);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += ix * ux[i] * vv[j];
        }
      }
    }
    if (gy < W && static_cast<int>(R.a_idx[gy * K + k]) == x) {
      const float iy = R.inv_d(gy, k);
      if (iy != 0.0f) {
        hit = true;
        const float* vv = R.va + 6 * (gy * K + k);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[6 * i + j] += iy * vv[i] * uy[j];
        }
      }
    }
  }
  return hit;
}

__global__ void __launch_bounds__(kThreads)
ba_schur_kernel(const float* __restrict__ D, const float* __restrict__ u,
                const float* __restrict__ va, const long long* __restrict__ first,
                const long long* __restrict__ a_idx, const float* __restrict__ H,
                const float* __restrict__ g_c, const float* __restrict__ g_l,
                const float* __restrict__ lam_lm, const bool* __restrict__ free_pose, int W,
                int K, float* __restrict__ S, float* __restrict__ g_s) {
  __shared__ float red[kWarps * kSym];
  __shared__ float tot[kSym];
  const int s = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const long long WK = static_cast<long long>(W) * K, C = 6LL * W;
  const float lam = lam_lm[s];
  const SchurRow R{D + s * WK, u + 6 * s * WK, va + 6 * s * WK, first + s * WK,
                   a_idx + s * WK, g_l + s * WK, W, K, 1.0f + lam};
  H += s * C * C;
  S += s * C * C;
  free_pose += static_cast<long long>(s) * W;
  if (b < W) {
    const int x = b;
    float v[kSym];
#pragma unroll
    for (int n = 0; n < kSym; ++n) v[n] = 0.0f;
    schur_diag(x, R, v);
    block_sum(v, red, tot);
    if (tid < 36) {
      const int i = tid / 6, j = tid % 6;
      const long long at = (6 * x + i) * C + 6 * x + j;
      float h = H[at];
      if (i == j) h += lam * (h < 1e-8f ? 1e-8f : h);
      float out = free_pose[x] ? h - tot[i <= j ? sym(i, j) : sym(j, i)] : 0.0f;
      if (i == j) out += free_pose[x] ? 1e-9f : 1.0f;
      S[at] = out;
    } else if (tid < 42) {
      const int i = tid - 36;
      g_s[s * C + 6 * x + i] = free_pose[x] ? g_c[s * C + 6 * x + i] - tot[21 + i] : 0.0f;
    }
    return;
  }
  const int p = (b - W) * kWarps + (tid >> 5);
  if (p >= W * (W - 1) / 2) return;
  int x, y;
  pair_of(p, W, x, y);
  float acc[36];
#pragma unroll
  for (int n = 0; n < 36; ++n) acc[n] = 0.0f;
  // a pair that no live landmark couples subtracts nothing: skip its sum
  if (__any_sync(kFull, schur_pair(x, y, R, acc))) warp_sum(acc);
  const bool free_pair = free_pose[x] && free_pose[y];
  const int lane = tid & 31;
#pragma unroll
  for (int n = 0; n < 36; ++n) {
    if ((n & 31) == lane) {
      const int i = n / 6, j = n % 6;
      const long long at = (6 * x + i) * C + 6 * y + j;
      const long long ta = (6 * y + j) * C + 6 * x + i;
      S[at] = free_pair ? H[at] - acc[n] : 0.0f;
      S[ta] = free_pair ? H[ta] - acc[n] : 0.0f;
    }
  }
}

bool bad_dims(int S, int W, int K) {
  return S < 1 || S > 65535 || W < 1 || W > kWMax || K < 1
         || static_cast<long long>(W) * K > (1LL << 24);
}

}  // namespace

extern "C" long long ba_linearize_scratch_bytes(int S, int W, int K) {
  return scratch_bytes(S, W, K);
}

extern "C" int ba_linearize_launch(const float* q, const float* t, const float* lam_v,
                                   const bool* valid, const float* px, const float* mxy,
                                   const long long* first, const long long* a_idx,
                                   const bool* constant, int S, int W, int K, float fx,
                                   float fy, float cx, float cy, float delta, float* H,
                                   float* g_c, float* u, float* va, float* D, float* g_l,
                                   void* scratch, void* stream) {
  if (bad_dims(S, W, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Cam c{fx, fy, cx, cy, delta};
  const Scratch sc = carve(scratch, S, W, K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int WK = W * K;
  const dim3 eval((WK + kEvalThreads - 1) / kEvalThreads, S);
  ba_linearize_eval_kernel<<<eval, kEvalThreads, 0, st>>>(q, t, lam_v, valid, px, mxy, first,
                                                          a_idx, constant, W, K, c, u, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 reduce(W + pair_blocks(W) + (WK + kThreads - 1) / kThreads, S);
  ba_linearize_reduce_kernel<<<reduce, kThreads, 0, st>>>(W, K, sc, H, g_c, va, D, g_l);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ba_residuals_scratch_bytes(int S, int W, int K) {
  return 8LL * S * ((static_cast<long long>(W) * K + kThreads - 1) / kThreads);
}

extern "C" int ba_residuals_launch(const float* q, const float* t, const float* lam_v,
                                   const bool* valid, const float* px, const float* mxy,
                                   const long long* first, const long long* a_idx, int S,
                                   int W, int K, float fx, float fy, float cx, float cy,
                                   float delta, double* cost, float* r2, float* z,
                                   float* lam_obs, void* scratch, void* stream) {
  if (bad_dims(S, W, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Cam c{fx, fy, cx, cy, delta};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (W * K + kThreads - 1) / kThreads;
  double* partial = static_cast<double*>(scratch);
  ba_residuals_kernel<<<dim3(n_blocks, S), kThreads, 0, st>>>(
      q, t, lam_v, valid, px, mxy, first, a_idx, W, K, c, r2, z, lam_obs, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ba_residuals_sum_kernel<<<S, 32, 0, st>>>(partial, n_blocks, cost);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ba_schur_launch(const float* D, const float* u, const float* va,
                               const long long* first, const long long* a_idx, const float* H,
                               const float* g_c, const float* g_l, const float* lam_lm,
                               const bool* free_pose, int S, int W, int K, float* S_out,
                               float* g_s, void* stream) {
  if (bad_dims(S, W, K)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(W + pair_blocks(W), S);
  ba_schur_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free_pose, W, K, S_out, g_s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ba_kernels_limits(int* w_max, int* threads) {
  *w_max = kWMax;
  *threads = kThreads;
  return 0;
}
