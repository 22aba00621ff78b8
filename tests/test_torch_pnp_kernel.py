"""Motion-only PnP's kernel K9 (csrc/pnp_kernel.cu, solvers/pnp_kernel.py):
its CUDA source run on the CPU through tools/cpu_cuda_shim.h against the
plain version, its float64 evaluation and the JAX package's
``pnp_refine``: the prune carried by the linearisations, any N (0, 1, 33,
past the points a thread keeps in registers), each block size; the shim's
warp intrinsics against CUDA's semantics; and, without building anything, the custom op's fake shapes
and batching rule, the CPU path's independence of the library and the
launcher's argument checks.  tests/test_torch_pnp_kernel_card.py holds
the kernel to its plain version on a card.

Bars (chip_smoke.py phase 2c's): the pose's t within 1e-5 of the float64
evaluation's largest |t|, q within 1e-6; inlier flags equal to float64's
but for points whose float64 chi^2 lies within 1e-4 (relative) of the
threshold; against the JAX package, tests/test_torch_solvers.py's 1e-4."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.solvers import pnp as jpnp
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.solvers import pnp, pnp_kernel
import pnp_problems
from pnp_problems import CAM, build_problem, stack, to_f64
from tests.synthetic_scene import add_outliers, observe, random_pose, scene_points
from tests.test_torch_solvers import JCAM, TCAM, _assert_pose, _t, _tse3

T_BAR, Q_BAR, CHI2_NEAR = 1e-5, 1e-6, 1e-4
DELTA = pnp.CHI2_THRESH_2DOF ** 0.5


@pytest.fixture(scope="module")
def k9(tmp_path_factory):
    """tools/rehearse_pnp_kernel.py, and csrc/pnp_kernel.cu built with it
    for the CPU (every CUDA thread a fiber)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "rehearse_pnp_kernel.py"
    spec = importlib.util.spec_from_file_location("rehearse_pnp_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build(str(tmp_path_factory.mktemp("pnp_kernel_cpu")))


def _kernel(k9, problem, **kw):
    """``pnp_refine`` with its CUDA source, on CPU tensors."""
    mod, lib = k9
    with mod.on_cpu(lib):
        return pnp.pnp_refine(problem[0], CAM, *problem[1:], **kw)


def _plain64(problem, **kw):
    p = to_f64(problem)
    return pnp._pnp_refine_plain(p[0], CAM, *p[1:], **kw)


def _rel(got: SE3, ref: SE3):
    """t's distance over the largest |t| of ``ref``, and q's."""
    t = float((got.t.double() - ref.t).abs().max()) / float(ref.t.abs().max())
    return t, float((got.q.double() - ref.q).abs().max())


def _hold_to_float64(res, problem, **kw):
    ref = _plain64(problem, **kw)
    dt, dq = _rel(res.pose, ref.pose)
    assert dt <= T_BAR and dq <= Q_BAR, (dt, dq)
    p = to_f64(problem)
    r, _, _ = pnp._residuals_jacobian(ref.pose, CAM, p[1], p[2])
    chi2 = (r * r).sum(-1)
    near = (chi2 - pnp.CHI2_THRESH_2DOF).abs() <= CHI2_NEAR * pnp.CHI2_THRESH_2DOF
    assert not bool(((res.inliers != ref.inliers) & ~near).any())
    assert int(res.num_inliers) == int(res.inliers.sum())
    assert res.num_inliers.dtype == torch.int64 and res.cost.dtype == torch.float32
    return ref


@pytest.mark.parametrize("n", [130, 192, 352])
@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_cuda_source_on_cpu_matches_float64(k9, n, outliers):
    """K9's source at FAST's, the default's and ACCURATE's widths, with and
    without outliers (points behind the camera and masked slots in every
    problem) against the plain version's float64 evaluation.  Its cost
    (the accept test's) is evaluated and summed in float64: with a float32
    cost a near tie of the accept test flipped at N = 352 with outliers, and
    the pose stood 2.6e-5 from float64 in t."""
    problem, _ = build_problem(np.random.default_rng(n), N=n, outlier_frac=outliers,
                               behind=6 if outliers else 2)
    res = _kernel(k9, problem, iters=4, huber_delta=DELTA)
    _hold_to_float64(res, problem, iters=4, huber_delta=DELTA)
    assert bool(torch.isfinite(res.cost))


@pytest.mark.parametrize("outliers", [0.0, 0.25])
def test_cuda_source_on_cpu_matches_jax(k9, rng, outliers):
    """K9's source against the JAX package's ``pnp_refine`` on
    tests/test_torch_solvers.py's problem, at its bars."""
    pose = random_pose(rng)
    P = scene_points(rng, 96)
    px, _, _ = observe(pose, JCAM, P, noise_px=0.2, rng=rng)
    if outliers:
        px, _ = add_outliers(rng, px, outliers)
    pose0 = pose.retract(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))
    valid = np.ones(96, bool)
    valid[::7] = False
    j = jpnp.pnp_refine(pose0, JCAM, P, px, jnp.asarray(valid), iters=4)
    mod, lib = k9
    with mod.on_cpu(lib):
        t = pnp.pnp_refine(_tse3(pose0), TCAM, _t(P), _t(px), _t(valid), iters=4)
    _assert_pose(t.pose, j.pose)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))


def test_rows_in_one_launch_equal_rows_alone(k9):
    """Four rows under ``torch.func.vmap`` (one of them all masked): one
    launch, each row bit-equal to its launch alone, the same bits twice;
    the all-masked row keeps its start pose (normalised) with no inlier
    and cost 0, as the plain version does."""
    problems = [build_problem(np.random.default_rng(40 + i), N=192, outlier_frac=0.3,
                              behind=4)[0] for i in range(4)]
    problems[1] = problems[1][:3] + (torch.zeros_like(problems[1][3]),)
    x = stack(problems)
    mod, lib = k9

    def row(q, t, pts, obs, valid):
        r = pnp.pnp_refine(SE3(q, t), CAM, pts, obs, valid, iters=4)
        return r.pose.q, r.pose.t, r.inliers, r.num_inliers, r.cost

    with mod.on_cpu(lib):
        pnp.pnp_refine.launches = 0
        got = torch.func.vmap(row)(*x)
        assert pnp.pnp_refine.launches == 1
        again = torch.func.vmap(row)(*x)
        alone = [row(*(c[i] for c in x)) for i in range(4)]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, one in enumerate(alone):
        assert all(torch.equal(g[i], a) for g, a in zip(got, one)), i
    plain = pnp._pnp_refine_plain(problems[1][0], CAM, *problems[1][1:], iters=4)
    torch.testing.assert_close(got[0][1], plain.pose.q, rtol=0, atol=2.4e-7)
    assert torch.equal(got[1][1], plain.pose.t) and torch.equal(got[1][1], problems[1][0].t)
    assert int(got[3][1]) == 0 and not bool(got[2][1].any()) and float(got[4][1]) == 0.0


def test_damping_clip_reaches_the_off_diagonal(k9):
    """The damping ``lam * clamp_min(diag(diag(H)), 1e-8)`` clamps the
    whole diagonal matrix, so every off-diagonal entry of H gets lam * 1e-8.
    Two points on the optical axis leave tz and rz unobserved (H's rows 2
    and 5 zero): only those entries couple them to the rest, so the plain
    version's step moves tz and rz where textbook damping would not.  K9 follows
    the plain version (one Huber step, no L2 pass), and the textbook step
    stands far outside the bar."""
    problem = (SE3.identity(), torch.tensor([[0.0, 0.0, 4.0], [0.0, 0.0, 7.0]]),
               torch.tensor([[330.0, 245.0], [326.0, 236.0]]), torch.ones(2, dtype=torch.bool))
    kw = dict(iters=1, huber_delta=DELTA, refine_l2=False)
    res = _kernel(k9, problem, **kw)
    ref = _hold_to_float64(res, problem, **kw)
    # the textbook step from the same normal equations, in float64
    pose0, pts, obs, valid = to_f64(problem)
    r, J, _ = pnp._residuals_jacobian(pose0, CAM, pts, obs)
    w = pnp._robust_weights((r * r).sum(-1), DELTA)
    H = torch.einsum("n,nki,nkj->ij", w, J, J)
    g = torch.einsum("n,nki,nk->i", w, J, r)
    assert float(H[2].abs().max()) == 0.0 and float(H[5].abs().max()) == 0.0
    eye = torch.eye(6, dtype=torch.float64)
    x = pnp._chol_solve6(H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-9 * eye, g)
    assert float(x[2]) == 0.0 and float(x[5]) == 0.0
    text = pose0.retract(-x)
    far = 50 * T_BAR * float(ref.pose.t.abs().max())
    assert float((res.pose.t.double() - text.t).abs().max()) > far


def test_masked_non_finite_slot_poisons_the_sums(k9):
    """A masked slot whose point is not finite: the plain version multiplies
    its terms by a zero weight, which gives NaN, so every trial's cost is
    NaN and no step is accepted; K9 does the same multiply: the start pose,
    normalised, and a NaN cost, the flags from the start pose."""
    problem, _ = build_problem(np.random.default_rng(6), N=64, masked_frac=0.0)
    pts, valid = problem[1].clone(), problem[3].clone()
    pts[3], valid[3] = float("nan"), False
    problem = (problem[0], pts, problem[2], valid)
    res = _kernel(k9, problem, iters=4)
    plain = pnp._pnp_refine_plain(problem[0], CAM, *problem[1:], iters=4)
    assert torch.equal(res.pose.t, problem[0].t) and torch.equal(plain.pose.t, problem[0].t)
    torch.testing.assert_close(res.pose.q, plain.pose.q, rtol=0, atol=2.4e-7)
    assert bool(torch.isnan(res.cost)) and bool(torch.isnan(plain.cost))
    assert torch.equal(res.inliers, plain.inliers)


def test_prune_takes_the_raw_depth(k9):
    """Points behind the camera whose mirror images project onto their
    observations: small reprojection errors, but z < 0, so the prune (after
    the Huber pass and for the final flags) drops them on both sides."""
    problem, _ = build_problem(np.random.default_rng(9), N=192, behind=20, masked_frac=0.0)
    res = _kernel(k9, problem, iters=4)
    ref = _hold_to_float64(res, problem, iters=4)
    p = to_f64(problem)
    _, _, z = pnp._residuals_jacobian(ref.pose, CAM, p[1], p[2])
    behind = z < 0
    assert int(behind.sum()) == 20
    assert not bool(res.inliers[behind].any()) and bool(res.inliers[~behind].all())


@pytest.mark.parametrize("n_valid", [0, 1, 3, 5])
def test_degenerate_rows(k9, n_valid):
    """Fewer than 6 valid points: the damped system stays solvable and the
    pose finite, at the bars; none valid: the system is lam*1e-8 + 1e-9 I
    against g = 0, no step is accepted (0 < 0 is false) and the pose is the
    start pose, normalised."""
    problem, _ = build_problem(np.random.default_rng(5), N=192, masked_frac=0.0)
    valid = torch.zeros(192, dtype=torch.bool)
    valid[:n_valid] = True
    problem = problem[:3] + (valid,)
    res = _kernel(k9, problem, iters=4)
    assert bool(torch.isfinite(res.pose.t).all() & torch.isfinite(res.pose.q).all())
    if n_valid:
        _hold_to_float64(res, problem, iters=4)
    else:
        assert torch.equal(res.pose.t, problem[0].t)
        torch.testing.assert_close(res.pose.q, problem[0].normalize().q, rtol=0, atol=2.4e-7)
        assert int(res.num_inliers) == 0 and float(res.cost) == 0.0


def _prune64(pose, problem):
    """A float64 prune at ``pose``: (flags, chi^2, points within 1e-5
    (relative) of the chi^2 threshold)."""
    _, pts, obs, valid = to_f64(problem)
    p = SE3(pose.q.double(), pose.t.double())
    r, _, z = pnp._residuals_jacobian(p, CAM, pts, obs)
    chi2 = (r * r).sum(-1)
    near = (chi2 - pnp.CHI2_THRESH_2DOF).abs() <= 1e-5 * pnp.CHI2_THRESH_2DOF
    return valid & (chi2 <= pnp.CHI2_THRESH_2DOF) & (z > 0), chi2, near


@pytest.mark.parametrize("refine_l2", [True, False])
def test_carried_prune_equals_a_float64_prune(k9, refine_l2):
    """The flags, their count and the cost that K9 carries from its
    linearisations (no prune pass) equal a float64 prune at the pose it
    reached: without the L2 pass the cost is the inliers' chi^2 sum at
    pose1; with it, the L2 cost at pose2 over the flags at pose1 (pose1 and
    its flags from the same problem without the L2 pass)."""
    problem, _ = build_problem(np.random.default_rng(77), N=192, outlier_frac=0.3, behind=6)
    res = _kernel(k9, problem, iters=4, refine_l2=refine_l2)
    flags, chi2, near = _prune64(res.pose, problem)
    assert not bool(((res.inliers != flags) & ~near).any())
    assert int(res.num_inliers) == int(res.inliers.sum())
    assert abs(int(res.num_inliers) - int(flags.sum())) <= int(near.sum())
    if refine_l2:
        pose1 = _kernel(k9, problem, iters=4, refine_l2=False)
        want = float((chi2 * pose1.inliers).sum())
    else:
        want = float((chi2 * res.inliers).sum())
    assert abs(float(res.cost) - want) <= 1e-5 * want
    _hold_to_float64(res, problem, iters=4, refine_l2=refine_l2)


@pytest.mark.parametrize("n", [0, 1, 32, 33, pnp_kernel.REG_POINTS * pnp_kernel.BLOCK_THREADS + 100])
def test_any_n(k9, n):
    """N = 0 (nothing to solve: the start pose, normalised, no inlier, cost
    0), one point, 32 (one full warp), 33 (a second warp of one point), and
    more points a row
    than a block's threads keep as register bits (their flags in the spill
    planes): at the bars of float64 wherever six points are valid, the
    same bits twice."""
    problem, _ = build_problem(np.random.default_rng(500 + n), N=n, outlier_frac=0.2,
                               behind=2 if n > 10 else 0)
    res = _kernel(k9, problem, iters=4)
    again = _kernel(k9, problem, iters=4)
    for a, b in ((res.pose.q, again.pose.q), (res.pose.t, again.pose.t),
                 (res.inliers, again.inliers), (res.cost, again.cost)):
        assert torch.equal(a, b)
    assert tuple(res.inliers.shape) == (n,)
    assert bool(torch.isfinite(res.pose.t).all() & torch.isfinite(res.pose.q).all())
    if n == 0:
        assert torch.equal(res.pose.t, problem[0].t)
        torch.testing.assert_close(res.pose.q, problem[0].normalize().q, rtol=0, atol=2.4e-7)
        assert int(res.num_inliers) == 0 and float(res.cost) == 0.0
    elif int(problem[3].sum()) >= 6:
        _hold_to_float64(res, problem, iters=4)
    if n > pnp_kernel.REG_POINTS * pnp_kernel.BLOCK_THREADS:
        flags, _, near = _prune64(res.pose, problem)
        spilled = torch.arange(n) >= pnp_kernel.REG_POINTS * pnp_kernel.BLOCK_THREADS
        assert not bool(((res.inliers != flags) & ~near)[spilled].any())
        assert bool(flags[spilled].any())


@pytest.mark.parametrize("n", [20, 50, 70, 200])
def test_rows_bit_equal_at_every_block_size(k9, n):
    """The block size follows N (a warp per 32 points, 32 to 128 threads):
    at each, three rows under vmap are one launch and each row is bit-equal
    to its launch alone."""
    problems = [build_problem(np.random.default_rng(60 + i), N=n, outlier_frac=0.2)[0]
                for i in range(3)]
    x = stack(problems)
    mod, lib = k9

    def row(q, t, pts, obs, valid):
        r = pnp.pnp_refine(SE3(q, t), CAM, pts, obs, valid, iters=4)
        return r.pose.q, r.pose.t, r.inliers, r.num_inliers, r.cost

    assert pnp_kernel.threads_for(n) == min(128, -(-n // 32) * 32)
    with mod.on_cpu(lib):
        pnp.pnp_refine.launches = 0
        got = torch.func.vmap(row)(*x)
        assert pnp.pnp_refine.launches == 1
        alone = [row(*(c[i] for c in x)) for i in range(3)]
    for i, one in enumerate(alone):
        assert all(torch.equal(g[i], a) for g, a in zip(got, one)), i


@pytest.mark.parametrize("n,refine_l2", [(33, True), (200, False)])
def test_cuda_source_on_cpu_matches_jax_widths(k9, n, refine_l2):
    """K9's source against the JAX package's ``pnp_refine`` on one numpy
    seed at two more widths (33 points: two warps; 200: four), with and without
    the L2 pass, at tests/test_torch_solvers.py's bars."""
    rng = np.random.default_rng(1000 + n)
    pose = random_pose(rng)
    P = scene_points(rng, n)
    px, _, _ = observe(pose, JCAM, P, noise_px=0.2, rng=rng)
    px, _ = add_outliers(rng, px, 0.2)
    pose0 = pose.retract(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))
    valid = np.ones(n, bool)
    valid[::9] = False
    j = jpnp.pnp_refine(pose0, JCAM, P, px, jnp.asarray(valid), iters=4, refine_l2=refine_l2)
    mod, lib = k9
    with mod.on_cpu(lib):
        t = pnp.pnp_refine(_tse3(pose0), TCAM, _t(P), _t(px), _t(valid), iters=4,
                           refine_l2=refine_l2)
    _assert_pose(t.pose, j.pose)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.num_inliers) == int(np.asarray(j.num_inliers))


@pytest.mark.parametrize("threads", [0, 48, pnp_kernel.BLOCK_THREADS + 32])
def test_launch_refuses_other_block_sizes(k9, threads):
    """The C entry takes a multiple of 32 threads up to the kernel's block
    size (its shared scratch is sized for that) and refuses any other
    before it launches."""
    import ctypes
    lib = pnp_kernel.bind(ctypes.CDLL(k9[1]))
    rc = lib.pnp_refine_launch(*[None] * 5, 1, 8, threads, 1.0, 1.0, 0.0, 0.0, 4, DELTA,
                               pnp.CHI2_THRESH_2DOF, 1, None, None)
    assert rc != 0


# ---------------------------------------------------------------------------
# The CPU shim's warp intrinsics (tools/cpu_cuda_shim.h) against CUDA's
# semantics
# ---------------------------------------------------------------------------

SHIM_PROBE = r"""
#include <cuda_runtime.h>

__global__ void shfl_kernel(int* out, int src, int width, unsigned delta) {
  const int lane = threadIdx.x & 31;
  out[threadIdx.x] = __shfl_sync(0xFFFFFFFFu, lane * 10, src, width);
  out[64 + threadIdx.x] = __shfl_down_sync(0xFFFFFFFFu, lane * 10, delta, width);
  const double d = __shfl_xor_sync(0xFFFFFFFFu, lane + 0.5, 3);
  out[128 + threadIdx.x] = static_cast<int>(2.0 * d);
}

__global__ void syncwarp_kernel(int* out, int salt) {
  __shared__ int buf[64];
  const int t = threadIdx.x;
  buf[t] = 3 * t + salt;
  __syncwarp();
  out[t] = buf[(t & ~31) + ((t + 1) & 31)];
}

__global__ void clock_kernel(long long* out) {
  const long long a = clock64();
  const long long b = clock64();
  out[threadIdx.x] = b - a;
}

extern "C" void run_shfl(int* out, int src, int width, unsigned delta) {
  shfl_kernel<<<1, 64>>>(out, src, width, delta);
}
extern "C" void run_syncwarp(int* out, int salt) { syncwarp_kernel<<<1, 64>>>(out, salt); }
extern "C" void run_clock(long long* out) { clock_kernel<<<1, 64>>>(out); }
"""


@pytest.fixture(scope="module")
def shim_probe(k9, tmp_path_factory):
    import ctypes
    mod = k9[0]
    out = tmp_path_factory.mktemp("shim_probe")
    src = out / "shim_probe.cu"
    src.write_text(SHIM_PROBE)
    lib = ctypes.CDLL(mod.cuda_on_cpu.build(str(src), str(out)))
    for fn in (lib.run_shfl, lib.run_syncwarp, lib.run_clock):
        fn.restype = None
    lib.run_shfl.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
    lib.run_syncwarp.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.run_clock.argtypes = [ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("src,width,delta", [(5, 32, 1), (37, 32, 7), (3, 16, 5), (1, 8, 6)])
def test_shim_shfl_sync_and_shfl_down_sync(shim_probe, src, width, delta):
    """``__shfl_sync``: lane l reads lane (l & -width) + src % width;
    ``__shfl_down_sync``: lane l reads lane l + delta within its segment of
    ``width`` lanes, its own value past the segment's end;
    ``__shfl_xor_sync`` of a double: lane l ^ 3's."""
    out = torch.zeros(192, dtype=torch.int32)
    shim_probe.run_shfl(out.data_ptr(), src, width, delta)
    lane = np.arange(64) % 32
    want_bcast = ((lane & -width) + src % width) * 10
    want_down = np.where(lane % width + delta < width, lane + delta, lane) * 10
    np.testing.assert_array_equal(out[:64].numpy(), want_bcast)
    np.testing.assert_array_equal(out[64:128].numpy(), want_down)
    np.testing.assert_array_equal(out[128:].numpy(), 2 * (lane ^ 3) + 1)


def test_shim_syncwarp_orders_the_warps_writes(shim_probe):
    """After ``__syncwarp`` every lane reads what the next lane of its warp
    wrote before it (the shim runs a block's threads one after another:
    without the barrier the read comes first)."""
    out = torch.zeros(64, dtype=torch.int32)
    shim_probe.run_syncwarp(out.data_ptr(), 11)
    t = np.arange(64)
    np.testing.assert_array_equal(out.numpy(), 3 * ((t & ~31) + ((t + 1) & 31)) + 11)


def test_shim_clock64_counts_up(shim_probe):
    """``clock64`` is a stub: a later read is larger (it counts calls, it
    times nothing)."""
    out = torch.zeros(64, dtype=torch.int64)
    shim_probe.run_clock(out.data_ptr())
    assert bool((out > 0).all())


# ---------------------------------------------------------------------------
# Without building anything
# ---------------------------------------------------------------------------

def _op_args(problem):
    pose0, pts, obs, valid = problem
    return (pose0.q[None], pose0.t[None], pts[None], obs[None], valid[None], CAM.fx, CAM.fy,
            CAM.cx, CAM.cy, 4, DELTA, pnp.CHI2_THRESH_2DOF, True)


def test_op_cpu_implementation_is_the_plain_version():
    """The custom op on CPU tensors (S = 1) equals the plain version bit for
    bit, and ``pnp_refine`` on CPU tensors is the plain version."""
    problem, _ = build_problem(np.random.default_rng(1), N=96, outlier_frac=0.2, behind=3)
    plain = pnp._pnp_refine_plain(problem[0], CAM, *problem[1:], iters=4)
    want = (plain.pose.q, plain.pose.t, plain.inliers, plain.num_inliers, plain.cost)
    op = [o[0] for o in pnp._REFINE_OP(*_op_args(problem))]
    main = pnp.pnp_refine(problem[0], CAM, *problem[1:], iters=4)
    main = (main.pose.q, main.pose.t, main.inliers, main.num_inliers, main.cost)
    for res in (op, main):
        assert all(torch.equal(a, b) for a, b in zip(res, want))


def test_op_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    problem, _ = build_problem(np.random.default_rng(2), N=50)
    args = _op_args(problem)
    real = pnp._REFINE_OP(*args)
    mode = FakeTensorMode()
    fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        got = pnp._REFINE_OP(*fake)
    assert [(tuple(x.shape), x.dtype) for x in got] == [(tuple(x.shape), x.dtype) for x in real]


def test_op_vmap_rule_equals_rows():
    """Under ``torch.func.vmap`` the op runs once over the rows (its batching
    rule); the result equals single calls bit for bit, an unbatched
    argument (the start pose shared by every row) included."""
    problems = [build_problem(np.random.default_rng(20 + i), N=64, outlier_frac=0.2)[0]
                for i in range(3)]
    x = stack(problems)

    def row(q, t, pts, obs, valid):
        outs = pnp._REFINE_OP(*(x[None] for x in (q, t, pts, obs, valid)), CAM.fx, CAM.fy,
                              CAM.cx, CAM.cy, 3, DELTA, pnp.CHI2_THRESH_2DOF, True)
        return tuple(o[0] for o in outs)

    got = torch.func.vmap(row)(*x)
    for i in range(3):
        for a, b in zip(got, row(*(c[i] for c in x))):
            assert torch.equal(a[i], b)
    got = torch.func.vmap(row, in_dims=(None, None, 0, 0, 0))(x[0][0], x[1][0], *x[2:])
    for a, b in zip(got, row(x[0][0], x[1][0], *(c[2] for c in x[2:]))):
        assert torch.equal(a[2], b)


def test_cpu_path_never_touches_the_library(monkeypatch):
    """On CPU tensors ``pnp_refine`` runs the plain version, alone and under
    ``vmap``: nothing is built or loaded and the counter stays 0."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path asked for the kernel library")

    monkeypatch.setattr(pnp_kernel, "build_kernel", refuse)
    monkeypatch.setattr(pnp_kernel, "_load", refuse)
    monkeypatch.setattr(pnp.pnp_refine, "launches", 0)
    problems = [build_problem(np.random.default_rng(30 + i), N=64)[0] for i in range(2)]
    res = pnp.pnp_refine(problems[0][0], CAM, *problems[0][1:])
    got = torch.func.vmap(lambda q, t, *rest: pnp.pnp_refine(SE3(q, t), CAM, *rest).pose.t)(
        *stack(problems))
    # vmap batches the plain einsums, which sum in another order
    torch.testing.assert_close(got[0], res.pose.t, rtol=0, atol=1e-5)
    assert pnp.pnp_refine.launches == 0 and pnp_kernel._lib is None


def _args(S=2, N=5):
    return dict(q=torch.zeros(S, 4), t=torch.zeros(S, 3), points_w=torch.zeros(S, N, 3),
                px_obs=torch.zeros(S, N, 2), valid=torch.ones(S, N, dtype=torch.bool))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "mask dtype", "rows"])
def test_argument_checks_raise(bad):
    a = _args()
    assert pnp_kernel.check_args(**a) == (2, 5)
    if bad == "dtype":
        a["points_w"], err = a["points_w"].double(), TypeError
    elif bad == "shape":
        a["t"], err = a["t"][:, :2], ValueError
    elif bad == "contiguity":
        a["px_obs"], err = a["px_obs"].transpose(0, 1).contiguous().transpose(0, 1), ValueError
    elif bad == "mask dtype":
        a["valid"], err = a["valid"].float(), TypeError
    else:
        a, err = _args(S=0), ValueError
    with pytest.raises(err):
        pnp_kernel.check_args(**a)


def test_launcher_refuses_cpu_tensors_and_other_devices():
    with pytest.raises(ValueError, match="CUDA"):
        pnp_kernel.launch(*_args().values(), cam=(1.0, 1.0, 0.0, 0.0), iters=4, huber_delta=2.0,
                          chi2_thresh=5.99, refine_l2=True)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pnp.pnp_refine(SE3.identity(), CAM, meta, meta[:, :2], meta[:, 0] > 0)


def test_problems_are_what_they_say():
    """tests/pnp_problems.py: the behind-camera points have z < 0 at the
    true pose, the masked fraction is about right, and the outliers miss."""
    rng = np.random.default_rng(0)
    (pose0, pts, obs, valid), cam = build_problem(rng, N=400, outlier_frac=0.25, behind=10,
                                                  masked_frac=0.1)
    assert cam is pnp_problems.CAM
    res = pnp._pnp_refine_plain(pose0, cam, pts, obs, valid, iters=4)
    _, _, z = pnp._residuals_jacobian(res.pose, cam, pts, obs)
    assert int((z < 0).sum()) == 10
    assert 20 <= int((~valid).sum()) <= 60
    assert 0.5 * 400 < int(res.num_inliers) < 0.75 * 400
