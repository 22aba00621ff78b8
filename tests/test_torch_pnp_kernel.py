"""Motion-only PnP's kernel K9 (csrc/pnp_kernel.cu, solvers/pnp_kernel.py):
its CUDA source run on the CPU through tools/cpu_cuda_shim.h against the
plain version, its float64 evaluation and the JAX package's
``pnp_refine``; and, without building anything, the custom op's fake
shapes and batching rule, the CPU path's independence of the library and
the launcher's argument checks.  tests/test_torch_pnp_kernel_card.py holds
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
    op = pnp.pnp_refine_op(problem[0], CAM, *problem[1:], iters=4, huber_delta=DELTA,
                           chi2_thresh=pnp.CHI2_THRESH_2DOF, refine_l2=True)
    main = pnp.pnp_refine(problem[0], CAM, *problem[1:], iters=4)
    for res in (op, main):
        for a, b in ((res.pose.q, plain.pose.q), (res.pose.t, plain.pose.t),
                     (res.inliers, plain.inliers), (res.num_inliers, plain.num_inliers),
                     (res.cost, plain.cost)):
            assert torch.equal(a, b)


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
        r = pnp.pnp_refine_op(SE3(q, t), CAM, pts, obs, valid, iters=3, huber_delta=DELTA,
                              chi2_thresh=pnp.CHI2_THRESH_2DOF, refine_l2=True)
        return r.pose.q, r.pose.t, r.inliers, r.num_inliers, r.cost

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
