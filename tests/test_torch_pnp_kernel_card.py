"""Motion-only PnP's kernel K9 on a card against its plain version and the
plain version's float64 evaluation (skipped without one: a CUDA kernel has
no CPU mode).  This file imports neither JAX nor the JAX package, so that
it runs where the card is:

    python -m pytest --noconftest tests/test_torch_pnp_kernel_card.py -q

(tests/conftest.py sets JAX up for the CPU tests.)  chip_smoke.py phase 2c
holds the same bars at more shapes."""

import numpy as np
import pytest
import torch

from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.solvers import pnp
from pnp_problems import CAM, build_problem, stack, to_f64

T_BAR, Q_BAR, CHI2_NEAR = 1e-5, 1e-6, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _row(q, t, pts, obs, valid, iters=4):
    r = pnp.pnp_refine(SE3(q, t), CAM, pts, obs, valid, iters=iters)
    return r.pose.q, r.pose.t, r.inliers, r.num_inliers, r.cost


def _hold(q, t, inliers, num, problem, iters):
    """One row's result against the plain version's float64 evaluation."""
    p0, pts, obs, valid = to_f64(problem)
    ref = pnp._pnp_refine_plain(p0, CAM, pts, obs, valid, iters=iters)
    assert float((t.double() - ref.pose.t).abs().max()) <= T_BAR * float(ref.pose.t.abs().max())
    assert float((q.double() - ref.pose.q).abs().max()) <= Q_BAR
    r, _, _ = pnp._residuals_jacobian(ref.pose, CAM, pts, obs)
    near = ((r * r).sum(-1) - pnp.CHI2_THRESH_2DOF).abs() <= CHI2_NEAR * pnp.CHI2_THRESH_2DOF
    assert not bool(((inliers != ref.inliers) & ~near).any())
    assert int(num) == int(inliers.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [192, 352])
@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_kernel_matches_float64_on_card(card, n, outliers):
    """``pnp_refine`` on CUDA tensors: one launch, within the bars of the
    plain version's float64 evaluation, bit-equal run to run."""
    problem, _ = build_problem(np.random.default_rng(n), N=n, outlier_frac=outliers,
                               behind=4 if outliers else 0, device=card)
    pnp.pnp_refine.launches = 0
    got = _row(problem[0].q, problem[0].t, *problem[1:])
    assert pnp.pnp_refine.launches == 1
    again = _row(problem[0].q, problem[0].t, *problem[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _hold(*got[:4], problem, 4)


@pytest.mark.cuda
def test_rows_in_one_launch_on_card(card):
    """64 rows of 240 points (``hd_serving()``'s batched step) under
    ``torch.func.vmap``, the second row all masked: one launch, each row
    bit-equal to its launch alone and within the bars of float64."""
    problems = [build_problem(np.random.default_rng(240 + i), N=240, outlier_frac=0.3,
                              behind=4, device=card)[0] for i in range(64)]
    problems[1] = problems[1][:3] + (torch.zeros_like(problems[1][3]),)
    x = stack(problems)
    pnp.pnp_refine.launches = 0
    got = torch.func.vmap(_row)(*x)
    assert pnp.pnp_refine.launches == 1
    for i, problem in enumerate(problems):
        alone = _row(*(c[i] for c in x))
        assert all(torch.equal(g[i], a) for g, a in zip(got, alone)), i
        if i != 1:
            _hold(got[0][i], got[1][i], got[2][i], got[3][i], problem, 4)
    assert torch.equal(got[1][1], problems[1][0].t) and int(got[3][1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 33, 4196])
def test_any_n_on_card(card, n):
    """N = 0 (the start pose, no inlier, cost 0), one point, 33 (a block of
    two warps) and 4196 (past the 32 x 128 points whose flags stay in
    registers: the spill planes): one launch, the same bits twice, within
    the bars of float64 wherever six points are valid."""
    problem, _ = build_problem(np.random.default_rng(500 + n), N=n, outlier_frac=0.2,
                               behind=2 if n > 10 else 0, device=card)
    pnp.pnp_refine.launches = 0
    got = _row(problem[0].q, problem[0].t, *problem[1:])
    assert pnp.pnp_refine.launches == 1
    again = _row(problem[0].q, problem[0].t, *problem[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if n == 0:
        assert torch.equal(got[1], problem[0].t) and int(got[3]) == 0 and float(got[4]) == 0.0
    elif int(problem[3].sum()) >= 6:
        _hold(*got[:4], problem, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 50, 70, 200])
def test_rows_at_every_block_size_on_card(card, n):
    """A warp per 32 points, 32 to 128 threads: three rows under vmap in
    one launch, each bit-equal to its launch alone."""
    problems = [build_problem(np.random.default_rng(60 + i), N=n, outlier_frac=0.2,
                              device=card)[0] for i in range(3)]
    x = stack(problems)
    pnp.pnp_refine.launches = 0
    got = torch.func.vmap(_row)(*x)
    assert pnp.pnp_refine.launches == 1
    for i in range(3):
        alone = _row(*(c[i] for c in x))
        assert all(torch.equal(g[i], a) for g, a in zip(got, alone)), i


@pytest.mark.cuda
def test_kernel_raises_on_float64_on_card(card):
    """No fallback: CUDA tensors the kernel does not take raise."""
    problem, _ = build_problem(np.random.default_rng(0), N=64, device=card)
    p0, pts, obs, valid = to_f64(problem)
    with pytest.raises(TypeError):
        pnp.pnp_refine(p0, CAM, pts, obs, valid)
