"""Local BA's kernels K6a and K6b on a card against their plain versions
(skipped without one: a CUDA kernel has no CPU mode).  This file imports
neither JAX nor the JAX package, so that it runs where the card is:

    python -m pytest --noconftest tests/test_torch_ba_kernels_card.py -q

(tests/conftest.py sets JAX up for the CPU tests.)  chip_smoke.py phase 2b
holds the same bars at more shapes."""

import numpy as np
import pytest
import torch

from alvaar_tpu_torch.geom.lie import SE3 as TSE3
from alvaar_tpu_torch.solvers import ba as tba
import ba_problems

BLOCK_BAR = 2e-5
KERNEL_BLOCKS = ("H_cc", "g_c", "u", "va", "D", "g_l")     # what K6a writes


def _blocks(lin):
    return tuple(getattr(lin, name) for name in KERNEL_BLOCKS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f64(prob):
    return tba.BAProblem(**{k: (TSE3(v.q.double(), v.t.double()) if isinstance(v, TSE3)
                                else v.double() if v.is_floating_point() else v)
                            for k, v in vars(prob).items()})


@pytest.mark.cuda
@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_kernels_match_plain_on_card(card, outlier_frac):
    """K6a (both modes) and K6b against a float64 evaluation of their plain
    versions on a W = 30, K = 192 window: within 2e-5 of each block's
    largest magnitude (the bar of chip_smoke.py phase 2b); bit-equal run to
    run; the residual pass's r2, z and inverse depths bit-equal to the
    plain pass.  Whole local_ba on tests/test_ba.py's window at
    tests/test_torch_solvers.py's bars."""
    prob, cam = ba_problems.build_problem(np.random.default_rng(0), W=30, L=512, K=192,
                                          outlier_frac=outlier_frac, device=card)
    vp, vp64 = tba._build_virtual(prob, cam), tba._build_virtual(_f64(prob), cam)
    lin_k = tba.ba_linearize(vp, prob.poses, vp.lam_v, cam, 2.0)
    lin_p = tba._linearize(vp, prob.poses, vp.lam_v, cam, 2.0)
    lin_64 = tba._linearize(vp64, vp64.poses, vp64.lam_v, cam, 2.0)
    lam = torch.tensor(1e-3, device=card)
    S_k, g_k = tba.ba_schur(vp, lin_p, lam)
    S_64, g_64 = tba._schur_plain(
        vp64, tba._Linearization(*(x.double() for x in _blocks(lin_p))), lam.double())
    cost_k = tba.ba_residuals(vp, prob.poses, vp.lam_v, cam, 2.0)[0]
    cost_64 = tba._residual_pass(vp64, vp64.poses, vp64.lam_v, cam, 2.0)[0]
    mag = lambda x: float(x.abs().max())
    # S and g_s are scaled by H_cc and g_c too, whose difference they are
    pairs = [(n, k, ref, mag(ref)) for n, k, ref in zip(KERNEL_BLOCKS, _blocks(lin_k),
                                                       _blocks(lin_64))]
    pairs += [("S", S_k, S_64, max(mag(S_64), mag(lin_p.H_cc))),
              ("g_s", g_k, g_64, max(mag(g_64), mag(lin_p.g_c))),
              ("pass cost", cost_k, cost_64, mag(cost_64))]
    for name, k, ref, scale in pairs:
        assert float((k.double() - ref).abs().max()) <= BLOCK_BAR * scale, name
    again = tba.ba_linearize(vp, prob.poses, vp.lam_v, cam, 2.0)
    assert all(torch.equal(a, b) for a, b in zip(_blocks(again), _blocks(lin_k)))
    for a, b in zip(tba.ba_residuals(vp, prob.poses, vp.lam_v, cam, 2.0)[1:],
                    tba._residual_pass(vp, prob.poses, vp.lam_v, cam, 2.0)[1:]):
        assert torch.equal(a, b)
    small, cam = ba_problems.build_problem(np.random.default_rng(0), outlier_frac=outlier_frac,
                                           device=card)
    res_k = tba.local_ba(small, cam)
    tba._dispatch, dispatch = (lambda x, name: False), tba._dispatch
    try:
        res_p = tba.local_ba(small, cam)
    finally:
        tba._dispatch = dispatch
    assert float((res_k.poses.t - res_p.poses.t).abs().max()) <= 1e-4
    assert float((res_k.invdepth - res_p.invdepth).abs().max()) <= 1e-4
    assert torch.equal(res_k.obs_inlier, res_p.obs_inlier)


def _stacked(probs, cam):
    """The kernels' inputs of S problems stacked [S, ...], and each row's
    virtual problem."""
    vps = [tba._build_virtual(p, cam) for p in probs]
    st = lambda f: torch.stack([f(vp, p) for vp, p in zip(vps, probs)]).contiguous()
    x = dict(q=st(lambda v, p: p.poses.q), t=st(lambda v, p: p.poses.t),
             lam_v=st(lambda v, p: v.lam_v), valid=st(lambda v, p: v.valid),
             px=st(lambda v, p: v.px), mxy=st(lambda v, p: v.mxy),
             first=st(lambda v, p: v.first), a_idx=st(lambda v, p: v.a_idx),
             constant=st(lambda v, p: v.constant), free=st(lambda v, p: v.free))
    return x, vps


def _launch_all(x, rows, cam, delta):
    """K6a (both modes) then K6b on the rows ``rows`` of the stack ``x``."""
    from alvaar_tpu_torch.solvers import ba_kernels
    keys = ("q", "t", "lam_v", "valid", "px", "mxy", "first", "a_idx", "constant")
    a = [x[k][rows] for k in keys]
    camt = (cam.fx, cam.fy, cam.cx, cam.cy)
    lin = ba_kernels.launch_linearize(*a, camt, delta)
    res = ba_kernels.launch_residuals(*a[:-1], camt, delta)
    lam = torch.full((a[0].shape[0],), 1e-3, device=a[0].device)
    sch = ba_kernels.launch_schur(lin[4], lin[2], lin[3], x["first"][rows], x["a_idx"][rows],
                                  lin[0], lin[1], lin[5], lam, x["free"][rows])
    return lin + res + sch


@pytest.mark.cuda
@pytest.mark.parametrize("K,S", [(352, 1), (240, 11)])
def test_kernels_at_dense_windows_on_card(card, K, S):
    """The dense W = 30 forward windows: ACCURATE's K = 352 alone and
    ``hd_serving()``'s K = 240 as S = 11 rows in one launch.  Each row's K6a
    blocks and residual-pass cost, and K6b's S and g_s on the kernel's own
    blocks, within BLOCK_BAR of a float64 evaluation of the plain versions;
    r2, z and the inverse depths bit-equal to the plain pass; every output
    bit-equal between two launches and between the S-row launch and each
    row launched alone."""
    rows = [ba_problems.build_problem(np.random.default_rng(K + i), W=30, L=2 * K, K=K,
                                      device=card) for i in range(S)]
    cam = rows[0][1]
    x, vps = _stacked([p for p, _ in rows], cam)
    got = _launch_all(x, slice(None), cam, 2.0)
    again = _launch_all(x, slice(None), cam, 2.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    mag = lambda t: float(t.abs().max())
    for i, (prob, _) in enumerate(rows):
        alone = _launch_all(x, slice(i, i + 1), cam, 2.0)
        assert all(torch.equal(a[i:i + 1], b) for a, b in zip(got, alone)), i
        vp, vp64 = vps[i], tba._build_virtual(_f64(prob), cam)
        lin_64 = tba._linearize(vp64, vp64.poses, vp64.lam_v, cam, 2.0)
        for name, k in zip(KERNEL_BLOCKS, got[:6]):
            ref = getattr(lin_64, name)
            assert float((k[i].double() - ref).abs().max()) <= BLOCK_BAR * mag(ref), (i, name)
        cost_64 = tba._residual_pass(vp64, vp64.poses, vp64.lam_v, cam, 2.0)[0]
        assert abs(float(got[6][i]) - float(cost_64)) <= BLOCK_BAR * abs(float(cost_64)), i
        plain = tba._residual_pass(vp, prob.poses, vp.lam_v, cam, 2.0)
        assert all(torch.equal(a[i], b) for a, b in zip(got[7:10], plain[1:])), i
        lin_k = tba._Linearization(*(t[i].double() for t in got[:6]))
        S_64, g_64 = tba._schur_plain(vp64, lin_k, torch.tensor(1e-3, dtype=torch.float64,
                                                                device=card))
        assert float((got[10][i].double() - S_64).abs().max()) \
            <= BLOCK_BAR * max(mag(S_64), mag(lin_k.H_cc)), i
        assert float((got[11][i].double() - g_64).abs().max()) \
            <= BLOCK_BAR * max(mag(g_64), mag(lin_k.g_c)), i
