"""Local BA's kernels K6a (linearisation and normal-equation assembly, and
its cost-only residual pass) and K6b (Schur assembly): their plain
versions against the JAX package, the custom ops' fake shapes and batching
rule, the CPU path's independence of the library, the launchers' argument
checks; and the kernels' CUDA source itself, run on the CPU through
tools/cpu_cuda_shim.h, against the plain versions.
tests/test_torch_ba_kernels_card.py holds the kernels to their plain
versions on a card.

Bars: the plain versions are today's arithmetic of solvers/ba.py, and the
JAX package computes the same blocks in float32 with its own einsum
orders, so blocks agree to 2e-5 of each block's largest magnitude; the
residual pass's r^2 and z to 1e-6 of theirs."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.solvers import ba as jba
from alvaar_tpu_torch.geom.camera import Camera as TCamera
from alvaar_tpu_torch.geom.lie import SE3 as TSE3
from alvaar_tpu_torch.solvers import ba as tba
from alvaar_tpu_torch.solvers import ba_kernels
import ba_problems
from tests.test_ba import CAM as BA_CAM, build_problem
from tests.test_torch_solvers import _t, _tse3

BLOCK_BAR = 2e-5
KERNEL_BLOCKS = ("H_cc", "g_c", "u", "va", "D", "g_l")     # what K6a writes
BLOCKS = KERNEL_BLOCKS + ("cost",)                          # the plain version's
TCAM = TCamera.create(float(BA_CAM.fx), float(BA_CAM.fy), float(BA_CAM.cx), float(BA_CAM.cy))


def _both(rng, outlier_frac):
    """The JAX problem and its port twin on the same numbers."""
    prob, _, _ = build_problem(rng, outlier_frac=outlier_frac)
    tprob = tba.BAProblem(
        poses=_tse3(prob.poses), kf_valid=_t(prob.kf_valid), constant=_t(prob.constant),
        anchor_kf=_t(prob.anchor_kf, torch.int64), anchor_mxy=_t(prob.anchor_mxy),
        invdepth=_t(prob.invdepth), lm_valid=_t(prob.lm_valid),
        obs_lm=_t(prob.obs_lm, torch.int64), obs_px=_t(prob.obs_px), obs_valid=_t(prob.obs_valid))
    return prob, tprob


def _blocks(lin):
    return tuple(getattr(lin, name) for name in KERNEL_BLOCKS)


def _close_blocks(got, want, bar=BLOCK_BAR, names=BLOCKS):
    for name in names:
        a = np.asarray(getattr(got, name), np.float64)
        b = np.asarray(getattr(want, name), np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= bar * scale, (name, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_plain_linearize_matches_jax(rng, outlier_frac):
    prob, tprob = _both(rng, outlier_frac)
    jvp = jba._build_virtual(prob, BA_CAM)
    with jax.default_matmul_precision("float32"):
        jlin = jba._linearize(jvp, prob.poses, jvp.lam_v, BA_CAM, 2.0)
    tvp = tba._build_virtual(tprob, TCAM)
    tlin = tba._linearize(tvp, tprob.poses, tvp.lam_v, TCAM, 2.0)
    _close_blocks(tlin, jlin)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_plain_residual_pass_matches_jax(rng, outlier_frac):
    prob, tprob = _both(rng, outlier_frac)
    jvp = jba._build_virtual(prob, BA_CAM)
    r, z = jba._residuals_fast(jvp, prob.poses, jvp.lam_v, BA_CAM)
    r2 = jnp.sum(r * r, axis=-1)
    cost = jnp.sum(jnp.where(jvp.valid, jba._huber_rho(r2, 2.0), 0.0))
    lam_obs = jnp.einsum("gwk,gk->wk", jvp.E, jvp.lam_v)
    tvp = tba._build_virtual(tprob, TCAM)
    tcost, tr2, tz, tlam = tba._residual_pass(tvp, tprob.poses, tvp.lam_v, TCAM, 2.0)
    np.testing.assert_allclose(tr2.numpy(), np.asarray(r2), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tlam.numpy(), np.asarray(lam_obs))
    np.testing.assert_allclose(float(tcost), float(cost), rtol=1e-6)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_plain_schur_matches_jax(rng, outlier_frac):
    """``_schur_plain`` on JAX's own linearisation: the step that ``_solve_lm``
    solves from it equals JAX's ``_solve_lm`` (its reduction has no output of
    its own), and the reduced system is masked."""
    prob, tprob = _both(rng, outlier_frac)
    jvp = jba._build_virtual(prob, BA_CAM)
    lam_lm = np.float32(1e-3)
    with jax.default_matmul_precision("float32"):
        jlin = jba._linearize(jvp, prob.poses, jvp.lam_v, BA_CAM, 2.0)
        jdc, jdl = jba._solve_lm(jvp, jlin, jnp.asarray(lam_lm))
    tvp = tba._build_virtual(tprob, TCAM)
    tlin = tba._Linearization(*(torch.from_numpy(np.asarray(x)) for x in jlin))
    S, g_s = tba._schur_plain(tvp, tlin, torch.tensor(lam_lm))
    dc, dl = tba._solve_lm(tvp, tlin, torch.tensor(lam_lm))
    # the solve amplifies the reduction's round-off by the system's
    # condition number: the step is held to 1e-4 of its largest entry (the
    # pose bar of test_torch_solvers.py's local BA comparison)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), rtol=0, atol=1e-4 * np.abs(jdc).max())
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=0, atol=1e-4 * np.abs(jdl).max())
    # the reduced system, solved in float64, gives the same step
    free6 = np.repeat(np.asarray(prob.kf_valid & ~prob.constant), 6)
    S64 = S.double().numpy()
    x = -np.linalg.solve(0.5 * (S64 + S64.T), g_s.double().numpy())
    np.testing.assert_allclose(x.reshape(-1, 6), np.asarray(jdc), rtol=0,
                               atol=1e-4 * np.abs(jdc).max())
    assert np.all(S64[~free6][:, ~free6] == np.eye(int((~free6).sum())))
    assert np.all(g_s.numpy()[~free6] == 0)


def _rows(n, seed=1):
    rng = np.random.default_rng(seed)
    return [ba_problems.build_problem(rng, W=6, L=40, K=24, outlier_frac=0.1)[0]
            for _ in range(n)]


def _op_args(prob, lam_lm=1e-3):
    vp = tba._build_virtual(prob, TCAM)
    lin = tba._linearize(vp, prob.poses, vp.lam_v, TCAM, 2.0)
    return vp, lin, torch.tensor(lam_lm)


def test_ops_cpu_implementation_is_the_plain_version():
    """The custom ops on CPU tensors (one problem, S = 1) equal the plain
    versions bit for bit: their index form rebuilds the dense tensors
    exactly."""
    prob = _rows(1)[0]
    vp, lin, lam = _op_args(prob)
    got = tba.linearize_op(vp, prob.poses, vp.lam_v, TCAM, 2.0)
    for name in KERNEL_BLOCKS:
        assert torch.equal(getattr(got, name), getattr(lin, name)), name
    assert got.cost is None
    got = tba.residuals_op(vp, prob.poses, vp.lam_v, TCAM, 2.0)
    want = tba._residual_pass(vp, prob.poses, vp.lam_v, TCAM, 2.0)
    # the op's cost is float64 (the kernel sums it so): the plain cost widened
    assert got[0].dtype == torch.float64 and torch.equal(got[0], want[0].double())
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    for a, b in zip(tba.schur_op(vp, lin, lam), tba._schur_plain(vp, lin, lam)):
        assert torch.equal(a, b)


def test_ops_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    prob = _rows(1)[0]
    vp, lin, lam = _op_args(prob)
    real = [_blocks(tba.linearize_op(vp, prob.poses, vp.lam_v, TCAM, 2.0)),
            tba.residuals_op(vp, prob.poses, vp.lam_v, TCAM, 2.0), tba.schur_op(vp, lin, lam)]
    mode = FakeTensorMode()
    fake = lambda x: mode.from_tensor(x) if isinstance(x, torch.Tensor) else x
    fvp = tba._VirtualProblem(**{k: fake(v) for k, v in vars(vp).items()
                                 if not isinstance(v, (tuple, TSE3))},
                              poses=None, intr=None)
    fposes = TSE3(fake(prob.poses.q), fake(prob.poses.t))
    flin = tba._Linearization(*map(fake, _blocks(lin)))
    with mode:
        got = [_blocks(tba.linearize_op(fvp, fposes, fake(vp.lam_v), TCAM, 2.0)),
               tba.residuals_op(fvp, fposes, fake(vp.lam_v), TCAM, 2.0),
               tba.schur_op(fvp, flin, fake(lam))]
    for g, r in zip(got, real):
        assert [(tuple(x.shape), x.dtype) for x in g] == [(tuple(x.shape), x.dtype) for x in r]


def _stack(xs):
    return torch.stack(xs)


def test_ops_vmap_rule_equals_rows():
    """Under ``torch.func.vmap`` each op runs once over the S rows (its
    batching rule); the result equals S single calls bit for bit, an
    unbatched argument included."""
    probs = _rows(3)
    args = [_op_args(p, lam_lm) for p, lam_lm in zip(probs, (1e-3, 1e-2, 1e-4))]
    vps, lins, lams = zip(*args)

    def lin_row(q, t, lam_v, valid, px, mxy, first, a_idx, constant):
        vp = tba._VirtualProblem(**{**vars(vps[0]), "valid": valid, "px": px, "mxy": mxy,
                                    "first": first, "a_idx": a_idx, "constant": constant})
        out = tba.linearize_op(vp, TSE3(q, t), lam_v, TCAM, 2.0)
        res = tba.residuals_op(vp, TSE3(q, t), lam_v, TCAM, 2.0)
        return _blocks(out) + tuple(res)

    fields = lambda vp, p: (p.poses.q, p.poses.t, vp.lam_v, vp.valid, vp.px, vp.mxy, vp.first,
                            vp.a_idx, vp.constant)
    batched = [_stack(x) for x in zip(*(fields(vp, p) for vp, p in zip(vps, probs)))]
    got = torch.func.vmap(lin_row)(*batched)
    for i, (vp, p) in enumerate(zip(vps, probs)):
        want = lin_row(*fields(vp, p))
        for a, b in zip(got, want):
            assert torch.equal(a[i], b)
    # the constant mask shared by every row (not batched)
    got = torch.func.vmap(lin_row, in_dims=(0,) * 8 + (None,))(*batched[:8], vps[0].constant)
    want = lin_row(*fields(vps[2], probs[2])[:8], vps[0].constant)
    for a, b in zip(got, want):
        assert torch.equal(a[2], b)

    def schur_row(D, u, va, first, a_idx, H, g_c, g_l, lam, free):
        vp = tba._VirtualProblem(**{**vars(vps[0]), "first": first, "a_idx": a_idx,
                                    "free": free})
        return tba.schur_op(vp, tba._Linearization(H, g_c, u, va, D, g_l, None), lam)

    sf = lambda vp, lin, lam: (lin.D, lin.u, lin.va, vp.first, vp.a_idx, lin.H_cc, lin.g_c,
                               lin.g_l, lam, vp.free)
    batched = [_stack(x) for x in zip(*(sf(*a) for a in args))]
    got = torch.func.vmap(schur_row)(*batched)
    for i, a in enumerate(args):
        for x, y in zip(got, schur_row(*sf(*a))):
            assert torch.equal(x[i], y)


def test_cpu_path_never_touches_the_library(monkeypatch):
    """On CPU tensors local BA runs the plain versions, alone and under
    ``vmap``: nothing is built or loaded and no counter moves."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path asked for the kernel library")

    monkeypatch.setattr(ba_kernels, "build_kernel", refuse)
    monkeypatch.setattr(ba_kernels, "_load", refuse)
    for f in (tba.ba_linearize, tba.ba_residuals, tba.ba_schur):
        monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(tba._residuals_jacobians, "calls", 0)
    probs = _rows(2)
    res = tba.local_ba(probs[0], TCAM, iters=2, refine_iters=1)
    assert torch.isfinite(res.poses.t).all()
    names = [f.name for f in dataclasses.fields(tba.BAProblem)]

    def row(q, t, *rest):
        r = tba.local_ba(tba.BAProblem(TSE3(q, t), **dict(zip(names[1:], rest))), TCAM,
                         iters=2, refine_iters=1)
        return r.poses.q, r.poses.t, r.invdepth

    cols = [(p.poses.q, p.poses.t) + tuple(getattr(p, n) for n in names[1:]) for p in probs]
    got = torch.func.vmap(row)(*[_stack(x) for x in zip(*cols)])
    assert torch.allclose(got[1][0], res.poses.t, atol=0, rtol=0)
    assert tba.ba_linearize.launches == tba.ba_residuals.launches == tba.ba_schur.launches == 0
    assert tba._residuals_jacobians.calls == 2 * 3       # jacfwd ran: the plain path
    assert ba_kernels._lib is None


def _lin_tensors(S=2, W=4, K=5, dtype=torch.float32):
    return dict(q=torch.zeros(S, W, 4, dtype=dtype), t=torch.zeros(S, W, 3, dtype=dtype),
                lam_v=torch.ones(S, W, K, dtype=dtype), valid=torch.ones(S, W, K, dtype=torch.bool),
                px=torch.zeros(S, W, K, 2, dtype=dtype), mxy=torch.zeros(S, W, K, 2, dtype=dtype),
                first=torch.zeros(S, W, K, dtype=torch.int64),
                a_idx=torch.zeros(S, W, K, dtype=torch.int64),
                constant=torch.zeros(S, W, dtype=torch.bool))


def _schur_tensors(S=2, W=4, K=5):
    f = lambda *s: torch.zeros(s)
    return dict(D=f(S, W, K), u=f(S, W, K, 6), va=f(S, W, K, 6),
                first=torch.zeros(S, W, K, dtype=torch.int64),
                a_idx=torch.zeros(S, W, K, dtype=torch.int64), H=f(S, 6 * W, 6 * W),
                g_c=f(S, 6 * W), g_l=f(S, W, K), lam_lm=f(S),
                free=torch.ones(S, W, dtype=torch.bool))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "index dtype", "rows"])
def test_argument_checks_raise(bad):
    lin, sch = _lin_tensors(), _schur_tensors()
    assert ba_kernels.check_linearize_args(**lin) == (2, 4, 5)
    assert ba_kernels.check_schur_args(**sch) == (2, 4, 5)
    if bad == "dtype":
        lin["px"], sch["H"] = lin["px"].double(), sch["H"].double()
        err = TypeError
    elif bad == "shape":
        lin["t"], sch["va"] = lin["t"][:, :, :2], sch["va"][..., :5]
        err = ValueError
    elif bad == "contiguity":
        lin["mxy"] = lin["mxy"].transpose(1, 2).contiguous().transpose(1, 2)
        sch["u"] = sch["u"].transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    elif bad == "index dtype":
        lin["first"], sch["a_idx"] = lin["first"].int(), sch["a_idx"].int()
        err = TypeError
    else:
        lin, sch = _lin_tensors(W=ba_kernels.W_MAX + 1), _schur_tensors(W=ba_kernels.W_MAX + 1)
        err = ValueError
    with pytest.raises(err):
        ba_kernels.check_linearize_args(**lin)
    with pytest.raises(err):
        ba_kernels.check_schur_args(**sch)


def test_launchers_refuse_cpu_tensors_and_other_devices():
    lin, sch = _lin_tensors(), _schur_tensors()
    with pytest.raises(ValueError, match="CUDA"):
        ba_kernels.launch_linearize(**lin, cam=(1.0, 1.0, 0.0, 0.0), huber_delta=2.0)
    with pytest.raises(ValueError, match="CUDA"):
        ba_kernels.launch_schur(**sch)
    meta = tba._Linearization(*(torch.empty(2, device="meta") for _ in range(7)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tba.ba_schur(None, meta, torch.empty((), device="meta"))


def test_ba_problems_match_test_ba(rng):
    """tests/ba_problems.build_problem is tests/test_ba.py's problem,
    without JAX."""
    prob, _, _ = build_problem(np.random.default_rng(3), outlier_frac=0.05)
    tprob, _ = ba_problems.build_problem(np.random.default_rng(3), outlier_frac=0.05)
    for name in jba.BAProblem._fields:
        a, b = getattr(prob, name), getattr(tprob, name)
        pairs = ([(a.q, b.q), (a.t, b.t)] if name == "poses" else [(a, b)])
        for x, y in pairs:
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.fixture(scope="module")
def cuda_source_on_cpu(tmp_path_factory):
    """tools/rehearse_ba_kernels.py and csrc/ba_kernels.cu built with it for
    the CPU (tools/cpu_cuda_shim.h: every CUDA thread a fiber)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "rehearse_ba_kernels.py"
    spec = importlib.util.spec_from_file_location("rehearse_ba_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build(str(tmp_path_factory.mktemp("ba_kernels_cpu")))


@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_cuda_source_on_cpu_matches_plain(cuda_source_on_cpu, outlier_frac):
    """K6a and K6b's CUDA source run on the CPU on tests/test_ba.py's window
    (W 8, K 96): each block within BLOCK_BAR of a float64 evaluation of the
    plain version, and the residual pass's cost too; its r2, z and inverse
    depths bit-equal to the plain pass; two rows in one launch each
    bit-equal to its launch alone; whole ``local_ba`` against the plain
    versions at tests/test_torch_solvers.py's bars (1e-4, inlier flags
    equal).  At outlier fraction 0.05 the pruning drops the first row of
    some virtual landmarks and keeps their others, which the member walk
    must still sum."""
    from tests.test_torch_ba_kernels_card import _f64, _launch_all, _stacked
    mod, lib = cuda_source_on_cpu
    probs = [ba_problems.build_problem(np.random.default_rng(seed),
                                       outlier_frac=outlier_frac)[0] for seed in (0, 1)]
    prob, cam = probs[0], ba_problems.CAM
    vp, vp64 = tba._build_virtual(prob, cam), tba._build_virtual(_f64(prob), cam)
    lam = torch.tensor(1e-3)
    with mod.on_cpu(lib):
        lin_k = tba.ba_linearize(vp, prob.poses, vp.lam_v, cam, 2.0)
        res_k = tba.ba_residuals(vp, prob.poses, vp.lam_v, cam, 2.0)
        sch_k = tba.ba_schur(vp, lin_k, lam)
        x, _ = _stacked(probs, cam)
        both = _launch_all(x, slice(None), cam, 2.0)
        alone = [_launch_all(x, slice(i, i + 1), cam, 2.0) for i in range(2)]
        ba_k = tba.local_ba(prob, cam)
        launches = (tba.ba_linearize.launches, tba.ba_schur.launches)
    ba_p = tba.local_ba(prob, cam)
    lin_64 = tba._linearize(vp64, vp64.poses, vp64.lam_v, cam, 2.0)
    mag = lambda t: float(t.abs().max())
    for name in KERNEL_BLOCKS:
        got, ref = getattr(lin_k, name).double(), getattr(lin_64, name)
        assert float((got - ref).abs().max()) <= BLOCK_BAR * mag(ref), name
    cost_64 = tba._residual_pass(vp64, vp64.poses, vp64.lam_v, cam, 2.0)[0]
    assert res_k[0].dtype == torch.float64
    assert abs(float(res_k[0]) - float(cost_64)) <= BLOCK_BAR * abs(float(cost_64))
    plain = tba._residual_pass(vp, prob.poses, vp.lam_v, cam, 2.0)
    assert all(torch.equal(a, b) for a, b in zip(res_k[1:], plain[1:]))
    lin_k64 = tba._Linearization(*(t.double() for t in _blocks(lin_k)))
    S_64, g_64 = tba._schur_plain(vp64, lin_k64, lam.double())
    assert float((sch_k[0].double() - S_64).abs().max()) <= BLOCK_BAR * max(mag(S_64),
                                                                          mag(lin_k64.H_cc))
    assert float((sch_k[1].double() - g_64).abs().max()) <= BLOCK_BAR * max(mag(g_64),
                                                                          mag(lin_k64.g_c))
    assert all(torch.equal(a[i:i + 1], b) for i in range(2) for a, b in zip(both, alone[i]))
    assert float((ba_k.poses.t - ba_p.poses.t).abs().max()) <= 1e-4
    assert float((ba_k.invdepth - ba_p.invdepth).abs().max()) <= 1e-4
    assert torch.equal(ba_k.obs_inlier, ba_p.obs_inlier)
    assert min(launches) > 0
