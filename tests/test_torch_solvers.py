"""Port parity of the solvers against the JAX package: quartic, P3P,
LMedS-P3P, PnP, the 8-point essential RANSAC and local BA.  Random
hypotheses are drawn once by the JAX ``sample_minimal`` and injected into
both sides, so the two solve the same problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.geom import SE3 as JSE3, Camera as JCamera
from alvaar_tpu.solvers import absolute as jabs
from alvaar_tpu.solvers import essential as jess
from alvaar_tpu.solvers import p3p as jp3p
from alvaar_tpu.solvers import pnp as jpnp
from alvaar_tpu.solvers import quartic as jq
from alvaar_tpu.solvers.ba import local_ba as jlocal_ba
from alvaar_tpu.solvers.ransac import masked_quantile as jmq, sample_minimal as jsample
from alvaar_tpu_torch.geom.camera import Camera as TCamera
from alvaar_tpu_torch.geom.lie import SE3 as TSE3
from alvaar_tpu_torch.solvers import absolute as tabs
from alvaar_tpu_torch.solvers import essential as tess
from alvaar_tpu_torch.solvers import p3p as tp3p
from alvaar_tpu_torch.solvers import pnp as tpnp
from alvaar_tpu_torch.solvers import quartic as tq
from alvaar_tpu_torch.solvers import ba as tba
from alvaar_tpu_torch.solvers.ransac import masked_quantile, sample_minimal
from tests.synthetic_scene import add_outliers, observe, random_pose, scene_points
from tests.test_ba import CAM as BA_CAM, build_problem

JCAM = JCamera.create(500.0, 500.0, 320.0, 240.0)
TCAM = TCamera.create(500.0, 500.0, 320.0, 240.0)
POSE_ATOL = 1e-4


def _t(a, dtype=None):
    a = np.array(a)
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


def _tse3(p: JSE3) -> TSE3:
    return TSE3(_t(p.q), _t(p.t))


def _assert_pose(t_pose: TSE3, j_pose: JSE3, atol=POSE_ATOL):
    q_t, q_j = t_pose.q.numpy(), np.asarray(j_pose.q)
    # q and -q are one rotation
    sign = np.where(np.sum(q_t * q_j, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(q_t * sign, q_j, atol=atol, rtol=0)
    np.testing.assert_allclose(t_pose.t.numpy(), np.asarray(j_pose.t), atol=atol, rtol=0)


def test_quartic_matches(rng):
    roots = rng.uniform(-3, 3, size=(64, 4)).astype(np.complex128)
    roots[:16, 2] = roots[:16, 1] + 1j * rng.uniform(0.5, 2, 16)    # complex pairs
    roots[:16, 3] = np.conj(roots[:16, 2])
    coeffs = np.stack([np.poly(r).real for r in roots]).astype(np.float32)
    jr, jv = jq.solve_quartic_real(*[jnp.asarray(coeffs[:, i]) for i in range(5)])
    tr, tv = tq.solve_quartic_real(*[_t(coeffs[:, i]) for i in range(5)])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3, rtol=1e-4)


# Raw P3P candidates include ill-conditioned samples (a near-double root
# of the resolvent cubic), where Cardano's cancellation amplifies 1-ulp
# differences of the cube root (jnp.cbrt and the port's pow-based root
# differ in the last bit on ~2% of inputs) to a few 1e-3 on translations
# of a few units.  The LMedS output below is held to POSE_ATOL.
P3P_CAND_ATOL = 5e-3


def test_p3p_grunert_matches(rng):
    """All candidates of 48 minimal samples.  The JAX side runs op by op
    (``jax.disable_jit``): fused under jit, XLA rewrites the closed-form
    quartic's arithmetic (e.g. division by constants), which near a double
    root moves candidates by far more than the bar, between JAX's own jit
    and op-by-op results as much as against the port."""
    pose = random_pose(rng)
    P = scene_points(rng, 64)
    _, f, _ = observe(pose, JCAM, P)
    idx = np.stack([rng.choice(64, 3, replace=False) for _ in range(48)])
    with jax.disable_jit():
        jc, jv = jp3p.p3p_grunert(f[idx], P[idx])
    tc, tv = tp3p.p3p_grunert(_t(f)[idx], _t(P)[idx])
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    _assert_pose(TSE3(tc.q[tv], tc.t[tv]), JSE3(jc.q[jv], jc.t[jv]), atol=P3P_CAND_ATOL)


def test_masked_quantile_and_sampling(rng):
    errs = rng.uniform(size=(5, 40)).astype(np.float32)
    valid = rng.random(40) < 0.6
    for q in (0.2, 0.5):
        np.testing.assert_array_equal(
            masked_quantile(_t(errs), _t(valid[None]), q).numpy(),
            np.asarray(jmq(jnp.asarray(errs), jnp.asarray(valid[None]), q)))
    gen = torch.Generator().manual_seed(3)
    idx, ok = sample_minimal(gen, _t(valid), 8, 50)
    assert bool(ok.all()) and idx.shape == (50, 8)
    assert valid[idx.numpy()].all()
    assert all(len(set(row)) == 8 for row in idx.numpy().tolist())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_p3p_lmeds_with_injected_samples(seed):
    rng = np.random.default_rng(seed)
    pose = random_pose(rng)
    P = scene_points(rng, 128)
    px, _, _ = observe(pose, JCAM, P, noise_px=1.0, rng=rng)
    px_o, _ = add_outliers(rng, px, 0.3)
    f_o = JCAM.bearing(px_o)
    valid = np.ones(128, bool)
    valid[::10] = False
    idx, ok = jsample(jax.random.PRNGKey(4), jnp.asarray(valid), 3, 100)
    j = jabs.p3p_lmeds(jax.random.PRNGKey(4), f_o, P, jnp.asarray(valid),
                       focal=500.0, iters=100)
    t = tabs.p3p_lmeds(None, _t(f_o), _t(P), _t(valid), focal=500.0, iters=100,
                       samples=(_t(idx).long(), _t(ok)))
    assert bool(t.success) == bool(j.success)
    _assert_pose(t.pose, j.pose)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))


@pytest.mark.parametrize("outliers", [0.0, 0.25])
def test_pnp_refine_matches(rng, outliers):
    pose = random_pose(rng)
    P = scene_points(rng, 96)
    px, _, _ = observe(pose, JCAM, P, noise_px=0.2, rng=rng)
    if outliers:
        px, _ = add_outliers(rng, px, outliers)
    pose0 = pose.retract(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))
    valid = np.ones(96, bool)
    valid[::7] = False
    j = jpnp.pnp_refine(pose0, JCAM, P, px, jnp.asarray(valid), iters=4)
    t = tpnp.pnp_refine(_tse3(pose0), TCAM, _t(P), _t(px), _t(valid), iters=4)
    _assert_pose(t.pose, j.pose)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))


def test_chol_solve6_matches(rng):
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=(8, 6)).astype(np.float32)
    np.testing.assert_allclose(tpnp._chol_solve6(_t(H), _t(g)).numpy(),
                               np.asarray(jpnp._chol_solve6(jnp.asarray(H), jnp.asarray(g))),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("outliers", [0.0, 0.2])
def test_essential_ransac_with_injected_samples(rng, outliers):
    pose1 = random_pose(rng, rot_scale=0.1, t_scale=0.0)
    pose1 = JSE3(pose1.q, jnp.asarray([0.5, 0.1, 0.05]))
    P = scene_points(rng, 160)
    _, f0, _ = observe(JSE3.identity(), JCAM, P)
    px1, f1, _ = observe(pose1.inverse(), JCAM, P, noise_px=0.3, rng=rng)
    if outliers:
        px1, _ = add_outliers(rng, px1, outliers)
        f1 = JCAM.bearing(px1)
    valid = np.ones(160, bool)
    valid[::11] = False
    key = jax.random.PRNGKey(1)
    idx, ok = jsample(key, jnp.asarray(valid), 8, 100)
    j = jess.essential_ransac(key, f0, f1, jnp.asarray(valid), focal=500.0, iters=100)
    t = tess.essential_ransac(None, _t(f0), _t(f1), _t(valid), focal=500.0, iters=100,
                              samples=(_t(idx).long(), _t(ok)))
    assert bool(t.success) == bool(j.success)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    _assert_pose(t.pose, j.pose)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.05])
def test_local_ba_matches(rng, outlier_frac):
    prob, _, _ = build_problem(rng, outlier_frac=outlier_frac)
    j = jlocal_ba(prob, BA_CAM, iters=5, refine_iters=2)
    tprob = tba.BAProblem(
        poses=_tse3(prob.poses), kf_valid=_t(prob.kf_valid),
        constant=_t(prob.constant), anchor_kf=_t(prob.anchor_kf, torch.int64),
        anchor_mxy=_t(prob.anchor_mxy), invdepth=_t(prob.invdepth),
        lm_valid=_t(prob.lm_valid), obs_lm=_t(prob.obs_lm, torch.int64),
        obs_px=_t(prob.obs_px), obs_valid=_t(prob.obs_valid))
    cam = TCamera.create(float(BA_CAM.fx), float(BA_CAM.fy), float(BA_CAM.cx),
                         float(BA_CAM.cy))
    t = tba.local_ba(tprob, cam, iters=5, refine_iters=2)
    _assert_pose(t.poses, j.poses)
    np.testing.assert_allclose(t.invdepth.numpy(), np.asarray(j.invdepth),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
