"""Port parity of the default-config bootstrap and of CLAHE against the JAX
package: the Nister 5-point solver (its internal steps fed the JAX null
space, its candidate sets, its RANSAC), the homography RANSAC,
``_try_essential`` on a map snapshot, and CLAHE at 640x480.  RANSAC draws
come from the JAX ``sample_minimal`` and are injected into both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.geom import Camera as JCamera
from alvaar_tpu.ops import image as jimg
from alvaar_tpu.solvers import fivept as jfive
from alvaar_tpu.solvers import homography as jhom
from alvaar_tpu.solvers.ransac import sample_minimal as jsample
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.ops import image as timg
from alvaar_tpu_torch.solvers import fivept as tfive
from alvaar_tpu_torch.solvers import homography as thom
from alvaar_tpu_torch.worldmap.state import map_state_from_numpy, map_state_to_numpy
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_fivept import make_pair
from tests.test_homography import make_planar_pair
from tests.test_torch_solvers import _assert_pose, _t

# one intra-op thread: the suite runs in several worker processes, and
# threads that outnumber the cores slow small-tensor ops many times over
torch.set_num_threads(1)

POSE_ATOL = 1e-4      # pose q (up to sign) and t
E_ATOL = 1e-4         # unit-norm essential matrices, up to sign
STEP_RTOL = 1e-4      # internal 5-point steps on the same null space
CLAHE_ATOL = 1e-3     # 0..255 output


def _five_samples(seed, n_samples=8, noise=0.0):
    """[S, 5, 3] bearing pairs of S independent two-view problems."""
    rng = np.random.default_rng(seed)
    pairs = [make_pair(rng, 5, noise=noise) for _ in range(n_samples)]
    return (np.stack([np.asarray(p[0]) for p in pairs]),
            np.stack([np.asarray(p[1]) for p in pairs]))


def _jax_basis(f0, f1):
    A = jnp.einsum("...mi,...mj->...mij", f1, f0).reshape(f0.shape[:-2] + (5, 9))
    Vt = jnp.linalg.svd(A, full_matrices=True)[2]
    return Vt[..., 5:9, :].reshape(f0.shape[:-2] + (4, 3, 3))


def _canon(E):
    """Unit-norm E with the sign making its largest-magnitude entry
    positive (E and −E are one essential matrix)."""
    flat = E.reshape(-1)
    return E * np.sign(flat[np.argmax(np.abs(flat))])


def _assert_same_set(tE, tm, jE, jm, atol):
    a = [_canon(e) for e in tE[tm]]
    b = [_canon(e) for e in jE[jm]]
    assert len(a) == len(b), (len(a), len(b))
    for e in a:
        d = [np.abs(e - f).max() for f in b]
        assert min(d) < atol, min(d)


# The degree-10 sign scan misses a pair of real roots closer than one
# grid interval, and in float32 a root near such a pair is ill-conditioned.
# Which pairs fall in one interval depends on the null-space basis, and the
# rounding differs even between the JAX package's own jitted and op-by-op
# runs (roots up to 1.1e-3 rad apart in θ = atan z on 32 samples of
# make_pair, live sets of different size on some).  So: roots are compared
# as angles; candidates on one shared basis are compared on the samples
# where the two JAX runs agree to 1e-5; with each back end's own basis the
# bar is how often each finds the generating E.
ROOT_THETA_ATOL = 2e-3
TRUE_E_ATOL = 1e-3     # tests/test_fivept.py's bar for the generating E
TRUE_E_RATE = 0.7      # share of samples on which the generating E is found


@jax.jit
def _jax_E_from_basis(basis):
    """The JAX package's essential_from_5pt with its SVD basis replaced."""
    M = jfive._constraint_matrix(basis)
    C = -jnp.linalg.solve(M[..., :10] + 1e-12 * jnp.eye(10, dtype=M.dtype), M[..., 10:])
    p, (k, l, _) = jfive._degree10(C)
    roots, mask = jfive._real_roots_deg10(p, n_grid=64, bisect_iters=26)
    _, top = jax.lax.top_k(mask.astype(jnp.int32), 10)
    top = jnp.sort(top, axis=-1)
    roots = jnp.take_along_axis(roots, top, axis=-1)
    mask = jnp.take_along_axis(mask, top, axis=-1)

    def polyval(c, z):
        return sum(c[..., i:i + 1] * z ** i for i in range(c.shape[-1]))

    nv = jnp.cross(jnp.stack([polyval(c, roots) for c in k], -1),
                   jnp.stack([polyval(c, roots) for c in l], -1))
    wc = nv[..., 2]
    safe = jnp.where(jnp.abs(wc) > 1e-12, wc, 1.0)
    coeff = jnp.stack([nv[..., 0] / safe, nv[..., 1] / safe, roots, jnp.ones_like(roots)], -1)
    E = jnp.einsum("...rc,...cij->...rij", coeff, basis)
    E = E / jnp.linalg.norm(E, axis=(-2, -1), keepdims=True).clip(1e-12)
    return E, mask & (jnp.abs(wc) > 1e-12)


def _stable_samples(f0, f1):
    """Per sample: the JAX package gives the same live-E set jitted and op
    by op, to 1e-5."""
    jE, jm = (np.asarray(v) for v in jax.jit(jfive.essential_from_5pt)(f0, f1))
    with jax.disable_jit():
        oE, om = (np.asarray(v) for v in jfive.essential_from_5pt(f0, f1))
    keep = []
    for s in range(f0.shape[0]):
        try:
            _assert_same_set(oE[s], om[s], jE[s], jm[s], 1e-5)
            keep.append(True)
        except AssertionError:
            keep.append(False)
    return np.array(keep)


class TestFivePointSteps:
    """The steps after the SVD, fed JAX's own null-space basis."""

    @pytest.fixture(scope="class")
    def inputs(self):
        f0, f1 = _five_samples(1, n_samples=16)
        basis = jax.jit(_jax_basis)(jnp.asarray(f0), jnp.asarray(f1))
        M = jax.jit(jfive._constraint_matrix)(basis)
        C = -jnp.linalg.solve(M[..., :10] + 1e-12 * jnp.eye(10), M[..., 10:])
        p, _ = jax.jit(jfive._degree10)(C)
        stable = _stable_samples(jnp.asarray(f0), jnp.asarray(f1))
        assert stable.sum() >= 4, stable
        return (np.asarray(basis), np.asarray(M), np.asarray(C), np.asarray(p), stable)

    def test_constraint_matrix(self, inputs):
        basis, M = inputs[:2]
        np.testing.assert_allclose(tfive._constraint_matrix(_t(basis)).numpy(), M,
                                   rtol=STEP_RTOL, atol=1e-6)

    def test_degree10(self, inputs):
        C, p = inputs[2:4]
        tp, _ = tfive._degree10(_t(C))
        np.testing.assert_allclose(tp.numpy(), p, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * np.abs(p).max())

    def test_real_roots(self, inputs):
        """The same polynomial: the same sign-change slots, roots within
        ROOT_THETA_ATOL as angles."""
        p = inputs[3]
        jr, jm = jax.jit(lambda q: jfive._real_roots_deg10(q, 64, 26))(jnp.asarray(p))
        tr, tm = tfive._real_roots_deg10(_t(p), 64, 26)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        live = np.asarray(jm)
        np.testing.assert_allclose(np.arctan(tr.numpy()[live]),
                                   np.arctan(np.asarray(jr)[live]),
                                   atol=ROOT_THETA_ATOL, rtol=0)

    def test_candidates_on_one_basis(self, inputs):
        """On the same basis, the stable samples' candidates come in the
        same slots."""
        basis, stable = inputs[0], inputs[4]
        jE, jm = (np.asarray(v)[stable] for v in _jax_E_from_basis(jnp.asarray(basis)))
        tE, tm = (v.numpy()[stable] for v in tfive.essential_from_basis(_t(basis)))
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tE[jm], jE[jm], atol=E_ATOL, rtol=0)


def _true_E(pose10):
    from alvaar_tpu.geom.lie import quat_to_matrix
    R = np.asarray(quat_to_matrix(pose10.q))
    t = np.asarray(pose10.t)
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
    return _canon(E / np.linalg.norm(E))


def test_essential_from_5pt_live_sets():
    """Each back end with its own null-space basis, on 64 noise-free
    samples: both find the generating E on at least TRUE_E_RATE of them,
    within 0.1 of each other."""
    rng = np.random.default_rng(1)
    pairs = [make_pair(rng, 5) for _ in range(64)]
    f0 = np.stack([np.asarray(p[0]) for p in pairs])
    f1 = np.stack([np.asarray(p[1]) for p in pairs])
    jE, jm = (np.asarray(v) for v in jax.jit(jfive.essential_from_5pt)(f0, f1))
    tE, tm = (v.numpy() for v in tfive.essential_from_5pt(_t(f0), _t(f1)))

    def found(E, m, E_true):
        return any(np.abs(_canon(e) - E_true).max() < TRUE_E_ATOL for e in E[m])

    hits_t = hits_j = 0
    for s, (_, _, pose10) in enumerate(pairs):
        E_true = _true_E(pose10)
        hits_t += found(tE[s], tm[s], E_true)
        hits_j += found(jE[s], jm[s], E_true)
    rate_t, rate_j = hits_t / len(pairs), hits_j / len(pairs)
    assert rate_t >= TRUE_E_RATE and rate_j >= TRUE_E_RATE, (rate_t, rate_j)
    assert abs(rate_t - rate_j) <= 0.1, (rate_t, rate_j)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.4])
def test_essential_ransac_5pt_with_injected_samples(outlier_frac):
    rng = np.random.default_rng(5)
    f0, f1, _ = make_pair(rng, 80, outlier_frac=outlier_frac, noise=5e-4)
    valid = np.ones(80, bool)
    valid[::9] = False
    key = jax.random.PRNGKey(7)
    idx, ok = jsample(key, jnp.asarray(valid), 5, 60)
    j = jax.jit(lambda k, a, b, v: jfive.essential_ransac_5pt(
        k, a, b, v, focal=500.0, iters=60))(key, f0, f1, jnp.asarray(valid))
    t = tfive.essential_ransac_5pt(None, _t(f0), _t(f1), _t(valid), focal=500.0,
                                   iters=60, samples=(_t(idx).long(), _t(ok)))
    assert bool(t.success) == bool(j.success)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    _assert_pose(t.pose, j.pose, POSE_ATOL)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_homography_ransac_with_injected_samples(outlier_frac):
    rng = np.random.default_rng(8)
    f0, f1, _, _, _ = make_planar_pair(rng, 80, outlier_frac=outlier_frac, noise=4e-4)
    valid = np.ones(80, bool)
    valid[::7] = False
    key = jax.random.PRNGKey(2)
    idx, ok = jsample(key, jnp.asarray(valid), 4, 60)
    j, jscore = jax.jit(lambda k, a, b, v: jhom.homography_ransac(
        k, a, b, v, focal=500.0, iters=60))(key, f0, f1, jnp.asarray(valid))
    t, tscore = thom.homography_ransac(None, _t(f0), _t(f1), _t(valid), focal=500.0,
                                       iters=60, samples=(_t(idx).long(), _t(ok)))
    assert int(tscore) == int(jscore)
    assert bool(t.success) == bool(j.success)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    _assert_pose(t.pose, j.pose, POSE_ATOL)


def test_decompose_homography_candidates():
    """The cases that rebuild H agree (R, t, n), in the same slots."""
    rng = np.random.default_rng(9)
    f0, f1, _, _, _ = make_planar_pair(rng, 24)
    H = np.asarray(jhom.homography_from_4pt(jhom._to_norm(f0)[None], jhom._to_norm(f1)[None]))
    jR, jt, jn, jok = (np.asarray(v) for v in jax.jit(jhom.decompose_homography)(H))
    tR, tt, tn, tok = (v.numpy() for v in thom.decompose_homography(_t(H)))
    np.testing.assert_array_equal(tok, jok)
    assert jok.any()
    for a, b in ((tR, jR), (tt, jt), (tn, jn)):
        np.testing.assert_allclose(a[tok], b[jok], atol=POSE_ATOL, rtol=0)


def test_clahe_640x480(rng):
    img = np.clip(rng.normal(128, 40, (480, 640)), 0, 255).astype(np.float32)
    img[:, :200] *= 0.3                     # a dark band: clipping engages
    j = jax.jit(jimg.clahe)(jnp.asarray(img))
    t = timg.clahe(_t(img))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=CLAHE_ATOL, rtol=0)


def test_clahe_prefix_in_float64_equals_float32_cumsum(rng):
    """The plain version's CDF prefix, float64 rounded once to float32,
    equals the float32 ``torch.cumsum`` it replaced bit for bit on the CPU
    (whose float32 cumsum accumulates in float64), tables and output, on
    test_clahe_640x480's image."""
    img = np.clip(rng.normal(128, 40, (480, 640)), 0, 255).astype(np.float32)
    img[:, :200] *= 0.3
    x = _t(img)
    th, tw = 480 // 8, 640 // 8
    tiles = x.reshape(8, th, 8, tw).permute(0, 2, 1, 3).reshape(64, th * tw)
    q = torch.clamp(torch.round(tiles), 0, 255).to(torch.int64)
    hist = torch.zeros(64, 256).scatter_add_(1, q, torch.ones(q.shape))
    c = max(3.0 * th * tw / 256.0, 1.0)
    hist = torch.clamp_max(hist, c) + torch.clamp_min(hist - c, 0.0).sum(-1, keepdim=True) / 256.0
    cdf = torch.cumsum(hist, dim=-1)                    # float32, as before
    want = (cdf - cdf[:, :1]) / (cdf[:, -1:] - cdf[:, :1]).clamp_min(1.0) * 255.0
    assert torch.equal(timg._clahe_luts_plain(x), want)
    assert torch.equal(timg.clahe(x), timg._clahe_apply_plain(x, want))


def test_clahe_refuses_sizes_not_divisible_by_tiles():
    for shape, tiles in (((100, 128), 8), ((96, 130), 8), ((3, 96, 126), 4), ((4, 4), 8),
                         ((96, 128), 0), ((2, 2, 8, 8), 8)):
        with pytest.raises(ValueError):
            timg.clahe(torch.zeros(shape), tiles=tiles)


def test_preprocess_stack_with_clahe_matches_jax_vmap(rng):
    """``preprocess`` on a [3, 96, 128] stack (one ``clahe`` call) against
    ``jax.vmap`` of the JAX package's, and each row equal to the row's own
    call (the per-stream loop it replaced)."""
    imgs = np.stack([np.clip(rng.normal(90 + 30 * b, 30, (96, 128)), 0, 255)
                     for b in range(3)]).astype(np.float32)
    imgs[1, :, :50] *= 0.3
    jcfg = JSlamConfig(width=128, height=96, use_clahe=True)
    cfg = SlamConfig(width=128, height=96, use_clahe=True)
    got = tstep.preprocess(_t(imgs), cfg)
    want = jax.vmap(lambda g: jstep.preprocess(g, jcfg))(jnp.asarray(imgs))
    assert len(got) == len(want) == cfg.pyramid_levels
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=CLAHE_ATOL, rtol=0)
    for b in range(3):
        for a, row in zip(got, tstep.preprocess(_t(imgs[b]), cfg)):
            assert torch.equal(a[b], row), b


def test_preprocess_with_clahe(rng):
    img = np.clip(rng.normal(100, 30, (96, 128)), 0, 255).astype(np.float32)
    jcfg = JSlamConfig(width=128, height=96, use_clahe=True)
    cfg = SlamConfig(width=128, height=96, use_clahe=True)
    for a, b in zip(tstep.preprocess(_t(img), cfg), jstep.preprocess(jnp.asarray(img), jcfg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=CLAHE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# _try_essential on a map snapshot
# ---------------------------------------------------------------------------

CFG_ARGS = dict(width=320, height=240, cell_size=24, window_size=10,
                max_landmarks=512, ransac_iters=50, ba_iters=4, init_parallax_px=25.0)


def jax_state_from_numpy(d: dict, jcfg: JSlamConfig):
    """The port's numpy state dict → a JAX MapState (leaves in pytree
    order; the port's generator state is dropped, the key kept)."""
    from alvaar_tpu.worldmap.state import init_map_state as jinit
    from alvaar_tpu_torch.io.checkpoint import _leaf_names
    template = jinit(jcfg)
    names = _leaf_names(SlamConfig(**dataclasses.asdict(jcfg)))
    leaves = [jnp.asarray(d[n], ref.dtype)
              for n, ref in zip(names, jax.tree.leaves(template))]
    return jax.tree.unflatten(jax.tree.structure(template), leaves)


@pytest.fixture(scope="module")
def init_snapshot():
    """Port state after the last frame still initializing (status 3) on
    the 320x240 scene, before the bootstrap succeeds."""
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(40, step=0.04)
    slam = AlvaAR(320, 240, fov=60.0, config=SlamConfig(**CFG_ARGS), device="cpu")
    snaps = []
    for i in range(40):
        snaps.append(map_state_to_numpy(slam.state))
        slam.find_camera_pose(scene.render(gt[i]).astype(np.float32))
        if slam.last_status == 1:
            return snaps[-1], slam.camera
    raise AssertionError("the port never left initialization")


@pytest.mark.parametrize("five_point, homography", [(True, True), (False, True), (True, False)])
def test_try_essential_from_snapshot(init_snapshot, five_point, homography):
    d, cam = init_snapshot
    flags = dict(use_five_point=five_point, use_homography_init=homography)
    jcfg = JSlamConfig(**CFG_ARGS, **flags)
    cfg = SlamConfig(**CFG_ARGS, **flags)
    jst = jax_state_from_numpy(d, jcfg)
    jcam = JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy)
    key = jax.random.PRNGKey(3)
    k_e, k_h = jax.random.split(key)
    slot = int(d["cur_kf_slot"])
    same = ((d["kf_obs_lm"][slot] == d["kp_lm"]) & d["kf_obs_valid"][slot] & d["kp_valid"])
    se = jsample(k_e, jnp.asarray(same), 5 if five_point else 8, cfg.ransac_iters)
    sh = jsample(k_h, jnp.asarray(same), 4, cfg.ransac_iters)
    jout, jok = jax.jit(jstep._try_essential, static_argnames=("cfg",))(jst, jcam, jcfg, key)

    tst = map_state_from_numpy(d, cfg, "cpu")
    inject = lambda s: (_t(s[0]).long(), _t(s[1]))
    tout, tok = tstep._try_essential(tst, cam, cfg, samples=(inject(se), inject(sh)))
    assert bool(tok) == bool(jok)
    assert bool(tok), "the bootstrap should succeed on this frame"
    np.testing.assert_array_equal(tout.kp_valid.numpy(), np.asarray(jout.kp_valid))
    assert bool(tout.ready_for_init) == bool(jout.ready_for_init)
    _assert_pose(tout.pose, jout.pose, POSE_ATOL)
