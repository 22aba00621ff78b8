"""Port parity of loop closure against the JAX package: the SWAR Hamming
pass, ``db_add``, ``detect_loop`` on its dense and its prefiltered path,
``verify_loop`` and ``relocalize_topk`` (with injected samples), each on
one seeded database put into both packages; then the port alone on the
out-and-back sequence of tests/test_loop_e2e.py, held to its bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.geom import SE3 as JSE3, Camera as JCamera
from alvaar_tpu.loopclosure import detector as jdet
from alvaar_tpu.solvers.ransac import sample_minimal as jsample
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.geom.camera import Camera as TCamera
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.loopclosure import detector as tdet
from alvaar_tpu_torch.ops.hamming import hamming_matrix, hamming_matrix_chunked
from tests.render_scene_np import TwoPlaneScene
from tests.synthetic_scene import observe, random_pose, scene_points
from tests.test_loop_e2e import out_and_back
from tests.test_loopclosure import perturb, random_descs
from tests.test_torch_solvers import _assert_pose, _t

# one intra-op thread: the suite runs in several worker processes, and
# threads that outnumber the cores slow small-tensor ops many times over
torch.set_num_threads(1)

K = 96
JCAM = JCamera.create(500.0, 500.0, 320.0, 240.0)
TCAM = TCamera.create(500.0, 500.0, 320.0, 240.0)
POSE_ATOL = 1e-4
SCORE_ATOL = 1e-6


def _desc_t(d):
    """uint32 descriptor words → the port's int32 bits."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(d, np.uint32)).view(np.int32))


def _jdb_to_port(db):
    return tdet.loop_db_from_numpy({k: np.asarray(v) for k, v in db._asdict().items()}, "cpu")


def test_swar_hamming_equals_table(rng):
    a = rng.integers(-2**31, 2**31, size=(37, 8), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, size=(301, 8), dtype=np.int64).astype(np.int32)
    b[:4] = [-1, 0, -2**31, 2**31 - 1, 1, -2, 5, 7]
    ref = hamming_matrix(_t(a), _t(b))
    for chunk in (64, 2048):
        np.testing.assert_array_equal(hamming_matrix_chunked(_t(a), _t(b), chunk).numpy(),
                                      ref.numpy())


def _build(rng, capacity, n_entries, with_geometry=False):
    """The same database in both packages: JAX db_add'ed, and the port's
    own db_add'ed from the same inputs."""
    jdb, tdb = jdet.db_init(capacity, K), tdet.db_init(capacity, K, "cpu")
    descs, pts_all, poses = [], [], []
    for i in range(n_entries):
        d = random_descs(rng)
        pts = scene_points(rng, K) if with_geometry else np.zeros((K, 3), np.float32)
        pose = random_pose(rng) if with_geometry else JSE3.identity()
        valid = rng.random(K) < 0.9
        descs.append(d), pts_all.append(np.asarray(pts)), poses.append(pose)
        jdb = jdet.db_add(jdb, d, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(valid),
                          jnp.asarray(i, jnp.int32), pose)
        tdb = tdet.db_add(tdb, _desc_t(d), _t(pts), _t(valid), _t(valid), i,
                          SE3(_t(pose.q), _t(pose.t)))
    return jdb, tdb, descs, pts_all, poses


def test_db_add_matches(rng):
    jdb, tdb, _, _, _ = _build(rng, 24, 30, with_geometry=True)     # wraps the ring
    a = tdet.loop_db_to_numpy(tdb)
    for k, v in a.items():
        b = np.asarray(getattr(jdb, k))
        np.testing.assert_array_equal(v, b, err_msg=k)
        assert v.dtype == b.dtype, k
    for back in (tdet.loop_db_to_numpy(tdet.loop_db_from_numpy(a, "cpu")),
                 tdet.loop_db_to_numpy(_jdb_to_port(jdb))):
        for k in a:
            np.testing.assert_array_equal(back[k], a[k], err_msg=k)


@pytest.mark.parametrize("capacity, n_entries", [(16, 14), (64, 60)])
def test_detect_loop_matches(rng, capacity, n_entries):
    """capacity 16: the dense pass; 64: the signature prefilter first."""
    jdb, tdb, descs, _, _ = _build(rng, capacity, n_entries)
    assert tdb.desc.shape[0] > 16 if capacity == 64 else tdb.desc.shape[0] <= 16
    queries = [(perturb(rng, descs[3], bits=10), n_entries + 60),   # a revisit
               (perturb(rng, descs[4], bits=6), n_entries + 61),    # its island
               (random_descs(rng), n_entries + 62),                 # novel
               (descs[n_entries - 2], n_entries + 1)]               # too recent
    found = []
    for q, qid in queries:
        valid = rng.random(K) < 0.95
        jdb, jr = jdet.detect_loop(jdb, q, jnp.asarray(valid), jnp.asarray(qid, jnp.int32))
        tdb, tr = tdet.detect_loop(tdb, _desc_t(q), _t(valid), qid)
        assert bool(tr.found) == bool(jr.found)
        assert int(tr.entry) == int(jr.entry)
        assert int(tr.match_kf_id) == int(jr.match_kf_id)
        np.testing.assert_allclose(float(tr.score), float(jr.score), atol=SCORE_ATOL)
        assert int(tdb.last_match) == int(jdb.last_match)
        found.append(bool(tr.found))
    assert found[:3] == [True, True, False]


def test_verify_loop_matches(rng):
    jdb, tdb, descs, pts_all, poses = _build(rng, 16, 6, with_geometry=True)
    e = 2
    pose_true = poses[e]
    px, _, _ = observe(pose_true, JCAM, pts_all[e], noise_px=0.2, rng=rng)
    pose0 = pose_true.retract(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))
    q = perturb(rng, descs[e], bits=6)
    valid = np.ones(K, bool)
    jp, jok, jn = jdet.verify_loop(jdb, jnp.asarray(e), q, px, jnp.asarray(valid), JCAM, pose0)
    tp, tok, tn = tdet.verify_loop(tdb, torch.tensor(e), _desc_t(q), _t(px), _t(valid), TCAM,
                                   SE3(_t(pose0.q), _t(pose0.t)))
    assert bool(tok) == bool(jok) is True
    assert int(tn) == int(jn)
    _assert_pose(tp, jp, POSE_ATOL)


def test_relocalize_topk_with_injected_samples(rng):
    jdb, tdb, descs, pts_all, poses = _build(rng, 32, 20, with_geometry=True)
    target = 7
    pose_q = poses[target].retract(jnp.asarray(rng.normal(size=6) * 0.05, jnp.float32))
    _, bearings, _ = observe(pose_q, JCAM, pts_all[target], noise_px=0.3, rng=rng)
    q = perturb(rng, descs[target], bits=6)
    valid = np.ones(K, bool)
    key = jax.random.PRNGKey(1)
    j = jdet.relocalize_topk(jdb, q, bearings, jnp.asarray(valid), key, focal=500.0)

    # JAX draws entry j's P3P samples from split(key, 8)[j] over that
    # entry's match mask; the port's masks are the JAX ones (asserted by
    # the result), so the draws are reproduced from them
    tq, tb, tv = _desc_t(q), _t(bearings), _t(valid)
    D = tdb.desc.shape[0]
    dist = hamming_matrix_chunked(tq, tdb.desc.reshape(-1, 8)).float()
    ok = (tdb.kp_valid & tdb.lm_is3d & (tdb.kf_id >= 0)[:, None]).reshape(-1)
    dist = torch.where(ok[None, :] & tv[:, None], dist, 1e9)
    best, second, bi = tdet._top2_min(dist)
    m_ok = (best <= second * 0.8) & (best < 64.0)
    votes = torch.zeros(D).index_add_(0, bi // K, m_ok.float())
    entries = torch.sort(votes, descending=True, stable=True).indices[:8]
    keys = jax.random.split(key, 8)
    samples = []
    for jj in range(8):
        _, mask = tdet._match_entry(tdb, entries[jj], tq, tv, 0.8)
        idx, sok = jsample(keys[jj], jnp.asarray(mask.numpy()), 3, 100)
        samples.append((_t(idx).long(), _t(sok)))
    t = tdet.relocalize_topk(tdb, tq, tb, tv, None, focal=500.0, samples=samples)
    assert bool(t.success) == bool(j.success) is True
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    _assert_pose(t.pose, j.pose, POSE_ATOL)


# ---------------------------------------------------------------------------
# the port alone on the out-and-back sequence
# ---------------------------------------------------------------------------

CFG = SlamConfig(width=320, height=240, cell_size=24, window_size=10,
                 max_landmarks=512, ransac_iters=50, ba_iters=4,
                 init_parallax_px=12.0, kf_parallax_px=6.0)


@pytest.fixture(scope="module")
def loop_run():
    scene = TwoPlaneScene(np.random.default_rng(11), width=320, height=240, fov=60.0)
    gt = out_and_back(45)
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu",
                  enable_loop_closure=True, loop_delay=4)
    loops, poses, statuses = [], [], []
    for i in range(len(gt)):
        poses.append(slam.find_camera_pose(scene.render(gt[i]).astype(np.float32)))
        statuses.append(slam.last_status)
        if slam.last_loop is not None:
            loops.append((i, int(slam.last_loop.match_kf_id),
                          slam.last_loop_correction is not None))
    return gt, slam, poses, statuses, loops


def test_loop_e2e_tracks_and_detects(loop_run):
    """tests/test_loop_e2e.py's bars: more than 40 frames tracked, a loop
    detected in the return half, a correction applied."""
    gt, _, _, statuses, loops = loop_run
    assert statuses.count(1) > 40, statuses
    assert any(i >= len(gt) // 2 for i, _, _ in loops), loops
    assert any(corr for _, _, corr in loops), loops


def test_loop_e2e_terminal_drift(loop_run):
    gt, _, poses, statuses, _ = loop_run
    idx = [i for i, s in enumerate(statuses) if s == 1 and poses[i] is not None]
    est, g = np.stack([poses[i][:3, 3] for i in idx]), gt[idx][:, :3, 3]
    e, gg = est - est.mean(0), g - g.mean(0)
    U, S, Vt = np.linalg.svd(gg.T @ e / len(e))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((e * e).sum() / len(e), 1e-12)
    aligned = s * e @ R.T + g.mean(0)
    assert np.linalg.norm(aligned[-1] - g[-1]) < 0.05 * (2 * 45 * 0.04)


def test_loop_e2e_relocalize_from_cold_lost_state(loop_run):
    gt, slam, poses, statuses, _ = loop_run
    scene = TwoPlaneScene(np.random.default_rng(11), width=320, height=240, fov=60.0)
    for _ in range(6):
        slam.find_camera_pose(np.full((240, 320), 127.0, np.float32))
    revisit = 20
    slam.find_camera_pose(scene.render(gt[revisit]).astype(np.float32))
    T = slam.relocalize()
    assert T is not None, "relocalization failed on a revisited view"
    ref = next(poses[i] for i in range(revisit, revisit + 6)
               if statuses[i] == 1 and poses[i] is not None)
    est = np.stack([p[:3, 3] for p, s in zip(poses, statuses) if s == 1 and p is not None])
    span = np.linalg.norm(est.max(0) - est.min(0))
    assert np.linalg.norm(T[:3, 3] - ref[:3, 3]) < 0.05 * span
