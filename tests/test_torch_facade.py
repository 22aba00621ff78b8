"""Port parity of the rest of the single-stream facade against the JAX
package: checkpoints both ways, ``apply_world_correction``,
``find_plane_ransac`` with injected samples, the IMU pose,
``get_map_points``, ``pose_to_three``; and, port alone, ``process_frames``
and the async path against ``find_camera_pose``.  The map snapshot comes
from the port's own run over the 320x240 scene of tests/test_torch_slice.py
under the default config, handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu import AlvaAR as JAlvaAR
from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.geom.lie import quat_conj as jquat_conj, quat_to_matrix as jquat_to_matrix
from alvaar_tpu.io import checkpoint as jckpt
from alvaar_tpu.solvers.plane import find_plane_ransac as jfind_plane
from alvaar_tpu.solvers.ransac import sample_minimal as jsample
from alvaar_tpu.system import pose_to_three as jpose_to_three
from alvaar_tpu.worldmap.state import apply_world_correction as japply
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.io import checkpoint as tckpt
from alvaar_tpu_torch.solvers.plane import find_plane_ransac
from alvaar_tpu_torch.system import PendingResult, pose_to_three
from alvaar_tpu_torch.worldmap.state import (
    apply_world_correction,
    map_state_from_numpy,
    map_state_to_numpy,
)
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.synthetic_scene import random_pose
from tests.test_torch_bootstrap import CFG_ARGS, jax_state_from_numpy
from tests.test_torch_solvers import _assert_pose, _t

# one intra-op thread: the suite runs in several worker processes, and
# threads that outnumber the cores slow small-tensor ops many times over
torch.set_num_threads(1)

CFG = SlamConfig(**CFG_ARGS)
JCFG = JSlamConfig(**CFG_ARGS)
N_FRAMES = 40
N_SEQ = 24             # frames of the process_frames / async comparisons
POSE_ATOL = 1e-4
PLANE_ATOL = 1e-4      # plane normal and pose
IMU_ATOL = 1e-6        # the IMU rotation


@pytest.fixture(scope="module")
def frames():
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(N_FRAMES, step=0.04)
    return [scene.render(gt[i]).astype(np.float32) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def port_run(frames):
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    poses, statuses = [], []
    for img in frames:
        poses.append(slam.find_camera_pose(img))
        statuses.append(slam.last_status)
    assert statuses.count(1) >= 15, statuses
    return slam, poses, statuses, map_state_to_numpy(slam.state)


def _assert_leaves_equal(a: dict, b: dict, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_port_to_jax(port_run, tmp_path):
    snap = port_run[3]
    path = str(tmp_path / "port.npz")
    tckpt.save_map(path, map_state_from_numpy(snap, CFG, "cpu"), CFG)
    jst = jckpt.load_map(path, JCFG)
    names = tckpt._leaf_names(CFG)
    leaves = jax.tree.leaves(jst)
    assert len(leaves) == len(names) == 39
    _assert_leaves_equal({n: v for n, v in zip(names, leaves)}, snap, names)


def test_checkpoint_jax_to_port(port_run, tmp_path):
    snap = port_run[3]
    path = str(tmp_path / "jax.npz")
    jckpt.save_map(path, jax_state_from_numpy(snap, JCFG), JCFG)
    back = map_state_to_numpy(tckpt.load_map(path, CFG, "cpu"))
    _assert_leaves_equal(back, snap, tckpt._leaf_names(CFG))
    assert tckpt.saved_config(path) == CFG


def test_checkpoint_shape_mismatch(port_run, tmp_path):
    path = str(tmp_path / "port.npz")
    tckpt.save_map(path, map_state_from_numpy(port_run[3], CFG, "cpu"), CFG)
    other = dataclasses.replace(CFG, max_landmarks=256)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_map(path, other, "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.load_map(path, JSlamConfig(**{**CFG_ARGS, "max_landmarks": 256}))


def test_save_load_resumes_tracking(port_run, frames, tmp_path):
    """A saved map loads into a fresh instance, which keeps tracking the
    next frames of the sequence; the generator state comes back too."""
    slam = port_run[0]
    path = str(tmp_path / "resume.npz")
    slam.save_map(path)
    fresh = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    fresh.load_map(path)
    _assert_leaves_equal(map_state_to_numpy(fresh.state), port_run[3],
                         tckpt._leaf_names(CFG) + ["rng_state"])
    for img in frames[-4:][::-1]:          # step back along the path
        assert fresh.find_camera_pose(img) is not None
        assert fresh.last_status == 1


# ---------------------------------------------------------------------------
# world correction, plane, points, IMU, Three.js pose
# ---------------------------------------------------------------------------

def test_apply_world_correction(port_run, rng):
    snap = port_run[3]
    dT = random_pose(rng)
    for scale in (None, 1.3):
        j = japply(jax_state_from_numpy(snap, JCFG), dT, scale=scale)
        t = apply_world_correction(map_state_from_numpy(snap, CFG, "cpu"),
                                   SE3(_t(dT.q), _t(dT.t)), scale=scale)
        _assert_pose(t.pose, j.pose, POSE_ATOL)
        _assert_pose(t.kf_pose, j.kf_pose, POSE_ATOL)
        np.testing.assert_allclose(t.lm_pos.numpy(), np.asarray(j.lm_pos), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(t.lm_invd.numpy(), np.asarray(j.lm_invd), atol=0, rtol=1e-6)


def _tabletop(rng, n):
    """A dominant plane at z = 3 (normal +z) and clutter in front of it."""
    pts = np.empty((n, 3), np.float32)
    flat = rng.random(n) < 0.7
    pts[:, 0] = rng.uniform(-2, 2, n)
    pts[:, 1] = rng.uniform(-1.5, 1.5, n)
    pts[:, 2] = np.where(flat, 3.0 + rng.normal(0, 0.005, n), rng.uniform(1.0, 2.8, n))
    return pts


@pytest.mark.parametrize("cam_z", [0.0, 6.0])
def test_find_plane_ransac_with_injected_samples(cam_z):
    rng = np.random.default_rng(5)
    pts = _tabletop(rng, 512)
    valid = np.ones(512, bool)
    valid[::13] = False
    cam_c = np.array([0.1, -0.2, cam_z], np.float32)
    key = jax.random.PRNGKey(0)
    idx, ok = jsample(key, jnp.asarray(valid), 3, 250)
    j = jax.jit(jfind_plane)(key, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(cam_c))
    t = find_plane_ransac(None, _t(pts), _t(valid), _t(cam_c),
                          samples=(_t(idx).long(), _t(ok)))
    assert bool(t.success) == bool(j.success) is True
    np.testing.assert_allclose(t.normal.numpy(), np.asarray(j.normal), atol=PLANE_ATOL, rtol=0)
    _assert_pose(t.pose, j.pose, PLANE_ATOL)
    assert np.sign(t.normal.numpy()[2]) == np.sign(cam_z - 3.0)


def test_find_plane_facade(port_run):
    """On the synthetic two-plane map the gauge is the estimate's, so the
    answer may be None; a pose must be a finite rigid transform."""
    T = port_run[0].find_plane()
    if T is not None:
        assert T.shape == (4, 4) and np.isfinite(T).all()
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-5)


def test_get_map_points(port_run):
    snap = port_run[3]
    jslam = JAlvaAR(320, 240, fov=60.0, config=JCFG)
    jslam.state = jax_state_from_numpy(snap, JCFG)
    tslam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    tslam.state = map_state_from_numpy(snap, CFG, "cpu")
    (jp, jc), (tp, tc) = jslam.get_map_points(), tslam.get_map_points()
    assert tp.shape[0] > 50 and tc.dtype == np.uint8
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tslam.get_map_points(colored=False), jp)


def test_pose_to_three(port_run):
    T = next(p for p in port_run[1] if p is not None)
    for a, b in zip(pose_to_three(T), jpose_to_three(T)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_imu_pose(frames, port_run):
    """The rotation is the mirrored, inverted device quaternion; the
    translation sums the SLAM translation deltas while tracking."""
    rng = np.random.default_rng(3)
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    _, poses, statuses, _ = port_run
    acc, prev = np.zeros(3), None
    for i in range(20):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        T = slam.find_camera_pose_with_imu(frames[i], q, motion=np.zeros(6))
        R = np.asarray(jquat_to_matrix(jquat_conj(jnp.asarray([q[0], -q[1], q[2], q[3]]))))
        np.testing.assert_allclose(T[:3, :3], R, atol=IMU_ATOL, rtol=0)
        assert slam.last_status == statuses[i]
        if statuses[i] == 1:
            t = poses[i][:3, 3]
            if prev is not None:
                acc += t - prev
            prev = t
        else:
            prev = None
        np.testing.assert_allclose(T[:3, 3], acc.astype(np.float32), atol=1e-6)
    assert statuses[:20].count(1) >= 3
    slam.reset()
    assert not slam._imu_translation.any() and slam._imu_prev_slam_t is None


# ---------------------------------------------------------------------------
# process_frames and the async path, port alone
# ---------------------------------------------------------------------------

def test_process_frames_equals_find_camera_pose(frames, port_run):
    _, poses, statuses, _ = port_run
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    st, po = slam.process_frames(np.stack(frames[:N_SEQ]), chunk=10)
    assert st.dtype == np.int32 and po.shape == (N_SEQ, 4, 4)
    np.testing.assert_array_equal(st, statuses[:N_SEQ])
    for i in range(N_SEQ):
        if st[i] == 1:
            np.testing.assert_allclose(po[i], poses[i], atol=1e-6, rtol=0)


def test_async_and_drain_equal_find_camera_pose(frames, port_run):
    _, poses, statuses, _ = port_run
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    pending = []
    for i in range(N_SEQ):
        pending.append(slam.find_camera_pose_async(frames[i]))
        if len(pending) % 5 == 0:
            PendingResult.drain(pending[-5:])
    PendingResult.drain(pending)
    for i, r in enumerate(pending):
        assert r.status == statuses[i]
        if r.status == 1:
            np.testing.assert_allclose(r.pose, poses[i], atol=1e-6, rtol=0)
    assert pending[-1].num_tracked > 20 and pending[-1].frame_points().shape[1] == 2
    assert slam.last_status == statuses[N_SEQ - 1]
