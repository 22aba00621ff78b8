"""The port's single-stream slice against the JAX package.

The JAX AlvaAR runs once (one compile) over the 40-frame 320x240 scene of
tests/test_e2e.py with the slice's flags (8-point bootstrap, no
homography), and its MapState is snapshotted before every frame.

* Per step, with the state carried across: a snapshot goes into the port
  (map_state_from_numpy), the port runs one slam_step on the same frame,
  and its state is held against the JAX state after that frame — on a
  tracking frame and on a keyframe frame.
* Stage 2 of the KLT, compacted into 48 slots (the CPU's branch, as the
  JAX package's default) and at full width (the card's branch), from the
  same carried state: the same keypoints, validity and P3P request.
* End to end: the port alone over the 40 frames, held to test_e2e's bars
  and to the JAX trajectory; and the port alone under the default config
  (5-point and homography bootstrap), held to the same bars.
"""

import numpy as np
import pytest
import torch

from alvaar_tpu import AlvaAR as JAlvaAR, SlamConfig as JSlamConfig
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.frontend.step import slam_step
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.worldmap.state import map_state_from_numpy, map_state_to_numpy
from tests.render_scene import TwoPlaneScene, ate_rmse, trajectory

# one intra-op thread: the suite runs in several worker processes, and
# threads that outnumber the cores slow small-tensor ops many times over
torch.set_num_threads(1)

CFG_ARGS = dict(width=320, height=240, cell_size=24, window_size=10,
                max_landmarks=512, ransac_iters=50, ba_iters=4,
                init_parallax_px=25.0, use_five_point=False,
                use_homography_init=False)
CFG = SlamConfig(**CFG_ARGS)
N_FRAMES = 40


def _snapshot(state) -> dict:
    """JAX MapState → the numpy dict of map_state_from_numpy."""
    d = {}
    for name, v in state._asdict().items():
        if name in ("pose", "kf_pose"):
            d[name + ".q"], d[name + ".t"] = np.array(v.q), np.array(v.t)
        elif name == "prev_pyr":
            for i, level in enumerate(v):
                d[f"prev_pyr.{i}"] = np.array(level)
        else:
            d[name] = np.array(v)
    return d


@pytest.fixture(scope="module")
def frames():
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(N_FRAMES, step=0.04)
    return [scene.render(gt[i]).astype(np.float32) for i in range(N_FRAMES)], gt


@pytest.fixture(scope="module")
def jax_run(frames):
    imgs, _ = frames
    slam = JAlvaAR(320, 240, fov=60.0, config=JSlamConfig(**CFG_ARGS))
    snaps, outs, poses = [], [], []
    for img in imgs:
        snaps.append(_snapshot(slam.state))
        poses.append(slam.find_camera_pose(img))
        outs.append(np.array(slam._last_out._sync()))
    snaps.append(_snapshot(slam.state))
    return snaps, outs, poses


@pytest.fixture(scope="module")
def port_run(frames):
    imgs, _ = frames
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    poses, statuses = [], []
    for img in imgs:
        poses.append(slam.find_camera_pose(img))
        statuses.append(slam.last_status)
    return slam, poses, statuses


@pytest.fixture(scope="module")
def port_run_default(frames):
    imgs, _ = frames
    cfg = SlamConfig(**{**CFG_ARGS, "use_five_point": True, "use_homography_init": True})
    slam = AlvaAR(320, 240, fov=60.0, config=cfg, device="cpu")
    poses, statuses = [], []
    for img in imgs:
        poses.append(slam.find_camera_pose(img))
        statuses.append(slam.last_status)
    return slam, poses, statuses


def _step_from_snapshot(jax_run, frames, i):
    snaps, _, _ = jax_run
    cam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu").camera
    state = map_state_from_numpy(snaps[i], CFG, "cpu")
    state, out = slam_step(state, torch.from_numpy(frames[0][i]), cam, CFG)
    return map_state_to_numpy(state), out, snaps[i + 1]


def _tracking_frame(outs):
    first = next(i for i, o in enumerate(outs) if o[0] == 1)
    i = first + 5
    assert outs[i][0] == 1 and outs[i][19] < 0.5
    return i


def _keyframe_frame(outs):
    return next(i for i in range(1, len(outs))
                if outs[i][19] > 0.5 and outs[i - 1][0] == 1 and outs[i][0] == 1)


def _assert_step(a, out, b, jout):
    assert int(out.status) == int(jout[0])
    q_sign = np.sign(np.sum(a["pose.q"] * b["pose.q"]))
    np.testing.assert_allclose(a["pose.q"] * q_sign, b["pose.q"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(a["pose.t"], b["pose.t"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(a["kp_valid"], b["kp_valid"])
    v = b["kp_valid"]
    np.testing.assert_allclose(a["kp_px"][v], b["kp_px"][v], atol=1e-3, rtol=0)


def test_map_state_round_trip(jax_run):
    snap = jax_run[0][20]
    back = map_state_to_numpy(map_state_from_numpy(snap, CFG, "cpu"))
    for k, v in snap.items():
        if k != "rng_key":
            np.testing.assert_array_equal(back[k], v, err_msg=k)
            assert back[k].dtype == v.dtype, k


def test_step_parity_tracking_frame(jax_run, frames):
    i = _tracking_frame(jax_run[1])
    a, out, b = _step_from_snapshot(jax_run, frames, i)
    _assert_step(a, out, b, jax_run[1][i])
    assert not bool(out.is_keyframe)


def test_step_parity_keyframe_frame(jax_run, frames):
    i = _keyframe_frame(jax_run[1])
    a, out, b = _step_from_snapshot(jax_run, frames, i)
    _assert_step(a, out, b, jax_run[1][i])
    assert bool(out.is_keyframe)
    assert abs(int(a["lm_valid"].sum()) - int(b["lm_valid"].sum())) <= 2
    both3d = a["lm_valid"] & a["lm_is3d"] & b["lm_valid"] & b["lm_is3d"]
    assert both3d.sum() > 50
    np.testing.assert_allclose(a["lm_pos"][both3d], b["lm_pos"][both3d], atol=1e-3, rtol=0)


def test_stage2_full_width_equals_compaction(jax_run, frames, monkeypatch):
    snaps, outs, _ = jax_run
    i = _tracking_frame(outs)
    cam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu").camera
    state = map_state_from_numpy(snaps[i], CFG, "cpu")
    pyr_cur = tstep.preprocess(torch.from_numpy(frames[0][i]), CFG)
    prior = SE3.exp(-state.vel).compose(state.pose)
    compactions = []
    top_k = tstep.top_k
    monkeypatch.setattr(tstep, "top_k", lambda *a: compactions.append(1) or top_k(*a))
    a = tstep._track_keypoints(state, pyr_cur, prior, cam, CFG, allow_cond=True)
    b = tstep._track_keypoints(state, pyr_cur, prior, cam, CFG, allow_cond=False)
    assert compactions == [1]             # only the first call compacted
    assert torch.equal(a.kp_valid, b.kp_valid) and int(a.kp_valid.sum()) > 20
    assert torch.equal(a.kp_px, b.kp_px)
    assert torch.equal(a.p3p_req, b.p3p_req)


def _assert_e2e_bars(poses, statuses, gt):
    assert 1 in statuses and statuses.index(1) < 25, statuses
    assert 2 not in statuses, statuses
    idx = [i for i, s in enumerate(statuses) if s == 1]
    assert len(idx) >= 15
    est = np.stack([poses[i][:3, 3] for i in idx])
    gt_t = gt[idx][:, :3, 3]
    track_len = np.linalg.norm(gt_t[-1] - gt_t[0])
    assert ate_rmse(est, gt_t) < 0.01 * track_len


def test_port_end_to_end(port_run, frames):
    _, poses, statuses = port_run
    _assert_e2e_bars(poses, statuses, frames[1])


def test_port_end_to_end_default_config(port_run_default, frames):
    _, poses, statuses = port_run_default
    _assert_e2e_bars(poses, statuses, frames[1])


def test_port_trajectory_matches_jax(port_run, jax_run, frames):
    _, gt = frames
    _, poses, statuses = port_run
    _, outs, jposes = jax_run
    both = [i for i, s in enumerate(statuses) if s == 1 and outs[i][0] == 1]
    assert len(both) >= 15
    est = np.stack([poses[i][:3, 3] for i in both])
    ref = np.stack([jposes[i][:3, 3] for i in both])
    track_len = np.linalg.norm(gt[both[-1], :3, 3] - gt[both[0], :3, 3])
    assert ate_rmse(est, ref) < 0.01 * track_len


def test_port_frame_points(port_run):
    slam, _, _ = port_run
    pts = slam.get_frame_points()
    assert pts.shape[0] > 20 and pts.dtype == np.int32
    assert (pts[:, 0] >= 0).all() and (pts[:, 0] < 320).all()
