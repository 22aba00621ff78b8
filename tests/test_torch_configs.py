"""BASELINE configurations 5 and 4 on the port against the JAX package, on
the CPU at small sizes.

Configuration 5 is ``hd_serving()``: a grid cell that scales with the
width and KLT from pyramid level 1.  Here it is ``hd_serving(800, 450)``:
the 1080p preset's grid (20 x 12 cells, 240 keypoints, the bottom row of
cells padded past the image's edge, 450 not being a multiple of the 40 px
cell), KLT on levels 1-2 (400x225 and 200x113), detection at 800x450 and
ORB on level 1.  It is cut to a 10-keyframe window, 512 landmarks, 50
RANSAC hypotheses and 4 BA iterations (the sizes of the other port
tests).  The carried states come from the port's own single-stream run
on the JAX bench's 1080p scene (seed 7, ``tex_scale`` 120) rendered at
800x450; the comparison steps run 6 KLT Gauss-Newton steps on both sides,
as tests/test_torch_multistream.py does, since the JAX KLT unrolls them
into its compile.

* (a) ``track_phase`` on one stream (the facade's path) from a carried
  tracking state, against the JAX package's jitted ``track_phase``.
* (b) ``track_phase_batched`` on a two-stream stack (tracking and
  initializing) against a jitted ``jax.vmap`` of JAX's
  ``track_phase(defer_heavy=True)``.
* (c) ``keyframe_phase`` (``create_keyframe``) on the first keyframe and
  on the first keyframe past the bootstrap (triangulation, matching,
  local BA) against JAX's jitted ``keyframe_phase``.
* (d) Configuration 4's pool: ``local_ba`` with a 10240-landmark pool
  (a few hundred live landmarks at scattered pool ids, projected through
  the window's poses plus noise) against JAX's ``local_ba``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.config import hd_serving as jhd_serving
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.geom import SE3 as JSE3, Camera as JCamera
from alvaar_tpu.solvers.ba import BAProblem as JBAProblem, local_ba as jlocal_ba
from alvaar_tpu_torch import AlvaAR
from alvaar_tpu_torch.config import hd_serving
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.solvers import ba as tba
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_torch_bootstrap import jax_state_from_numpy
from tests.test_torch_solvers import _assert_pose, _t, _tse3
from tests.test_torch_subbatch import _assert_rows_close

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

WIDTH, HEIGHT = 800, 450
CUTS = dict(window_size=10, max_landmarks=512, ransac_iters=50, ba_iters=4)
CFG = dataclasses.replace(hd_serving(WIDTH, HEIGHT), **CUTS)
CMP = dict(CUTS, klt_iters=6)
CMP_CFG = dataclasses.replace(hd_serving(WIDTH, HEIGHT), **CMP)
JCMP_CFG = dataclasses.replace(jhd_serving(WIDTH, HEIGHT), **CMP)
# tests/test_torch_slice.py's carried-step bars; keypoint positions in
# native pixels (twice the level-1 KLT's)
POSE_Q_ATOL, POSE_T_ATOL, PX_ATOL = 1e-5, 1e-4, 1e-4
N_FRAMES = 48


def test_hd_config_is_the_1080p_grid():
    """800x450 under hd_serving has 1080p's grid: 20 x 12 cells, the last
    row padded, KLT on levels 1-2."""
    full = hd_serving()
    assert (full.cell_size, full.grid_cells, full.max_keypoints) == (96, (12, 20), 240)
    assert (CFG.cell_size, CFG.grid_cells, CFG.max_keypoints) == (40, (12, 20), 240)
    assert CFG.height % CFG.cell_size and full.height % full.cell_size
    assert CFG.track_base_level == full.track_base_level == 1
    assert CFG.pyr_shapes[1:] == ((225, 400), (113, 200))
    assert dataclasses.asdict(CMP_CFG) == dataclasses.asdict(JCMP_CFG)


@pytest.fixture(scope="module")
def hd_run():
    """The port's single stream at CFG until its first keyframe past the
    bootstrap pair: snapshots before each frame, the frames, statuses,
    keyframe flags and the camera."""
    scene = TwoPlaneScene(np.random.default_rng(7), width=WIDTH, height=HEIGHT, fov=60.0,
                          tex_scale=120.0)
    gt = trajectory(N_FRAMES, step=0.04)
    slam = AlvaAR(WIDTH, HEIGHT, fov=60.0, config=CFG, device="cpu")
    snaps, frames, st, kf = [], [], [], []
    for i in range(N_FRAMES):
        frames.append(scene.render(gt[i]).astype(np.float32))
        snaps.append(tstate.map_state_to_numpy(slam.state))
        slam.find_camera_pose(frames[i])
        st.append(slam.last_status)
        kf.append(slam.last_is_keyframe)
        if st[-1] == 1 and kf[-1] and 1 in st[:-1]:
            return snaps, frames, st, kf, slam.camera
    raise AssertionError(f"no keyframe past the bootstrap: {st} {kf}")


def _jcam(cam: Camera):
    return JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy)


def _status(reset, ready):
    """finalize_phase's status rule: 2 on a reset, else 1 tracking, 3
    initializing."""
    return np.where(reset, 2, np.where(ready, 1, 3))


def _assert_tracked(t: dict, j: dict, tag):
    """One stream after the track phase (numpy dicts) at the bars."""
    for name in ("kp_valid", "reset_requested", "ready_for_init", "p3p_req", "pose_failures"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=f"{tag}: {name}")
    assert _status(t["reset_requested"], t["ready_for_init"]) == \
        _status(j["reset_requested"], j["ready_for_init"])
    q, jq = t["pose.q"], j["pose.q"]
    np.testing.assert_allclose(q * np.sign(np.sum(q * jq)), jq, atol=POSE_Q_ATOL, rtol=0,
                               err_msg=f"{tag}: pose.q")
    np.testing.assert_allclose(t["pose.t"], j["pose.t"], atol=POSE_T_ATOL, rtol=0,
                               err_msg=f"{tag}: pose.t")
    v = j["kp_valid"]
    np.testing.assert_allclose(t["kp_px"][v], j["kp_px"][v], atol=PX_ATOL, rtol=0,
                               err_msg=f"{tag}: kp_px")
    return int(v.sum())


def _jax_numpy(state, row=None) -> dict:
    """A JAX MapState (row ``row`` of a stack) as the port's numpy names,
    the pyramid and key left out."""
    d = {}
    for name, v in state._asdict().items():
        pick = (lambda a: np.asarray(a)) if row is None else (lambda a: np.asarray(a)[row])
        if name in ("pose", "kf_pose"):
            d[name + ".q"], d[name + ".t"] = pick(v.q), pick(v.t)
        elif name not in ("prev_pyr", "rng_key"):
            d[name] = pick(v)
    return d


def _tracking_frame(st):
    i = st.index(1) + 2
    assert st[i] == 1
    return i


def test_track_phase_base_level1_matches_jax(hd_run, monkeypatch):
    """(a) The single-stream track phase from a carried tracking state:
    KLT on levels 1-2 at half the keypoints' coordinates, merged back at
    twice the level-1 positions."""
    snaps, frames, st, _, cam = hd_run
    i = _tracking_frame(st)
    shapes = []
    fb = tstep.fb_klt_track
    monkeypatch.setattr(tstep, "fb_klt_track", lambda p, c, *a, **kw: shapes.append(
        tuple(tuple(lv.shape) for lv in p)) or fb(p, c, *a, **kw))
    state = tstate.map_state_from_numpy(snaps[i], CMP_CFG, "cpu")
    tout, tfl = tstep.track_phase(state, torch.from_numpy(frames[i]), cam, CMP_CFG)
    assert shapes == [((225, 400), (113, 200))] * 2     # stage 1, stage 2

    jcam = _jcam(cam)
    jout, jfl = jax.jit(lambda s, f: jstep.track_phase(s, f, jcam, JCMP_CFG))(
        jax_state_from_numpy(snaps[i], JCMP_CFG), jnp.asarray(frames[i]))
    assert bool(tfl.kf_req) == bool(jfl.kf_req)
    n = _assert_tracked(tstate.map_state_to_numpy(tout), _jax_numpy(jout), "track_phase")
    assert n > 100 and bool(jout.ready_for_init)
    np.testing.assert_allclose(tout.vel.numpy(), np.asarray(jout.vel), atol=1e-4, rtol=0)


def test_track_phase_batched_base_level1_matches_jax(hd_run):
    """(b) The batched track phase on a tracking and an initializing
    stream, one stack, against JAX's vmapped deferred track phase."""
    snaps, frames, st, _, cam = hd_run
    idx = [_tracking_frame(st), st.index(1) - 3]
    rows = [snaps[i] for i in idx]
    grays = np.stack([frames[i] for i in idx])
    dts = np.ones(2, np.float32)
    states = tstate.stack_states(tstate.map_state_from_numpy(d, CMP_CFG, "cpu") for d in rows)
    tout, tfl = tstep.track_phase_batched(states, torch.from_numpy(grays), cam, CMP_CFG,
                                          torch.from_numpy(dts))
    jcam = _jcam(cam)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *(jax_state_from_numpy(d, JCMP_CFG) for d in rows))
    jout, jfl = jax.jit(jax.vmap(lambda s, f, dt: jstep.track_phase(
        s, f, jcam, JCMP_CFG, dt, defer_heavy=True)))(jstack, jnp.asarray(grays),
                                                      jnp.asarray(dts))
    assert np.asarray(jout.ready_for_init).tolist() == [True, False]
    for name in ("kf_req", "p3p_need", "init_gate"):
        np.testing.assert_array_equal(getattr(tfl, name).numpy(),
                                      np.asarray(getattr(jfl, name)), err_msg=name)
    for j in range(2):
        n = _assert_tracked(tstate.map_state_to_numpy(tstate.state_row(tout, j)),
                            _jax_numpy(jout, j), f"row {j}")
        assert n > 100, (j, n)
    np.testing.assert_allclose(tout.vel.numpy(), np.asarray(jout.vel), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def kf_rows(hd_run):
    """The port's states after the track phase of frame 0 (the first
    keyframe) and of the first keyframe past the bootstrap, as numpy
    dicts."""
    snaps, frames, st, kf, cam = hd_run
    rows = []
    for i in (0, len(st) - 1):
        state = tstate.map_state_from_numpy(snaps[i], CMP_CFG, "cpu")
        state, flags = tstep.track_phase(state, torch.from_numpy(frames[i]), cam, CMP_CFG)
        assert bool(flags.kf_req), i
        rows.append(tstate.map_state_to_numpy(state))
    assert int(rows[0]["next_kf_id"]) == 0 and int(rows[1]["next_kf_id"]) >= 2
    return rows


def test_keyframe_phase_base_level1_matches_jax(hd_run, kf_rows):
    """(c) The keyframe pipeline: detection at 800x450 (the padded bottom
    row of cells included), ORB on level 1 at half the positions, and on
    the second row triangulation, local-map matching and local BA.
    Descriptors are held equal bit for bit (on the CPU both sides compute
    ORB in float32: no near-tie bits)."""
    cam = hd_run[4]
    jcam = _jcam(cam)
    jfn = jax.jit(lambda s: jstep.keyframe_phase(s, jcam, JCMP_CFG))
    for j, d in enumerate(kf_rows):
        tout = tstep.keyframe_phase(tstate.map_state_from_numpy(d, CMP_CFG, "cpu"), cam, CMP_CFG)
        t = tstate.map_state_to_numpy(tout)
        ref = _jax_numpy(jfn(jax_state_from_numpy(d, JCMP_CFG)))
        n3d = _assert_rows_close({k: t[k] for k in ref}, ref, f"keyframe row {j}")
        new = t["lm_valid"] & ~d["lm_valid"]
        np.testing.assert_array_equal(t["lm_desc"][new], ref["lm_desc"][new])
        assert n3d > 50 or j == 0, (j, n3d)
        if j == 0:
            # every keypoint a fresh detection, inside the border (off the
            # padded bottom row of cells)
            assert new.sum() > 150, int(new.sum())
            v = t["kp_valid"]
            assert (t["kp_px"][v, 1] < HEIGHT - CMP_CFG.image_border).all()


# ---------------------------------------------------------------------------
# (d) local BA with configuration 4's 10240-landmark pool
# ---------------------------------------------------------------------------

BA_W, BA_K, BA_L = 10, 240, 10240
BA_CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def _ba_problem(seed=0, px_noise=0.3, pose_noise=0.02, depth_noise=0.05):
    """A consistent window: a forward-moving ring of BA_W keyframes, BA_K
    landmarks at distinct random ids of a BA_L pool, each seen by every
    keyframe in its column, anchored at one of the first half of the
    window; the rest of the pool valid with random parameters and never
    observed.  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    q = np.zeros((BA_W, 4))
    ang = 0.01 * np.arange(BA_W)
    q[:, 0], q[:, 2] = np.cos(ang / 2), np.sin(ang / 2)            # about y
    c = np.stack([0.15 * np.arange(BA_W), 0.01 * np.arange(BA_W), np.zeros(BA_W)], -1)

    def rot(qq, v):
        w, u = qq[..., :1], qq[..., 1:]
        t = 2 * np.cross(u, v)
        return v + w * t + np.cross(u, t)

    t = -rot(q, c)                                               # T_cw: R (X - c)
    pts = np.stack([rng.uniform(-3, 4, BA_K), rng.uniform(-2, 2, BA_K),
                    rng.uniform(4, 9, BA_K)], -1)
    ids = rng.choice(BA_L, BA_K, replace=False)
    anchor = rng.integers(0, BA_W // 2, BA_L)
    mxy = rng.normal(0, 0.3, (BA_L, 2))
    invd = 1.0 / rng.uniform(2, 8, BA_L)
    X_a = rot(q[anchor[ids]], pts) + t[anchor[ids]]
    mxy[ids], invd[ids] = X_a[:, :2] / X_a[:, 2:], 1.0 / X_a[:, 2]
    X_c = rot(q[:, None], pts[None]) + t[:, None]                  # [W, K, 3]
    px = np.stack([BA_CAM["fx"] * X_c[..., 0] / X_c[..., 2] + BA_CAM["cx"],
                   BA_CAM["fy"] * X_c[..., 1] / X_c[..., 2] + BA_CAM["cy"]], -1)
    px += rng.normal(0, px_noise, px.shape)
    constant = np.arange(BA_W) < 2
    dq = rng.normal(0, pose_noise, (BA_W, 3)) * ~constant[:, None]
    q0 = q.copy()
    q0[:, 1:] += 0.5 * dq
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    t0 = t + rng.normal(0, pose_noise, (BA_W, 3)) * ~constant[:, None]
    invd0 = invd.copy()
    invd0[ids] *= 1.0 + rng.normal(0, depth_noise, BA_K)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(q=f32(q0), t=f32(t0), kf_valid=np.ones(BA_W, bool), constant=constant,
                anchor_kf=anchor.astype(np.int32), anchor_mxy=f32(mxy), invdepth=f32(invd0),
                lm_valid=np.ones(BA_L, bool),
                obs_lm=np.tile(ids[None], (BA_W, 1)).astype(np.int32), obs_px=f32(px),
                obs_valid=(X_c[..., 2] > 0.1) & (rng.random((BA_W, BA_K)) < 0.9))


def test_local_ba_10240_landmark_pool_matches_jax():
    p = _ba_problem()
    assert p["obs_valid"].sum() > 0.8 * BA_W * BA_K
    jprob = JBAProblem(
        poses=JSE3(jnp.asarray(p["q"]), jnp.asarray(p["t"])), kf_valid=jnp.asarray(p["kf_valid"]),
        constant=jnp.asarray(p["constant"]), anchor_kf=jnp.asarray(p["anchor_kf"]),
        anchor_mxy=jnp.asarray(p["anchor_mxy"]), invdepth=jnp.asarray(p["invdepth"]),
        lm_valid=jnp.asarray(p["lm_valid"]), obs_lm=jnp.asarray(p["obs_lm"]),
        obs_px=jnp.asarray(p["obs_px"]), obs_valid=jnp.asarray(p["obs_valid"]))
    j = jlocal_ba(jprob, JCamera.create(*BA_CAM.values()), iters=5, refine_iters=2)
    tprob = tba.BAProblem(
        poses=_tse3(jprob.poses), kf_valid=_t(p["kf_valid"]), constant=_t(p["constant"]),
        anchor_kf=_t(p["anchor_kf"], torch.int64), anchor_mxy=_t(p["anchor_mxy"]),
        invdepth=_t(p["invdepth"]), lm_valid=_t(p["lm_valid"]),
        obs_lm=_t(p["obs_lm"], torch.int64), obs_px=_t(p["obs_px"]),
        obs_valid=_t(p["obs_valid"]))
    t = tba.local_ba(tprob, Camera.create(*BA_CAM.values()), iters=5, refine_iters=2)
    # tests/test_torch_solvers.py test_local_ba_matches' bars
    _assert_pose(t.poses, j.poses)
    np.testing.assert_allclose(t.invdepth.numpy(), np.asarray(j.invdepth), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    # the unobserved pool is left as it was; the solve moved the observed
    untouched = np.ones(BA_L, bool)
    untouched[p["obs_lm"][0]] = False
    assert np.array_equal(t.invdepth.numpy()[untouched], p["invdepth"][untouched])
    assert float(t.cost) < 2 * (2 * 0.3 ** 2) * p["obs_valid"].sum()
    assert np.isfinite(t.poses.q.numpy()).all() and np.isfinite(float(t.cost))
