"""A landmark in two keypoint columns, held against the JAX package.

A landmark keeps its keypoint column from detection until its track is
lost.  When the local-map matching later re-finds it, it is merged into
the young landmark of another column (``worldmap/matching.py``), so the
keyframes before the merge observe it in its old column and those after
in the new one.  Local BA gives it one virtual landmark, with its own
inverse depth, per column, and its write-back sets the landmark's depth
from each: the colliding writes keep the last one (the highest flat
[keyframe, column] index), as a serial loop and the JAX package's scatter
on the CPU do.  On CUDA ``index_put_`` would leave them in no order.

* On a synthetic window with one landmark moved to a second column, the
  port's ``local_ba`` equals JAX's, and keeping the first write instead
  would not.
* On the 320x240 scene, from the tracked state of the first keyframe
  whose local BA holds a merged landmark, the batched keyframe phase
  equals JAX's vmapped ``keyframe_phase``, at tests/test_torch_subbatch.py's
  bars, and again keeping the first write would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.geom import Camera as JCamera
from alvaar_tpu.solvers.ba import local_ba as jlocal_ba
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera as TCamera
from alvaar_tpu_torch.solvers import ba as tba
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_ba import CAM as BA_CAM, W as BA_W, build_problem
from tests.test_torch_bootstrap import CFG_ARGS, jax_state_from_numpy
from tests.test_torch_solvers import _t, _tse3
from tests.test_torch_subbatch import _assert_rows_close

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

CFG = SlamConfig(**CFG_ARGS)
JCFG = JSlamConfig(**CFG_ARGS)
N_FRAMES = 80
INVD_ATOL = 1e-4       # tests/test_torch_solvers.py's local BA bar


_last_wins = tstate.masked_scatter_set


def _first_wins(arr, idx, values, mask):
    """masked_scatter_set keeping the first of colliding writes."""
    return _last_wins(arr, idx.flip(0), values.flip(0), mask.flip(0))


def _two_column_landmarks(obs_lm, obs_ok):
    """Landmarks that ``obs_ok`` observations [W, K] place in more than one column."""
    cols = {}
    for w, k in zip(*np.nonzero(obs_ok)):
        cols.setdefault(int(obs_lm[w, k]), set()).add(int(k))
    return sorted(l for l, c in cols.items() if len(c) > 1)


@pytest.mark.parametrize("a,b", [(3, 40), (40, 3)])
def test_local_ba_merged_landmark_keeps_the_last_column(a, b, monkeypatch):
    prob, _, _ = build_problem(np.random.default_rng(0))
    rows = np.arange(BA_W) >= BA_W // 2     # landmark a re-found in column b
    lm, px, ok = (np.array(prob.obs_lm), np.array(prob.obs_px), np.array(prob.obs_valid))
    lm[rows, b], px[rows, b], ok[rows, b] = a, px[rows, a], ok[rows, a]
    ok[rows, a] = False
    assert _two_column_landmarks(lm, ok) == [a]
    prob = prob._replace(obs_lm=jnp.asarray(lm), obs_px=jnp.asarray(px),
                         obs_valid=jnp.asarray(ok))
    j = np.asarray(jlocal_ba(prob, BA_CAM, iters=5, refine_iters=2).invdepth)
    tprob = tba.BAProblem(
        poses=_tse3(prob.poses), kf_valid=_t(prob.kf_valid),
        constant=_t(prob.constant), anchor_kf=_t(prob.anchor_kf, torch.int64),
        anchor_mxy=_t(prob.anchor_mxy), invdepth=_t(prob.invdepth),
        lm_valid=_t(prob.lm_valid), obs_lm=_t(prob.obs_lm, torch.int64),
        obs_px=_t(prob.obs_px), obs_valid=_t(prob.obs_valid))
    cam = TCamera.create(float(BA_CAM.fx), float(BA_CAM.fy), float(BA_CAM.cx),
                         float(BA_CAM.cy))
    last = tba.local_ba(tprob, cam, iters=5, refine_iters=2).invdepth.numpy()
    np.testing.assert_allclose(last, j, atol=INVD_ATOL, rtol=0)
    monkeypatch.setattr(tba, "masked_scatter_set", _first_wins)
    first = tba.local_ba(tprob, cam, iters=5, refine_iters=2).invdepth.numpy()
    assert abs(first[a] - j[a]) > INVD_ATOL, (first[a], j[a])
    np.testing.assert_array_equal(np.delete(first, a), np.delete(last, a))


@pytest.fixture(scope="module")
def merged_row():
    """The tracked state (numpy) of the first keyframe on the 320x240 scene
    after which a live 3D landmark is observed in two columns, and the
    camera."""
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(N_FRAMES, step=0.04)
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    for i in range(N_FRAMES):
        frame = scene.render(gt[i]).astype(np.float32)
        snap = tstate.map_state_to_numpy(slam.state)
        slam.find_camera_pose(frame)
        s = tstate.map_state_to_numpy(slam.state)
        live = s["lm_valid"] & s["lm_is3d"]
        ok = s["kf_obs_valid"] & live[s["kf_obs_lm"]] & s["kf_valid"][:, None]
        if slam.last_is_keyframe and _two_column_landmarks(s["kf_obs_lm"], ok):
            state = tstate.map_state_from_numpy(snap, CFG, "cpu")
            state, flags = tstep.track_phase(state, torch.from_numpy(frame), slam.camera, CFG)
            assert bool(flags.kf_req), i
            return tstate.map_state_to_numpy(state), slam.camera
    raise AssertionError(f"no merged landmark in {N_FRAMES} frames")


def test_keyframe_phase_with_a_merged_landmark_matches_jax(merged_row, monkeypatch):
    row, cam = merged_row
    jcam = JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy)
    jst = jax.tree.map(lambda x: x[None], jax_state_from_numpy(row, JCFG))
    jout = jax.jit(jax.vmap(lambda s: jstep.keyframe_phase(s, jcam, JCFG)))(jst)
    ref = {}
    for name, v in jout._asdict().items():
        if name in ("pose", "kf_pose"):
            ref[name + ".q"], ref[name + ".t"] = np.asarray(v.q)[0], np.asarray(v.t)[0]
        elif name not in ("prev_pyr", "rng_key"):
            ref[name] = np.asarray(v)[0]
    live = ref["lm_valid"] & ref["lm_is3d"]
    ok = ref["kf_obs_valid"] & live[ref["kf_obs_lm"]] & ref["kf_valid"][:, None]
    merged = _two_column_landmarks(ref["kf_obs_lm"], ok)
    assert merged

    def port():
        out = tstep.keyframe_phase_batched(
            tstate.stack_states([tstate.map_state_from_numpy(row, CFG, "cpu")]), cam, CFG)
        b = tstate.map_state_to_numpy(tstate.state_row(out, 0))
        return {k: b[k] for k in ref}

    b = port()
    assert _assert_rows_close(b, ref, "vs JAX") > 50
    np.testing.assert_allclose(b["lm_invd"][merged], ref["lm_invd"][merged],
                               atol=INVD_ATOL, rtol=0)
    monkeypatch.setattr(tba, "masked_scatter_set", _first_wins)
    first = port()
    assert np.abs(first["lm_invd"][merged] - ref["lm_invd"][merged]).max() > INVD_ATOL
