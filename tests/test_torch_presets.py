"""The FAST and ACCURATE presets (config.py, the reference AlvaAR's own
presets from state.hpp) on the port against the JAX package, on the CPU.

* The port's ``AlvaAR`` under FAST, AVERAGE and ACCURATE at the cut of
  tests/test_system_extra.py (``small``), on 3 frames.
* The presets' grids, and the KLT schedules their iterations give, admitted
  by the kernel's launch checks at 640x480 (N = 130 and 352).
* The plain KLT level pass and ``fb_klt_track`` at 20 and 30 Gauss-Newton
  steps against the JAX package's XLA path, at tests/test_pallas_klt.py's
  bars.
* ``track_phase``, ``recovery_phase`` and ``init_essential_phase`` (with
  the JAX package's RANSAC draws injected through ``samples=``) and
  ``keyframe_phase`` under each preset's cell size, hypothesis count and
  BA iterations, from carried states of the port's own run, against the
  JAX package's jitted phases.  The cut: a 10-keyframe window, 512
  landmarks and ``init_parallax_px`` 25, as the other port tests at
  320x240 (tests/test_torch_bootstrap.py ``CFG_ARGS``), on the scene of
  tests/test_torch_subbatch.py; ACCURATE at 320x240 (its 30 px cells give
  11 x 8 = 88 keypoints), FAST at 480x360 (10 x 8 = 80; at 320x240 its
  50 px cells leave 7 x 5 = 35, under ``min_init_keypoints`` = 50, so
  every frame would reset).  The step comparisons run 6
  KLT Gauss-Newton steps on both sides (the JAX KLT unrolls its steps
  into the compile, as tests/test_torch_configs.py says); the level-pass
  tests above hold the presets' 20 and 30.

Run as a script, the module prints the bars chip_smoke.py holds the card's
golden runs to: the JAX package's ``AlvaAR`` on the CPU under a preset over
the 120 golden frames (``JAX_PLATFORMS=cpu python -m
tests.test_torch_presets FAST ACCURATE``; ``CLAHE``: the default config
with ``use_clahe=True``, ``CLAHE:1`` the same with seed 1); with
``--port``, the port's ``AlvaAR`` on the CPU over the same frames.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alvaar_tpu.config as jcfg
import alvaar_tpu_torch.config as tcfg
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.ops import klt as jklt
from alvaar_tpu.ops.image import build_pyramid as jpyr
from alvaar_tpu.solvers.ransac import sample_minimal as jsample
from alvaar_tpu_torch import AlvaAR
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.ops import klt as tklt
from alvaar_tpu_torch.ops import lk_level as tlk
from alvaar_tpu_torch.ops.image import build_pyramid as tpyr
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, ate_rmse, trajectory
from tests.test_torch_bootstrap import jax_state_from_numpy
from tests.test_torch_configs import _assert_tracked, _jax_numpy, _jcam
from tests.test_torch_klt import _assert_level, _inputs, _pair, _torch
from tests.test_torch_multistream import POSE_ATOL, _jax_recovery_samples
from tests.test_torch_solvers import _assert_pose, _t
from tests.test_torch_subbatch import _assert_rows_close

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

PRESETS = {"FAST": (jcfg.FAST, tcfg.FAST), "ACCURATE": (jcfg.ACCURATE, tcfg.ACCURATE)}
SIZES = {"FAST": (480, 360), "ACCURATE": (320, 240)}    # >= 50 keypoints each
N_FRAMES = 48
CMP_KLT_ITERS = 6


def small(base, **kw):
    """tests/test_system_extra.py's cut."""
    return dataclasses.replace(
        base, width=192, height=128, cell_size=24, window_size=4,
        max_landmarks=128, ransac_iters=16, ba_iters=2, pyramid_levels=2,
        min_init_keypoints=8, init_parallax_px=12.0, **kw)


def _cfgs(name, **kw):
    """The JAX package's and the port's preset ``name`` cut to its size
    in SIZES, its cell size, KLT iterations, hypotheses and BA iterations
    kept (the module docstring's cut)."""
    w, h = SIZES[name]
    return tuple(dataclasses.replace(cfg, width=w, height=h, window_size=10,
                                     max_landmarks=512, init_parallax_px=25.0, **kw)
                 for cfg in PRESETS[name])


@pytest.mark.parametrize("name", ["FAST", "AVERAGE", "ACCURATE"])
def test_presets_run(name, rng):
    cfg = small(getattr(tcfg, name))
    slam = AlvaAR(192, 128, config=cfg, device="cpu")
    scene = TwoPlaneScene(rng, width=192, height=128, fov=60.0)
    gt = trajectory(3, step=0.05)
    for i in range(3):
        slam.find_camera_pose(scene.render(gt[i]))
    assert slam.last_status in (1, 2, 3)


@pytest.mark.parametrize("name,grid,k", [("FAST", (10, 13), 130), ("ACCURATE", (16, 22), 352)])
def test_preset_grid_and_kernel_schedule(name, grid, k):
    """At 640x480: FAST's 50 px cells pad the last row and column of the
    grid (neither 480 nor 640 is a multiple of 50), ACCURATE's 30 px
    cells pad the last column.  Both KLT stages' schedules at the preset's
    iterations (backward pass min(iters, 12)) pass the kernel's launch
    checks at N = K."""
    jc, tc = PRESETS[name]
    assert (tc.grid_cells, tc.max_keypoints) == (jc.grid_cells, jc.max_keypoints) == (grid, k)
    assert tc.height % tc.cell_size or tc.width % tc.cell_size
    pyr = [torch.zeros(hw) for hw in tc.pyr_shapes]
    pts = torch.zeros((k, 2))
    valid = torch.ones(k, dtype=torch.bool)
    for levels, r in ((tc.klt_prior_levels, 4), (tc.pyramid_levels, 8)):
        sched = tlk.klt_schedule(levels, r, tc.klt_iters)
        assert sched[-1] == (0, 2, min(tc.klt_iters, 12), True)
        assert [p[2] for p in sched[:-1]] == [tc.klt_iters] * levels
        assert tlk.check_track_args(pyr, pyr, pts, pts, valid, sched, tc.klt_window) == 1
    cut = _cfgs(name)[1]
    assert cut.max_keypoints >= cut.min_init_keypoints


# (search_r, iters): the presets' passes, stage 1, stage 2 and backward
@pytest.mark.parametrize("search_r,iters", [(4, 20), (8, 20), (4, 30), (8, 30)])
def test_plain_level_pass_matches_jax(rng, search_r, iters):
    img0, img1, pts, guess, valid = _inputs(rng, search_r)
    j = jklt._lk_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                       jnp.asarray(guess), jnp.asarray(valid), win=9, iters=iters,
                       eps=0.01, search_r=search_r, use_pallas=False)
    t = tlk.lk_level_plain(*_torch(img0, img1, pts, guess, valid), win=9,
                           iters=iters, eps=0.01, search_r=search_r)
    _assert_level(t, j)


@pytest.mark.parametrize("levels,search_r", [(1, 4), (3, 8)])
@pytest.mark.parametrize("iters", [20, 30])
def test_fb_klt_track_matches_jax_at_preset_iters(rng, levels, search_r, iters):
    img0, img1, pts = _pair(rng, 240, 320, shift=(2.6, -1.7))
    valid = np.ones(len(pts), bool)
    valid[5] = False
    prior = (pts + np.float32([-2.2, 1.4])).astype(np.float32)
    args = dict(levels=levels, win=9, iters=iters, eps=0.01, err_max=30.0,
                fb_dist=0.5, search_r=search_r)
    j = jklt.fb_klt_track(jpyr(jnp.asarray(img0), 3), jpyr(jnp.asarray(img1), 3),
                          jnp.asarray(pts), jnp.asarray(prior), jnp.asarray(valid),
                          use_pallas=False, **args)
    t0, t1, tp, tq, tv = _torch(img0, img1, pts, prior, valid)
    t = tklt.fb_klt_track(tpyr(t0, 3), tpyr(t1, 3), tp, tq, tv, **args)
    _assert_level((t.xy, t.status, t.err), (j.xy, j.status, j.err))


# ---------------------------------------------------------------------------
# The phases under each preset, from carried states of the port's run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(PRESETS))
def preset_run(request):
    """The port's single stream under a preset's cut on the 320x240
    scene until its first keyframe past the bootstrap pair: the preset's
    name, snapshots before each frame, the frames, statuses and the
    camera."""
    name = request.param
    cfg = _cfgs(name)[1]
    w, h = SIZES[name]
    scene = TwoPlaneScene(np.random.default_rng(42), width=w, height=h, fov=60.0)
    gt = trajectory(N_FRAMES, step=0.04)
    slam = AlvaAR(w, h, fov=60.0, config=cfg, device="cpu")
    snaps, frames, st, kf = [], [], [], []
    for i in range(N_FRAMES):
        frames.append(scene.render(gt[i]).astype(np.float32))
        snaps.append(tstate.map_state_to_numpy(slam.state))
        slam.find_camera_pose(frames[i])
        st.append(slam.last_status)
        kf.append(slam.last_is_keyframe)
        if st[-1] == 1 and kf[-1] and 1 in st[:-1]:
            return name, snaps, frames, st, slam.camera
    raise AssertionError(f"{name}: no keyframe past the bootstrap: {st} {kf}")


def test_track_phase_matches_jax(preset_run):
    """A carried tracking frame's track phase (both KLT stages, PnP) at
    the preset's cell size, CMP_KLT_ITERS Gauss-Newton steps, with the
    P3P recovery and the bootstrap deferred (they are compared below):
    the JAX compile of the whole phase takes 40 s at 6 steps."""
    name, snaps, frames, st, cam = preset_run
    jc, tc = _cfgs(name, klt_iters=CMP_KLT_ITERS)
    i = st.index(1) + 2
    assert st[i] == 1
    tout, tfl = tstep.track_phase(tstate.map_state_from_numpy(snaps[i], tc, "cpu"),
                                  torch.from_numpy(frames[i]), cam, tc, defer_heavy=True)
    jcam = _jcam(cam)
    jout, jfl = jax.jit(lambda s, f: jstep.track_phase(s, f, jcam, jc, defer_heavy=True))(
        jax_state_from_numpy(snaps[i], jc), jnp.asarray(frames[i]))
    for flag in ("kf_req", "p3p_need", "init_gate"):
        assert bool(getattr(tfl, flag)) == bool(getattr(jfl, flag)), flag
    n = _assert_tracked(tstate.map_state_to_numpy(tout), _jax_numpy(jout), f"{name} track")
    assert n > 0.6 * tc.max_keypoints and bool(jout.ready_for_init)


def test_recovery_phase_matches_jax(preset_run):
    """P3P-LMedS recovery with the preset's hypotheses (50 / 200), the JAX
    draws injected."""
    name, snaps, _, st, cam = preset_run
    jc, tc = _cfgs(name)
    d = {**snaps[st.index(1) + 3], "pose_failures": np.int32(1)}
    samples = _jax_recovery_samples(d, tc)
    assert samples[0].shape[0] == tc.ransac_iters
    jout = jax.jit(jstep.recovery_phase, static_argnames=("cfg",))(
        jax_state_from_numpy(d, jc), _jcam(cam), jc)
    tout = tstep.recovery_phase(tstate.map_state_from_numpy(d, tc, "cpu"), cam, tc,
                                samples=samples)
    _assert_pose(tout.pose, jout.pose, POSE_ATOL)
    np.testing.assert_array_equal(tout.kp_valid.numpy(), np.asarray(jout.kp_valid))
    assert int(tout.pose_failures) == int(jout.pose_failures) == 0
    assert bool(tout.reset_requested) == bool(jout.reset_requested)


def test_init_essential_phase_matches_jax(preset_run):
    """The 5-point / homography bootstrap on the frame where it succeeds,
    with the preset's hypotheses, the JAX draws injected."""
    name, snaps, _, st, cam = preset_run
    jc, tc = _cfgs(name)
    d = snaps[st.index(1)]
    _, sub = jax.random.split(jnp.asarray(d["rng_key"], jnp.uint32))
    k_e, k_h = jax.random.split(sub)
    slot = int(d["cur_kf_slot"])
    same = jnp.asarray((d["kf_obs_lm"][slot] == d["kp_lm"]) & d["kf_obs_valid"][slot]
                       & d["kp_valid"])
    inject = lambda s: (_t(s[0]).long(), _t(s[1]))
    samples = (inject(jsample(k_e, same, 5, tc.ransac_iters)),
               inject(jsample(k_h, same, 4, tc.ransac_iters)))
    jout = jax.jit(jstep.init_essential_phase, static_argnames=("cfg",))(
        jax_state_from_numpy(d, jc), _jcam(cam), jc)
    tout = tstep.init_essential_phase(tstate.map_state_from_numpy(d, tc, "cpu"), cam, tc,
                                      samples=samples)
    assert bool(tout.ready_for_init) and bool(jout.ready_for_init)
    _assert_pose(tout.pose, jout.pose, POSE_ATOL)
    np.testing.assert_array_equal(tout.kp_valid.numpy(), np.asarray(jout.kp_valid))


def test_keyframe_phase_matches_jax(preset_run):
    """The first keyframe past the bootstrap pair: detection at the
    preset's cell size, triangulation, matching and local BA at the
    preset's iterations (3 / 10)."""
    name, snaps, frames, st, cam = preset_run
    jc, tc = _cfgs(name)
    i = len(st) - 1
    state, flags = tstep.track_phase(tstate.map_state_from_numpy(snaps[i], tc, "cpu"),
                                     torch.from_numpy(frames[i]), cam, tc)
    assert bool(flags.kf_req) and int(state.next_kf_id) >= 2
    d = tstate.map_state_to_numpy(state)
    tout = tstate.map_state_to_numpy(tstep.keyframe_phase(state, cam, tc))
    jcam = _jcam(cam)
    ref = _jax_numpy(jax.jit(lambda s: jstep.keyframe_phase(s, jcam, jc))(
        jax_state_from_numpy(d, jc)))
    n3d = _assert_rows_close({k: tout[k] for k in ref}, ref, f"{name} keyframe")
    assert n3d > 0.5 * tc.max_keypoints, n3d


# ---------------------------------------------------------------------------
# The bars of chip_smoke.py phase 11a (run as a script)
# ---------------------------------------------------------------------------

def golden_frames(n=None):
    """The 640x480 golden sequence (tests/golden/ref_synthetic_640.npz's
    seed and poses) from the numpy renderer, and its ground truth."""
    from pathlib import Path
    g = np.load(Path(__file__).parent / "golden" / "ref_synthetic_640.npz")
    gt = g["gt"] if n is None else g["gt"][:n]
    scene = TwoPlaneScene(np.random.default_rng(int(g["seed"])), width=640, height=480,
                          fov=60.0, tex_scale=120.0)
    return [scene.render(T).astype(np.float32) for T in gt], gt


def golden_bars(statuses, poses, gt):
    """Frames at status 1, the first of them, resets and the sim3-aligned
    ATE in cm: the numbers chip_smoke.py holds a preset's run to."""
    tracked = [i for i, s in enumerate(statuses) if s == 1]
    est = np.stack([poses[i][:3, 3] for i in tracked])
    return dict(tracked=len(tracked), first=tracked[0] if tracked else None,
                resets=sum(1 for s in statuses if s == 2),
                ate_cm=100.0 * ate_rmse(est, gt[tracked][:, :3, 3]))


def preset_config(mod, preset):
    """The config module ``mod``'s preset ``preset``; ``CLAHE`` names the
    default config with ``use_clahe=True``, ``CLAHE:<seed>`` the same with
    that RANSAC seed."""
    name, _, seed = preset.partition(":")
    if name == "CLAHE":
        return mod.SlamConfig(use_clahe=True, seed=int(seed or 0))
    return getattr(mod, preset)


def golden_run_bars(preset, port=False):
    """The JAX package's AlvaAR (or with ``port`` the port's) on the CPU
    under ``preset`` (a name of config.py's, or ``CLAHE``) over the 120
    golden frames."""
    import time
    from alvaar_tpu import AlvaAR as JAlvaAR
    jax.config.update("jax_platforms", "cpu")
    frames, gt = golden_frames()
    if port:
        slam = AlvaAR(640, 480, fov=60.0, config=preset_config(tcfg, preset), device="cpu")
    else:
        slam = JAlvaAR(640, 480, fov=60.0, config=preset_config(jcfg, preset))
    statuses, poses = [], []
    t0 = time.time()
    for f in frames:
        poses.append(slam.find_camera_pose(f))
        statuses.append(slam.last_status)
    bars = golden_bars(statuses, poses, gt)
    bars["statuses"] = "".join(str(s) for s in statuses)
    bars["seconds"] = round(time.time() - t0, 1)
    return bars


if __name__ == "__main__":
    port = "--port" in sys.argv
    for name in (a for a in sys.argv[1:] if a != "--port"):
        print("port" if port else "jax", name, golden_run_bars(name, port), flush=True)
