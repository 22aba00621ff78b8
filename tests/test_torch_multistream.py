"""Port parity of multi-stream serving (alvaar_tpu_torch/parallel/
multistream.py and the batched phases of frontend/step.py) against the JAX
package, on the CPU at small sizes.  JAX functions run op by op or as
small jitted phases; JAX's whole multistream step is never compiled.

* The stream-batched plain KLT ([B, H, W] levels) against per-stream
  calls, bit for bit.
* The batched track phase against ``jax.vmap(track_phase(defer_heavy=True))``
  on four carried states in one batch: first frame, initializing,
  tracking (port snapshots of the 320x240 scene, read into JAX), and one
  still waiting for its first keyframe, which resets.
* ``recovery_phase`` and ``init_essential_phase`` with the JAX draws
  injected.
* ``_gated_subbatch`` and the keyframe election against JAX's on
  tie-heavy flags; ``active``-masked rows unchanged bit for bit.
* The stacked state and loop databases to and from numpy.
* End to end: B = 4 streams sharing one keyframe slot track, keep at
  least 2 keyframes each and stay within 1.5x of the single-stream ATE
  (the bar of tests/test_multistream.py); the streams that lose frame
  0's election reset on frame 1, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.geom import Camera as JCamera
from alvaar_tpu.parallel import multistream as jms
from alvaar_tpu.solvers.ransac import sample_minimal as jsample
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.ops import klt as tklt
from alvaar_tpu_torch.ops import lk_level as tlk
from alvaar_tpu_torch.ops.image import build_pyramid as tpyr
from alvaar_tpu_torch.parallel import multistream as tms
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, ate_rmse, trajectory
from tests.test_image_ops import smooth_noise
from tests.test_torch_bootstrap import CFG_ARGS, jax_state_from_numpy
from tests.test_torch_solvers import _assert_pose, _t

torch.set_num_threads(1)

CFG = SlamConfig(**CFG_ARGS)
JCFG = JSlamConfig(**CFG_ARGS)
POSE_Q_ATOL, POSE_T_ATOL, PX_ATOL = 1e-5, 1e-4, 1e-3   # tests/test_torch_slice.py's bars
POSE_ATOL = 1e-4                                         # injected-sample phases


# ---------------------------------------------------------------------------
# The stream-batched KLT
# ---------------------------------------------------------------------------

def _stream_pairs(rng, b=3, h=120, w=160, k=24):
    """B streams: a smooth image, its copy shifted by a per-stream offset,
    and K points each."""
    prev, cur, pts = [], [], []
    for i in range(b):
        img = smooth_noise(rng, h, w)
        dx, dy = 1 + i, -1 + (i % 2)
        prev.append(img)
        cur.append(np.roll(img, (dy, dx), axis=(0, 1)))
        pts.append(rng.uniform([20, 20], [w - 20, h - 20], (k, 2)).astype(np.float32))
    return (torch.from_numpy(np.stack(prev)), torch.from_numpy(np.stack(cur)),
            torch.from_numpy(np.concatenate(pts)))


@pytest.mark.parametrize("fn", ["fb_klt_track", "klt_pyramidal"])
def test_batched_plain_klt_equals_per_stream(rng, fn):
    b, k = 3, 24
    prev, cur, pts = _stream_pairs(rng, b=b, k=k)
    valid = torch.ones(b * k, dtype=torch.bool)
    valid[::7] = False
    prior = pts + torch.tensor([1.5, -0.5])
    call = getattr(tklt, fn)
    args = dict(levels=3, win=9, iters=16, search_r=8)
    pyr_p, pyr_c = tpyr(prev, 3), tpyr(cur, 3)
    assert all(lv.is_contiguous() and lv.shape[0] == b for lv in pyr_p + pyr_c)
    whole = call(pyr_p, pyr_c, pts, prior, valid, **args)
    for i in range(b):
        s = slice(i * k, (i + 1) * k)
        one = call(tpyr(prev[i], 3), tpyr(cur[i], 3), pts[s], prior[s], valid[s], **args)
        assert torch.equal(whole.xy[s], one.xy)
        assert torch.equal(whole.status[s], one.status)
        assert torch.equal(whole.err[s], one.err)
    assert int(whole.status.sum()) > b * k // 2


def test_batched_pyramid_equals_per_stream(rng):
    frames = torch.from_numpy(np.stack([smooth_noise(rng, 96, 128) for _ in range(3)]))
    for i, lv in enumerate(tpyr(frames, 3)):
        for b in range(3):
            assert torch.equal(lv[b], tpyr(frames[b], 3)[i])


def test_kernel_checks_take_stream_stacks(rng):
    """The launch's checks take [B, H, W] levels with points grouped by
    stream, and refuse points that do not split over the streams."""
    prev, cur, pts = _stream_pairs(rng, b=3, k=8)
    pyr_p, pyr_c = tpyr(prev, 3), tpyr(cur, 3)
    valid = torch.ones(24, dtype=torch.bool)
    sched = tlk.klt_schedule(3, 8, 16)
    assert tlk.check_track_args(pyr_p, pyr_c, pts, pts, valid, sched, 9) == 3
    assert tlk.check_track_args([lv[0] for lv in pyr_p], [lv[0] for lv in pyr_c],
                                pts, pts, valid, sched, 9) == 1
    with pytest.raises(ValueError, match="split evenly"):
        tlk.check_track_args(pyr_p, pyr_c, pts[:23], pts[:23], valid[:23], sched, 9)
    with pytest.raises(ValueError, match="level 1"):
        tlk.check_track_args([pyr_p[0], pyr_p[1][:2]] + list(pyr_p[2:]),
                             [pyr_c[0], pyr_c[1][:2]] + list(pyr_c[2:]),
                             pts, pts, valid, sched, 9)


# ---------------------------------------------------------------------------
# Carried states: the port's single-stream run on the 320x240 scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_run():
    """Port snapshots before each of the first frames of the 320x240
    scene, the frames, and the statuses; through 3 frames of tracking."""
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(40, step=0.04)
    frames = [scene.render(gt[i]).astype(np.float32) for i in range(40)]
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    snaps, statuses = [], []
    for i in range(40):
        snaps.append(tstate.map_state_to_numpy(slam.state))
        slam.find_camera_pose(frames[i])
        statuses.append(slam.last_status)
        if statuses.count(1) == 4:
            return snaps, frames, statuses, slam.camera
    raise AssertionError(f"the port did not track: {statuses}")


def _rows(scene_run):
    """Frame indices of a first-frame, an initializing and a tracking
    state (the snapshot before that frame)."""
    _, _, st, _ = scene_run
    first_track = st.index(1)
    return [0, first_track - 3, first_track + 2]


def _jcam(cam: Camera):
    return JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy)


def _jax_stack(snaps):
    rows = [jax_state_from_numpy(d, JCFG) for d in snaps]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


# the JAX KLT unrolls its Gauss-Newton steps, so the comparison step runs
# 6 of them on both sides (the carried states come from the 16-step run):
# the JAX side then compiles in a third of the time
CMP_ARGS = {**CFG_ARGS, "klt_iters": 6}


def test_track_phase_batched_matches_jax(scene_run):
    snaps, frames, _, cam = scene_run
    idx = _rows(scene_run)
    # a fourth row: on its second frame with no detection yet (its first
    # keyframe was deferred), so the initializing branch resets it
    waiting = {**snaps[0], "frame_id": np.asarray(1, snaps[0]["frame_id"].dtype)}
    rows = [snaps[i] for i in idx] + [waiting]
    grays = np.stack([frames[i] for i in idx] + [frames[1]])
    dts = np.ones(4, np.float32)
    cfg, jcfg = SlamConfig(**CMP_ARGS), JSlamConfig(**CMP_ARGS)

    states = tstate.stack_states(tstate.map_state_from_numpy(d, cfg, "cpu") for d in rows)
    tout, tfl = tstep.track_phase_batched(states, torch.from_numpy(grays), cam, cfg,
                                          torch.from_numpy(dts))
    jcam = _jcam(cam)
    jout, jfl = jax.jit(jax.vmap(lambda s, f, dt: jstep.track_phase(s, f, jcam, jcfg, dt,
                                                                    defer_heavy=True)))(
        _jax_stack(rows), jnp.asarray(grays), jnp.asarray(dts))

    assert np.asarray(jout.frame_id).tolist() == [0, idx[1], idx[2], 1]
    assert np.asarray(jout.ready_for_init).tolist() == [False, False, True, False]
    assert np.asarray(jout.reset_requested).tolist() == [False, False, False, True]
    for name in ("kf_req", "p3p_need", "init_gate"):
        np.testing.assert_array_equal(getattr(tfl, name).numpy(), np.asarray(getattr(jfl, name)),
                                      err_msg=name)
    for name in ("kp_valid", "reset_requested", "p3p_req", "pose_failures"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), err_msg=name)
    q, jq = tout.pose.q.numpy(), np.asarray(jout.pose.q)
    sign = np.sign(np.sum(q * jq, axis=-1, keepdims=True))
    np.testing.assert_allclose(q * sign, jq, atol=POSE_Q_ATOL, rtol=0)
    np.testing.assert_allclose(tout.pose.t.numpy(), np.asarray(jout.pose.t), atol=POSE_T_ATOL,
                               rtol=0)
    v = np.asarray(jout.kp_valid)
    np.testing.assert_allclose(tout.kp_px.numpy()[v], np.asarray(jout.kp_px)[v], atol=PX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tout.vel.numpy(), np.asarray(jout.vel), atol=1e-4, rtol=0)
    assert v[2].sum() > 50 and not v[0].any()
    for i, lv in enumerate(tout.prev_pyr):
        assert torch.equal(lv, tpyr(torch.from_numpy(grays), CFG.pyramid_levels)[i])


def test_track_phase_batched_matches_single_stream(scene_run):
    """Each row of the three-stream batched phase is the single-stream
    ``track_phase(defer_heavy=True)`` (the batched phase on a one-stream
    stack) on that row: one stream's result does not depend on the others
    in the batch (bit for bit outside PnP, whose batched reductions may
    round differently)."""
    snaps, frames, _, cam = scene_run
    idx = _rows(scene_run)
    states = tstate.stack_states(tstate.map_state_from_numpy(snaps[i], CFG, "cpu") for i in idx)
    grays = torch.from_numpy(np.stack([frames[i] for i in idx]))
    out, fl = tstep.track_phase_batched(states, grays, cam, CFG, torch.ones(3))
    for j, i in enumerate(idx):
        one, ofl = tstep.track_phase(tstate.map_state_from_numpy(snaps[i], CFG, "cpu"),
                                     grays[j], cam, CFG, defer_heavy=True)
        assert one.kp_px.dim() == 2 and ofl.kf_req.dim() == 0
        row = tstate.state_row(out, j)
        for name in ("kf_req", "p3p_need", "init_gate"):
            assert bool(getattr(fl, name)[j]) == bool(getattr(ofl, name)), (j, name)
        assert torch.equal(row.kp_valid, one.kp_valid)
        assert torch.equal(row.kp_px, one.kp_px)
        assert torch.equal(row.reset_requested, one.reset_requested)
        torch.testing.assert_close(row.pose.t, one.pose.t, atol=POSE_T_ATOL, rtol=0)


def _jax_recovery_samples(d, cfg):
    key = jnp.asarray(d["rng_key"], jnp.uint32)
    _, sub = jax.random.split(key)
    lm = d["kp_lm"]
    is3d = d["kp_valid"] & d["lm_valid"][lm] & d["lm_is3d"][lm]
    idx, ok = jsample(sub, jnp.asarray(is3d), 3, cfg.ransac_iters)
    return _t(idx).long(), _t(ok)


def test_recovery_phase_matches_jax(scene_run):
    snaps, _, _, cam = scene_run
    d = snaps[_rows(scene_run)[2]]
    d = {**d, "pose_failures": np.int32(1)}
    jout = jax.jit(jstep.recovery_phase, static_argnames=("cfg",))(
        jax_state_from_numpy(d, JCFG), _jcam(cam), JCFG)
    tout = tstep.recovery_phase(tstate.map_state_from_numpy(d, CFG, "cpu"), cam, CFG,
                                samples=_jax_recovery_samples(d, CFG))
    _assert_pose(tout.pose, jout.pose, POSE_ATOL)
    np.testing.assert_array_equal(tout.kp_valid.numpy(), np.asarray(jout.kp_valid))
    assert int(tout.pose_failures) == int(jout.pose_failures) == 0
    assert bool(tout.reset_requested) == bool(jout.reset_requested)
    assert bool(tout.p3p_req) == bool(jout.p3p_req)


def test_init_essential_phase_matches_jax(scene_run):
    snaps, _, st, cam = scene_run
    d = snaps[st.index(1)]             # the bootstrap succeeds on this frame
    key = jnp.asarray(d["rng_key"], jnp.uint32)
    _, sub = jax.random.split(key)
    k_e, k_h = jax.random.split(sub)
    slot = int(d["cur_kf_slot"])
    same = jnp.asarray((d["kf_obs_lm"][slot] == d["kp_lm"]) & d["kf_obs_valid"][slot]
                       & d["kp_valid"])
    inject = lambda s: (_t(s[0]).long(), _t(s[1]))
    samples = (inject(jsample(k_e, same, 5, CFG.ransac_iters)),
               inject(jsample(k_h, same, 4, CFG.ransac_iters)))
    jout = jax.jit(jstep.init_essential_phase, static_argnames=("cfg",))(
        jax_state_from_numpy(d, JCFG), _jcam(cam), JCFG)
    tout = tstep.init_essential_phase(tstate.map_state_from_numpy(d, CFG, "cpu"), cam, CFG,
                                      samples=samples)
    assert bool(tout.ready_for_init) and bool(jout.ready_for_init)
    _assert_pose(tout.pose, jout.pose, POSE_ATOL)
    np.testing.assert_array_equal(tout.kp_valid.numpy(), np.asarray(jout.kp_valid))


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------

SMALL = dict(width=128, height=96, cell_size=32, window_size=4, max_landmarks=64,
             ransac_iters=8, ba_iters=1, pyramid_levels=2, klt_iters=4, min_init_keypoints=4)

FLAG_CASES = [
    ([1, 0, 1, 1, 0, 1], 2),
    ([1, 1, 1, 1, 1, 1], 3),
    ([0, 0, 0, 0, 0, 0], 2),
    ([0, 1, 0, 1, 0, 1], 10),
    ([1, 0, 0, 0, 0, 1], 1),
]


@pytest.mark.parametrize("flags,slots", FLAG_CASES)
def test_gated_subbatch_matches_jax(flags, slots):
    b = len(flags)
    jst = jms.init_multistream_state(JSlamConfig(**SMALL), b)
    jst = jst._replace(frame_id=jnp.arange(b, dtype=jnp.int32))
    tst = tstate.init_multistream_state(SlamConfig(**SMALL), b, device="cpu")
    tst = tst.replace(frame_id=torch.arange(b))

    jout, jserved = jms._gated_subbatch(
        jst, jnp.asarray(flags, bool),
        lambda s: s._replace(frame_id=s.frame_id * 10 + 1, vel=s.vel + 1.0), slots)
    tout, tserved = tms._gated_subbatch(
        tst, torch.tensor(flags, dtype=torch.bool),
        lambda s: s.replace(frame_id=s.frame_id * 10 + 1, vel=s.vel + 1.0), slots)
    np.testing.assert_array_equal(tserved.numpy(), np.asarray(jserved))
    np.testing.assert_array_equal(tout.frame_id.numpy(), np.asarray(jout.frame_id))
    np.testing.assert_array_equal(tout.vel.numpy(), np.asarray(jout.vel))


def _jax_kf_election(kf_req, became_ready, pending, reset, next_kf_id, active, kf_slots):
    """alvaar_tpu/parallel/multistream.py's election (lines 199-209) on
    plain arrays."""
    req = (kf_req | became_ready | pending) & ~reset & active
    urgent = req & (next_kf_id <= 1)
    score = (req.astype(jnp.float32) + 2.0 * pending.astype(jnp.float32)
             + 4.0 * urgent.astype(jnp.float32))
    _, idx = jax.lax.top_k(score, min(kf_slots, score.shape[0]))
    return req, idx, score[idx] > 0.0


@pytest.mark.parametrize("seed", range(6))
def test_keyframe_election_matches_jax(seed):
    """Random tie-heavy request, pending, urgent and reset vectors: the
    port elects the same streams, and pending requests and bootstrap
    keyframes come first."""
    r = np.random.default_rng(seed)
    b, slots = 8, 1 + seed % 3
    kf_req, became, pending, reset, active = (r.random(b) < p for p in (0.5, 0.2, 0.3, 0.15, 0.8))
    next_kf_id = r.integers(0, 4, b)
    jreq, jidx, jlive = _jax_kf_election(*(jnp.asarray(a) for a in
                                           (kf_req, became, pending, reset, next_kf_id, active)),
                                         slots)
    t = lambda a: torch.from_numpy(np.asarray(a))
    treq, score = tms._kf_request(t(kf_req), t(became), t(pending), t(reset), t(next_kf_id),
                                  t(active))
    tidx, tlive = tms._elect(score, slots)
    np.testing.assert_array_equal(treq.numpy(), np.asarray(jreq))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    chosen = set(tidx[tlive].tolist())
    urgent = np.asarray(jreq) & (next_kf_id <= 1)
    if urgent.sum() <= slots:
        assert set(np.flatnonzero(urgent)) <= chosen


def _advance(states, frames, cam, cfg, steps, active=None):
    step = tms.make_multistream_step(cfg, cam, kf_slots=2)
    for n in range(steps):
        states, out = step(states, frames[n], active=active)
    return states, out


@pytest.fixture(scope="module")
def small_run():
    cfg = SlamConfig(**SMALL)
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    r = np.random.default_rng(1)
    tex = smooth_noise(r, cfg.height, cfg.width)
    frames = np.stack([np.stack([np.roll(tex, n + b, axis=1) for b in range(3)])
                       for n in range(4)]).astype(np.float32)
    states = tstate.init_multistream_state(cfg, 3, seed=7, device="cpu")
    states, _ = _advance(states, frames, cam, cfg, 3)
    return states, frames, cam, cfg


def test_inactive_rows_unchanged(small_run):
    states, frames, cam, cfg = small_run
    before = tstate.multistream_state_to_numpy(states)
    gen_before = [g.get_state().clone() for g in states.rng]
    active = torch.tensor([True, False, True])
    out_states, out = _advance(states, frames[3:], cam, cfg, 1, active=active)
    after = tstate.multistream_state_to_numpy(out_states)
    for k in before:
        np.testing.assert_array_equal(after[k][1], before[k][1], err_msg=k)
    assert torch.equal(out_states.rng[1].get_state(), gen_before[1])
    assert (after["frame_id"][[0, 2]] == before["frame_id"][[0, 2]] + 1).all()


def test_generators_distinct_per_stream():
    states = tstate.init_multistream_state(SlamConfig(**SMALL), 4, seed=3, device="cpu")
    draws = [torch.rand(4, generator=g).tolist() for g in states.rng]
    assert len({tuple(d) for d in draws}) == 4
    again = tstate.init_multistream_state(SlamConfig(**SMALL), 4, seed=3, device="cpu")
    assert [torch.rand(4, generator=g).tolist() for g in again.rng] == draws


def test_row_helpers(small_run):
    states = small_run[0]
    sub = tstate.stack_states(tstate.state_row(states, i) for i in [2, 0])
    assert torch.equal(sub.kp_px[0], states.kp_px[2]) and sub.rng[0] is states.rng[2]
    row = tstate.state_row(states, 1)
    assert row.kp_px.data_ptr() == states.kp_px[1].data_ptr() and row.rng is states.rng[1]
    back = tstate.write_rows(states, [2, 0], sub, mask=[False, True])
    assert torch.equal(back.kf_obs_px, states.kf_obs_px)   # row 0 written with itself
    swapped = tstate.write_rows(states, [1], tstate.stack_states([tstate.state_row(states, 2)]))
    assert torch.equal(swapped.prev_pyr[0][1], states.prev_pyr[0][2])
    assert torch.equal(swapped.prev_pyr[0][0], states.prev_pyr[0][0])
    assert swapped.rng[1] is states.rng[2]


# ---------------------------------------------------------------------------
# Carrying state across
# ---------------------------------------------------------------------------

def _jax_tree_numpy(states):
    """A stacked JAX MapState as the {name: ndarray} dict of the port."""
    d = {}
    for name, v in states._asdict().items():
        if name in ("pose", "kf_pose"):
            d[name + ".q"], d[name + ".t"] = np.asarray(v.q), np.asarray(v.t)
        elif name == "prev_pyr":
            for i, level in enumerate(v):
                d[f"prev_pyr.{i}"] = np.asarray(level)
        else:
            d[name] = np.asarray(v)
    return d


def test_multistream_state_round_trip(small_run):
    states = small_run[0]
    d = tstate.multistream_state_to_numpy(states)
    back = tstate.multistream_state_to_numpy(tstate.multistream_state_from_numpy(
        d, SlamConfig(**SMALL), "cpu"))
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_jax_multistream_state_round_trip():
    jst = jms.init_multistream_state(JSlamConfig(**SMALL), 3, seed=5)
    jst = jst._replace(frame_id=jnp.arange(3, dtype=jnp.int32),
                       kp_px=jnp.asarray(np.random.default_rng(0).normal(size=jst.kp_px.shape),
                                         jnp.float32))
    d = _jax_tree_numpy(jst)
    back = tstate.multistream_state_to_numpy(
        tstate.multistream_state_from_numpy(d, SlamConfig(**SMALL), "cpu"))
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_loopdbs_round_trip():
    jdbs = jms.init_multistream_loopdbs(JSlamConfig(**SMALL), 3, capacity=8)
    r = np.random.default_rng(2)
    jdbs = jdbs._replace(kf_id=jnp.asarray(r.integers(-1, 9, (3, 8)), jnp.int32),
                         desc=jnp.asarray(r.integers(0, 2 ** 32, jdbs.desc.shape, np.uint32)))
    d = {k: np.asarray(v) for k, v in jdbs._asdict().items()}
    tdbs = tms.loopdbs_from_numpy(d, "cpu")
    back = tms.loopdbs_to_numpy(tdbs)
    for k in back:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    fresh = tms.loopdbs_to_numpy(tms.init_multistream_loopdbs(SlamConfig(**SMALL), 3, 8, "cpu"))
    for k in fresh:
        np.testing.assert_array_equal(
            fresh[k], np.asarray(getattr(jms.init_multistream_loopdbs(JSlamConfig(**SMALL), 3,
                                                                      capacity=8), k)))


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

E2E = dict(width=240, height=180, cell_size=20, window_size=8, max_landmarks=320,
           ransac_iters=40, ba_iters=2, pyramid_levels=2, init_parallax_px=15.0,
           min_init_keypoints=10)


def test_multistream_ate_bounded_vs_single():
    """tests/test_multistream.py's accuracy bar on the port: stream 0 of 4
    streams sharing one keyframe slot stays within 1.5x of the
    single-stream ATE; every stream tracks and keeps >= 2 keyframes; three
    election reads per step whatever B.  Streams whose first keyframe the
    election deferred reset on the next frame, as in the JAX package."""
    cfg = SlamConfig(**E2E)
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    scene = TwoPlaneScene(np.random.default_rng(5), width=cfg.width, height=cfg.height,
                          fov=60.0, tex_scale=120.0)
    n = 30
    gt = trajectory(n, step=0.05)
    frames = np.stack([scene.render(gt[i]) for i in range(n)]).astype(np.float32)

    def run(b, kf_slots):
        seq = np.stack([np.roll(frames, -k, axis=0) for k in range(b)], axis=1)
        states = tstate.init_multistream_state(cfg, b, device="cpu")
        s0 = tms.multistream_step_local.syncs
        states, (st, po) = tms.make_multistream_scan(cfg, cam, kf_slots=kf_slots)(
            states, seq, np.ones((n, b), np.float32))
        assert tms.multistream_step_local.syncs - s0 == 3 * n
        st, po = st.numpy(), po.numpy()
        assert st.shape == (n, b) and po.shape == (n, b, 4, 4)
        for k in range(b):
            assert 1 in st[:, k], f"stream {k} never tracked: {st[:, k]}"
        assert (states.kf_valid.sum(dim=1) >= 2).all(), states.kf_valid.sum(dim=1)
        idx = np.where(st[:, 0] == 1)[0]
        assert len(idx) >= 12, f"tracked {len(idx)}/{n}"
        return ate_rmse(po[idx, 0][:, :3, 3], gt[idx][:, :3, 3]), st

    ate_single, _ = run(1, 1)
    ate_multi, st = run(4, 1)
    assert ate_multi <= 1.5 * ate_single + 1e-4, (ate_multi, ate_single)
    # frame 0's one slot serves stream 0; the others, still without a
    # detection, reset on frame 1
    assert st[1].tolist() == [3, 2, 2, 2], st.T


def test_loop_closure_step_runs(small_run):
    """The loop-closure step: databases fill at keyframe cadence inside the
    keyframe sub-batch, and inactive rows keep their database."""
    _, frames, cam, cfg = small_run
    states = tstate.init_multistream_state(cfg, 3, device="cpu")
    dbs = tms.init_multistream_loopdbs(cfg, 3, capacity=8, device="cpu")
    step = tms.make_multistream_step(cfg, cam, kf_slots=2, loop_closure=True, loop_delay=1)
    active = torch.tensor([True, True, False])
    for n in range(3):
        states, dbs, out = step(states, dbs, frames[n], active=active)
    assert out.status.shape == (3,)
    assert int(dbs.ptr[0]) >= 1 and int(dbs.ptr[1]) >= 1 and int(dbs.ptr[2]) == 0
    assert int(states.frame_id[2]) == 0


def test_scan_with_loop_closure(small_run):
    """``make_multistream_scan(loop_closure=True)`` carries the databases
    through the frames and returns [N, B] statuses and poses."""
    _, frames, cam, cfg = small_run
    run = tms.make_multistream_scan(cfg, cam, kf_slots=2, loop_closure=True, loop_delay=1)
    (states, dbs), (st, po) = run(tstate.init_multistream_state(cfg, 3, device="cpu"),
                                  frames, None,
                                  tms.init_multistream_loopdbs(cfg, 3, capacity=8, device="cpu"))
    assert st.shape == (4, 3) and po.shape == (4, 3, 4, 4)
    assert (dbs.ptr >= 1).all() and states.frame_id.shape == (3,)
