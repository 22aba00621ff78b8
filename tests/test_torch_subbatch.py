"""The gated sub-batches of multi-stream serving as one batched pass
(alvaar_tpu_torch/parallel/multistream.py, the batched phases of
frontend/step.py), on the CPU at the 320x240 size of the other port tests.

* The keyframe phase on a stack of three keyframe-requesting rows (a first
  keyframe, the bootstrap pair's second, a steady-state keyframe that runs
  local BA) against ``keyframe_phase`` on each row alone, and against a
  jitted ``jax.vmap(keyframe_phase)`` of the JAX package.
* P3P recovery and the bootstrap on two rows with per-row draws: the same
  states as the row path and the same generator states afterwards.
* The keyframe pipeline with loop closure on three rows and their
  databases against ``loopclosure_phase`` per row.
* A B = 4 step that serves two keyframes reads the host at most 4 times
  and runs each gated phase once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.frontend import step as jstep
from alvaar_tpu.geom import Camera as JCamera
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.parallel import multistream as tms
from alvaar_tpu_torch.worldmap import keyframe as tkf
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_image_ops import smooth_noise
from tests.test_torch_bootstrap import CFG_ARGS, jax_state_from_numpy

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

CFG = SlamConfig(**CFG_ARGS)
JCFG = JSlamConfig(**CFG_ARGS)
POSE_Q_ATOL, POSE_T_ATOL, POS_ATOL = 1e-5, 1e-4, 1e-3   # tests/test_torch_slice.py's bars
LM_VALID_SLACK = 2                                      # landmarks whose lm_valid may differ
# The bootstrap pair's landmarks lie about 14 baselines deep: there the
# JAX package's own jitted and op-by-op keyframe phases differ by up to
# 2.7e-3 in lm_pos (median 2.4e-3) on this row, so the port is held to
# that spread against JAX, and to POS_ATOL on the other rows
PAIR_POS_ATOL = 3e-3


@pytest.fixture(scope="module")
def scene_run():
    """The port's single stream on the 320x240 scene until its first
    keyframe past the bootstrap pair: snapshots before each frame, the
    frames, statuses, keyframe flags and the camera."""
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(48, step=0.04)
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")
    snaps, frames, st, kf = [], [], [], []
    for i in range(48):
        frames.append(scene.render(gt[i]).astype(np.float32))
        snaps.append(tstate.map_state_to_numpy(slam.state))
        slam.find_camera_pose(frames[i])
        st.append(slam.last_status)
        kf.append(slam.last_is_keyframe)
        if st[-1] == 1 and kf[-1] and 1 in st[:-1]:
            return snaps, frames, st, kf, slam.camera
    raise AssertionError(f"no keyframe past the bootstrap: {st} {kf}")


def _tracked_row(scene_run, i, defer_heavy=False):
    """The state after frame i's track phase, from the snapshot before it."""
    snaps, frames, _, _, cam = scene_run
    state = tstate.map_state_from_numpy(snaps[i], CFG, "cpu")
    state, flags = tstep.track_phase(state, torch.from_numpy(frames[i]), cam, CFG,
                                     defer_heavy=defer_heavy)
    return state, flags


@pytest.fixture(scope="module")
def kf_rows(scene_run):
    """Three states whose track phase requested a keyframe: frame 0 (the
    first keyframe), the bootstrap frame (the pair's second) and the
    steady-state keyframe; as numpy dicts, so each test reads fresh
    copies, generators included."""
    _, _, st, _, _ = scene_run
    rows = []
    for i in (0, st.index(1), len(st) - 1):
        state, flags = _tracked_row(scene_run, i)
        assert bool(flags.kf_req), i
        rows.append(tstate.map_state_to_numpy(state))
    assert [int(r["next_kf_id"]) for r in rows] == [0, 1, 2]
    return rows


def _read(rows):
    return [tstate.map_state_from_numpy(d, CFG, "cpu") for d in rows]


def _assert_rows_close(a: dict, b: dict, tag, pos_atol=POS_ATOL):
    """``a`` and ``b`` ({name: ndarray}, one stream each) at the slice's
    bars: integer and bool fields equal outside at most LM_VALID_SLACK
    landmarks whose ``lm_valid`` differs (and those landmarks' own rows),
    pose q (up to sign) 1e-5, pose t 1e-4, ``lm_pos`` 1e-3 on landmarks
    that are 3D in both."""
    odd = np.flatnonzero(a["lm_valid"] != b["lm_valid"])
    assert len(odd) <= LM_VALID_SLACK, (tag, odd)
    L = a["lm_valid"].shape[0]
    keep = np.ones(L, bool)
    keep[odd] = False
    for k in a:
        if k.startswith("rng") or a[k].dtype.kind not in "biu":
            continue
        x, y = a[k], b[k]
        if x.ndim and x.shape[0] == L:
            x, y = x[keep], y[keep]
        elif k in ("kp_lm", "kf_obs_lm"):
            x, y = np.where(np.isin(x, odd), -1, x), np.where(np.isin(y, odd), -1, y)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}: {k}")
    for k in ("pose", "kf_pose"):
        q, jq = a[k + ".q"], b[k + ".q"]
        sign = np.sign(np.sum(q * jq, axis=-1, keepdims=True))
        np.testing.assert_allclose(q * sign, jq, atol=POSE_Q_ATOL, rtol=0, err_msg=f"{tag}: {k}.q")
        np.testing.assert_allclose(a[k + ".t"], b[k + ".t"], atol=POSE_T_ATOL, rtol=0,
                                   err_msg=f"{tag}: {k}.t")
    both3d = a["lm_valid"] & a["lm_is3d"] & b["lm_valid"] & b["lm_is3d"]
    np.testing.assert_allclose(a["lm_pos"][both3d], b["lm_pos"][both3d], atol=pos_atol, rtol=0,
                               err_msg=f"{tag}: lm_pos")
    return int(both3d.sum())


def _row_numpy(states, j):
    return tstate.map_state_to_numpy(tstate.state_row(states, j))


def test_keyframe_phase_batched_matches_rows(scene_run, kf_rows, monkeypatch):
    """One batched pass over the three rows equals ``keyframe_phase`` on
    each row alone; the row path took the later-keyframe branch on rows
    1 and 2 and local BA on row 2, the batched pass made no host read."""
    cam = scene_run[4]
    calls = {"later": [], "ba": []}
    for name, fn in (("later", tkf._later_keyframe), ("ba", tkf.run_local_ba)):
        monkeypatch.setattr(tkf, fn.__name__, lambda *a, _f=fn, _n=name: (
            calls[_n].append(row), _f(*a))[1])
    one = []
    for row, s in enumerate(_read(kf_rows)):
        one.append(tstate.map_state_to_numpy(tstep.keyframe_phase(s, cam, CFG)))
    assert calls == {"later": [1, 2], "ba": [1, 2]}

    syncs = tkf.host_bool.syncs
    out = tstep.keyframe_phase_batched(tstate.stack_states(_read(kf_rows)), cam, CFG)
    assert tkf.host_bool.syncs == syncs
    for j in range(3):
        b = _row_numpy(out, j)
        n3d = _assert_rows_close(b, one[j], f"row {j}")
        assert n3d > 50 or j == 0, (j, n3d)
        assert (b["rng_state"] == one[j]["rng_state"]).all()
    assert [int(x) for x in out.next_kf_id] == [1, 2, 3]


def test_keyframe_phase_batched_matches_jax(scene_run, kf_rows):
    cam = scene_run[4]
    out = tstep.keyframe_phase_batched(tstate.stack_states(_read(kf_rows)), cam, CFG)
    jcam = JCamera.create(cam.fx, cam.fy, cam.cx, cam.cy)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *(jax_state_from_numpy(d, JCFG)
                                                    for d in kf_rows))
    jout = jax.jit(jax.vmap(lambda s: jstep.keyframe_phase(s, jcam, JCFG)))(jst)
    jd = {}
    for name, v in jout._asdict().items():
        if name in ("pose", "kf_pose"):
            jd[name + ".q"], jd[name + ".t"] = np.asarray(v.q), np.asarray(v.t)
        elif name != "prev_pyr":
            jd[name] = np.asarray(v)
    for j in range(3):
        b = _row_numpy(out, j)
        ref = {k: v[j] for k, v in jd.items() if k != "rng_key"}
        b = {k: b[k] for k in ref}
        n3d = _assert_rows_close(b, ref, f"row {j} vs JAX",
                                 pos_atol=PAIR_POS_ATOL if j == 1 else POS_ATOL)
        assert n3d > 50 or j == 0, (j, n3d)


def _phase_rows(scene_run):
    """Two tracking rows with a pose failure (for P3P recovery) and two
    initializing rows (for the essential bootstrap: the frame whose
    bootstrap succeeds and one two frames earlier), after their track
    phase with the heavy solves deferred, as numpy dicts."""
    _, _, st, _, _ = scene_run
    first = st.index(1)
    rec, boot = [], []
    for i in (first + 2, first + 4):
        state, _ = _tracked_row(scene_run, i, defer_heavy=True)
        rec.append(tstate.map_state_to_numpy(state.replace(
            pose_failures=torch.ones_like(state.pose_failures))))
    for i in (first, first - 2):
        state, flags = _tracked_row(scene_run, i, defer_heavy=True)
        assert bool(flags.init_gate) == (i == first)
        boot.append(tstate.map_state_to_numpy(state))
    for rows in (rec, boot):
        # no draw separates these frames on the single stream: advance the
        # second row's generator so that the two rows' draws differ
        state = tstate.map_state_from_numpy(rows[1], CFG, "cpu")
        torch.rand(3, generator=state.rng)
        rows[1] = tstate.map_state_to_numpy(state)
    return rec, boot


@pytest.mark.parametrize("phase", ["recovery", "bootstrap"])
def test_draw_phases_batched_match_rows(scene_run, phase):
    """P3P recovery and the bootstrap on two rows in one pass: each row
    draws from its own generator (their states differ) in the row path's
    order, so states and generator states equal the row path's."""
    cam = scene_run[4]
    rows = _phase_rows(scene_run)[0 if phase == "recovery" else 1]
    assert not (rows[0]["rng_state"] == rows[1]["rng_state"]).all()
    single = tstep.recovery_phase if phase == "recovery" else tstep.init_essential_phase
    batched = (tstep.recovery_phase_batched if phase == "recovery"
               else tstep.init_essential_phase_batched)
    one = [tstate.map_state_to_numpy(single(s, cam, CFG)) for s in _read(rows)]
    out = batched(tstate.stack_states(_read(rows)), cam, CFG)
    for j in range(2):
        b = _row_numpy(out, j)
        _assert_rows_close(b, one[j], f"{phase} row {j}")
        np.testing.assert_array_equal(b["rng_state"], one[j]["rng_state"])
        assert not (b["rng_state"] == rows[j]["rng_state"]).all()     # it drew
    if phase == "bootstrap":
        assert bool(one[0]["ready_for_init"])
    else:
        assert all(int(r["pose_failures"]) == 0 for r in one)


def _loop_rows(kf_rows, cam):
    """The three keyframe rows with keyframe ids moved 30 on (past the
    detection delay), and their databases: rows 0 and 2 each hold an
    earlier copy of their own new keyframe and one of the other's, row 1's
    is empty."""
    rows = []
    for d in kf_rows:
        d = dict(d)
        d["kf_id"] = np.where(d["kf_valid"], d["kf_id"] + 30, d["kf_id"])
        d["next_kf_id"] = d["next_kf_id"] + 30
        rows.append(d)
    kf = [tstep.keyframe_phase(s, cam, CFG) for s in _read(rows)]

    def entry(s):
        slot = s.cur_kf_slot
        lm = s.kf_obs_lm[slot]
        valid = s.kf_obs_valid[slot] & s.lm_valid[lm]
        return (s.lm_desc[lm], s.lm_pos[lm], s.lm_is3d[lm] & valid, valid, s.kf_pose[slot])

    dbs = []
    for fill in ([(kf[0], 3), (kf[2], 5)], [], [(kf[2], 4), (kf[0], 6)]):
        db = detector.db_init(8, CFG.max_keypoints, "cpu")
        for s, kid in fill:
            desc, pos, is3d, valid, pose = entry(s)
            db = detector.db_add(db, desc, pos, is3d, valid, kid, pose)
        dbs.append(db)
    return rows, dbs


def test_loop_subbatch_matches_rows(scene_run, kf_rows):
    cam = scene_run[4]
    rows, dbs = _loop_rows(kf_rows, cam)
    one = [tms.loopclosure_phase(tstep.keyframe_phase(s, cam, CFG), db, cam, CFG, delay=4)
           for s, db in zip(_read(rows), dbs)]
    confirmed = [bool(c) for _, _, c in one]
    stacked = tms._map_db(lambda *ts: torch.stack(ts), *dbs)
    out, out_dbs = tms.keyframe_loop_phase_batched(tstate.stack_states(_read(rows)), stacked,
                                                   cam, CFG, delay=4)
    for j, (s, db, _) in enumerate(one):
        _assert_rows_close(_row_numpy(out, j), tstate.map_state_to_numpy(s), f"loop row {j}")
        ref = detector.loop_db_to_numpy(db)
        got = detector.loop_db_to_numpy(tms._map_db(lambda t: t[j], out_dbs))
        for k in ref:
            if ref[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], ref[k], atol=POS_ATOL, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"row {j}: {k}")
    assert [int(x) for x in out_dbs.ptr] == [3, 1, 3]
    # rows 0 and 2 detect their own earlier copy; row 0 (a first keyframe)
    # has no 3D landmark to verify with, row 2 confirms and is corrected
    assert [int(x) for x in out_dbs.last_match] == [3, -1, 4]
    assert confirmed == [False, False, True], confirmed


SMALL = dict(width=128, height=96, cell_size=32, window_size=4, max_landmarks=64,
             ransac_iters=8, ba_iters=1, pyramid_levels=2, klt_iters=4, min_init_keypoints=4)


def test_step_syncs_and_one_pass_per_phase(monkeypatch):
    """B = 4 streams, 2 keyframe slots: the first step serves two
    keyframes; every step reads the host at most 4 times (3 election reads
    here; the caller's output read is the fourth), and each gated phase
    that serves rows runs once on their stack."""
    cfg = SlamConfig(**SMALL)
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    tex = smooth_noise(np.random.default_rng(1), cfg.height, cfg.width)
    frames = np.stack([np.stack([np.roll(tex, n + b, axis=1) for b in range(4)])
                       for n in range(3)]).astype(np.float32)
    passes = []
    map_rows = tstate.map_rows

    def counting(fn, states, *args):
        passes[-1].append(tstate.num_streams(states))
        return map_rows(fn, states, *args)

    monkeypatch.setattr(tstep, "map_rows", counting)
    monkeypatch.setattr(tms, "map_rows", counting)
    step = tms.make_multistream_step(cfg, cam, kf_slots=2)
    states = tstate.init_multistream_state(cfg, 4, seed=7, device="cpu")
    served = []
    for n in range(3):
        s0 = tkf.host_bool.syncs
        passes.append([])
        states, out = step(states, frames[n])
        assert tkf.host_bool.syncs - s0 <= 3, (n, tkf.host_bool.syncs - s0)
        served.append(int(out.is_keyframe.sum()))
    # step 0: the keyframe phase once over both served rows; step 1: the
    # two streams that lost that election reset, in one pass
    assert served[0] == 2 and passes[0] == [2], (served, passes)
    assert passes[1][-1] == 2, passes
    assert all(len(p) <= 4 for p in passes), passes


def test_masked_scatter_set_keeps_the_last_colliding_write():
    """Colliding live writes (local BA writes a merged landmark once per
    column it holds, tests/test_torch_ba_merge.py) keep the last one, as a
    serial loop does, alone and under ``vmap``, and as the JAX package's
    scatter does on the CPU: ``index_put_`` leaves them in no order on
    CUDA, and on the CPU on more than one thread, which made two runs of
    the batched keyframe phase differ on the card (chip_smoke.py holds
    the card to the serial loop)."""
    from alvaar_tpu.worldmap.state import masked_scatter_set as jmasked_scatter_set
    rng = np.random.default_rng(0)
    for _ in range(20):
        arr = rng.normal(size=(7, 2)).astype(np.float32)
        idx = rng.integers(0, 7, 12)
        vals = rng.normal(size=(12, 2)).astype(np.float32)
        mask = rng.random(12) < 0.6
        want = arr.copy()
        for i in range(12):
            if mask[i]:
                want[idx[i]] = vals[i]
        args = [torch.as_tensor(a) for a in (arr, idx, vals, mask)]
        np.testing.assert_array_equal(tstate.masked_scatter_set(*args).numpy(), want)
        batched = torch.func.vmap(tstate.masked_scatter_set)(*[a.expand(3, *a.shape)
                                                               for a in args])
        np.testing.assert_array_equal(batched.numpy(), np.broadcast_to(want, (3, 7, 2)))
        np.testing.assert_array_equal(
            np.asarray(jmasked_scatter_set(jnp.asarray(arr), jnp.asarray(idx),
                                           jnp.asarray(vals), jnp.asarray(mask))), want)
    # local BA's write-back size in the default config (30 x 192 writes into
    # 4096 landmarks), about 11 writes per written index, on 4 threads:
    # there the CPU's index_put_ leaves colliding writes in no order too
    L, n = 4096, 30 * 192
    arr = rng.normal(size=L).astype(np.float32)
    idx = rng.integers(0, n // 11, n)
    vals = rng.normal(size=n).astype(np.float32)
    mask = rng.random(n) < 0.6
    want = arr.copy()
    for i in np.flatnonzero(mask):
        want[idx[i]] = vals[i]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = tstate.masked_scatter_set(*(torch.as_tensor(a) for a in (arr, idx, vals, mask)))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got.numpy(), want)
