"""The port's single-stream frame without host waits, port alone, at
320x240 on the scene of tests/test_torch_facade.py:

* ``slam_step`` (``dispatch_step`` then ``complete_step``) bit-equal to
  the port as it was before the step was split, over 40 frames (the
  bootstrap at frame 15 and three keyframes), every ``MapState`` tensor
  and the generator included; from carried states, a P3P-recovery frame
  (``pose_failures`` 1, ``use_p3p``), a frame whose own stage 1 asks for
  P3P (the next golden frame shifted 6 px), and the bootstrap frame;
* ``find_camera_pose``, ``find_camera_pose_async`` (read one frame late,
  read in batches by ``drain``, never read until the end) and
  ``process_frames`` bit-equal to each other;
* the reads and the host-data tensor constructions: one ``host_bool`` read
  per tracking frame (the CPU-only stage-2 compaction read counted apart),
  none from host data in ``slam_step`` or in ``local_ba`` at 3 / 5 / 10
  LM iterations (``utils/tables.device_table``'s one copy per table
  counted apart);
* the branch re-derived where the state changed outside the step:
  ``reset``, ``load_map``, an auto-relocalization's pose.

The golden, ``tests/golden/torch_step_320.npz``, holds the statuses and
poses and a SHA-256 digest of the whole state after every frame (and of
each tensor after the last).  It was written by the port of commit
26d2929, from a checkout of that commit with this file copied into its
``tests/``::

    python -m tests.test_torch_async tests/golden/torch_step_320.npz
"""

import hashlib
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.system import PendingResult
from alvaar_tpu_torch.worldmap import keyframe as tkf
from alvaar_tpu_torch.worldmap.state import (init_map_state, map_state_from_numpy,
                                             map_state_to_numpy)
from tests.render_scene_np import TwoPlaneScene, trajectory

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

# tests/test_torch_bootstrap.py's CFG_ARGS (that module imports JAX)
CFG_ARGS = dict(width=320, height=240, cell_size=24, window_size=10,
                max_landmarks=512, ransac_iters=50, ba_iters=4, init_parallax_px=25.0)
CFG = SlamConfig(**CFG_ARGS)
N_FRAMES = 40
P3P_FRAME = 31          # the carried-state cases run this frame on the state after 30
ROLL_PX = 6             # its shift for the frame whose stage 1 asks for P3P
GOLDEN = "tests/golden/torch_step_320.npz"


def render_frames(n=N_FRAMES):
    scene = TwoPlaneScene(np.random.default_rng(42), width=320, height=240, fov=60.0)
    gt = trajectory(n, step=0.04)
    return [scene.render(gt[i]).astype(np.float32) for i in range(n)]


def camera() -> Camera:
    return Camera.from_fov(320, 240, 60.0)


def state_digests(state):
    """(digest of the whole state, {name: digest}) over
    ``map_state_to_numpy``'s arrays, the generator's state included."""
    arrays = map_state_to_numpy(state)
    each = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()
                              + str(v.dtype).encode() + str(v.shape).encode()).hexdigest()
            for k, v in arrays.items()}
    whole = hashlib.sha256("".join(each[k] for k in sorted(each)).encode()).hexdigest()
    return whole, each


def _row(out):
    return (int(out.status), out.pose_wc.numpy().copy(), bool(out.is_keyframe),
            int(out.num_tracked))


def golden_run(frames):
    """The sequence through ``slam_step`` from a fresh state, then the
    carried-state cases.  Returns (arrays for the golden file, the state
    after each frame)."""
    cam = camera()
    state = init_map_state(CFG, "cpu")
    rows, digests, states = [], [], []
    for f in frames:
        state, out = tstep.slam_step(state, torch.from_numpy(f), cam, CFG)
        rows.append(_row(out))
        digests.append(state_digests(state)[0])
        states.append(state)
    g = {"status": np.array([r[0] for r in rows], np.int32),
         "pose": np.stack([r[1] for r in rows]),
         "is_kf": np.array([r[2] for r in rows]),
         "num_tracked": np.array([r[3] for r in rows], np.int32),
         "digest": np.array(digests)}
    for k, v in state_digests(state)[1].items():
        g["final." + k] = np.array(v)
    base = states[P3P_FRAME - 1]
    cases = {"p3p": (base.replace(pose_failures=torch.ones_like(base.pose_failures)),
                     frames[P3P_FRAME]),
             "roll": (base, np.roll(frames[P3P_FRAME], ROLL_PX, axis=1))}
    for name, (st, f) in cases.items():
        st, out = tstep.slam_step(st, torch.from_numpy(f), cam, CFG)
        r = _row(out)
        g[name + ".status"], g[name + ".pose"] = np.int32(r[0]), r[1]
        g[name + ".digest"] = np.array(state_digests(st)[0])
    return g, states


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    return render_frames()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


class _Counts:
    """Host-data tensor constructions (``torch.tensor``, ``torch.as_tensor``
    of anything but a tensor, ``Tensor.new_tensor``) while active, with
    ``device_table``'s one-time copies apart."""

    def __init__(self, monkeypatch):
        from alvaar_tpu_torch.utils import tables
        self.host = self.tables = 0
        self.active = False
        table_code = tables.device_table.__code__

        def wrap(fn, is_host):
            def counted(*args, **kwargs):
                if self.active and is_host(args):
                    if sys._getframe(1).f_code is table_code:
                        self.tables += 1
                    else:
                        self.host += 1
                return fn(*args, **kwargs)
            return counted

        host_data = lambda args: not isinstance(args[0], torch.Tensor)
        monkeypatch.setattr(torch, "tensor", wrap(torch.tensor, lambda args: True))
        monkeypatch.setattr(torch, "as_tensor", wrap(torch.as_tensor, host_data))
        monkeypatch.setattr(torch.Tensor, "new_tensor",
                            wrap(torch.Tensor.new_tensor, lambda args: True))


class _ItemReads(TorchDispatchMode):
    """Counts ``Tensor.item`` reads (``aten._local_scalar_dense``: what
    ``bool(t)``, ``int(t)`` and indexing by a 0-d tensor run)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def step_run(frames):
    """``golden_run`` with its counters: per frame, the ``host_bool`` reads
    outside the stage-2 compaction, the compaction's reads, the
    host-data constructions and the ``Tensor.item`` reads."""
    mp = pytest.MonkeyPatch()
    counts = _Counts(mp)
    compaction = []
    track_keypoints = tstep._track_keypoints

    def counted_klt(*args, **kwargs):
        s0 = tkf.host_bool.syncs
        out = track_keypoints(*args, **kwargs)
        compaction.append(tkf.host_bool.syncs - s0)
        return out

    mp.setattr(tstep, "_track_keypoints", counted_klt)
    reads, host, items = [], [], []
    slam_step = tstep.slam_step

    def counted_step(*args, **kwargs):
        s0, h0, c0 = tkf.host_bool.syncs, counts.host, len(compaction)
        counts.active = True
        try:
            with _ItemReads() as item_reads:
                return slam_step(*args, **kwargs)
        finally:
            counts.active = False
            reads.append(tkf.host_bool.syncs - s0 - sum(compaction[c0:]))
            host.append(counts.host - h0)
            items.append(item_reads.n - sum(compaction[c0:]))

    mp.setattr(tstep, "slam_step", counted_step)
    try:
        g, states = golden_run(frames)
    finally:
        mp.undo()
    n = len(frames)
    return g, states, reads[:n], host[:n], counts.tables, reads[n:], host[n:], items[:n]


def _assert_rows(statuses, poses, g, n=N_FRAMES):
    np.testing.assert_array_equal(np.asarray(statuses), g["status"][:n])
    for i in range(n):
        if g["status"][i] == 1:
            np.testing.assert_array_equal(np.asarray(poses[i]), g["pose"][i], err_msg=str(i))


# ---------------------------------------------------------------------------
# slam_step against the golden
# ---------------------------------------------------------------------------

def test_slam_step_bit_equal_to_golden(step_run, golden):
    g = step_run[0]
    assert list(g["status"]).count(1) >= 20 and g["is_kf"].sum() >= 3, g["status"]
    np.testing.assert_array_equal(g["status"], golden["status"])
    np.testing.assert_array_equal(g["is_kf"], golden["is_kf"])
    np.testing.assert_array_equal(g["num_tracked"], golden["num_tracked"])
    np.testing.assert_array_equal(g["pose"], golden["pose"])
    bad = [i for i in range(N_FRAMES) if g["digest"][i] != golden["digest"][i]]
    assert not bad, f"state differs after frames {bad}"
    finals = sorted(k for k in golden if k.startswith("final."))
    assert finals == sorted(k for k in g if k.startswith("final.")) and len(finals) >= 40
    for k in finals:
        assert g[k] == golden[k], k


@pytest.mark.parametrize("case", ["p3p", "roll"])
def test_carried_state_frames_bit_equal_to_golden(step_run, golden, case):
    """The P3P-recovery frame (a carried state with ``pose_failures`` 1,
    so its branch is read from the state) and the frame whose own stage 1
    asks for P3P (the state the step returned, whose branch skipped P3P:
    ``complete_step`` redoes the pose with it).  Each runs P3P once."""
    g = step_run[0]
    assert int(golden[case + ".status"]) == 1
    for k in (".status", ".pose", ".digest"):
        np.testing.assert_array_equal(g[case + k], golden[case + k], err_msg=case + k)
    # reads: the edited state's branch and the flags; the flags and the redo's
    assert step_run[5] == [2, 2], step_run[5]


def test_p3p_runs_once_on_carried_frames(frames, step_run, monkeypatch):
    states = step_run[1]
    calls = []
    p3p = tstep.p3p_lmeds
    monkeypatch.setattr(tstep, "p3p_lmeds", lambda *a, **k: calls.append(1) or p3p(*a, **k))
    base = states[P3P_FRAME - 1]
    reads = []
    for f in (np.roll(frames[P3P_FRAME], ROLL_PX, axis=1), frames[P3P_FRAME]):
        s0 = tkf.host_bool.syncs
        tstep.slam_step(base, torch.from_numpy(f), camera(), CFG)
        reads.append(tkf.host_bool.syncs - s0)
    assert len(calls) == 1          # the shifted frame's; the plain one runs none
    assert reads[0] - reads[1] == 1     # the redo's read


def test_bootstrap_frame_from_carried_state(frames, golden):
    """The bootstrap frame from its predecessor handed in as numpy (the
    branch read from the state, the generator restored).  The states of a
    run share one generator, so the predecessor is made anew."""
    boot = int(np.argmax(golden["status"] == 1))
    assert golden["is_kf"][boot]
    st = init_map_state(CFG, "cpu")
    for f in frames[:boot]:
        st, _ = tstep.slam_step(st, torch.from_numpy(f), camera(), CFG)
    st = map_state_from_numpy(map_state_to_numpy(st), CFG, "cpu")
    assert st.next_branch is None
    st, out = tstep.slam_step(st, torch.from_numpy(frames[boot]), camera(), CFG)
    assert int(out.status) == 1 and bool(out.is_keyframe)
    np.testing.assert_array_equal(out.pose_wc.numpy(), golden["pose"][boot])
    assert state_digests(st)[0] == golden["digest"][boot]


# ---------------------------------------------------------------------------
# reads and host-data constructions
# ---------------------------------------------------------------------------

def test_one_read_per_tracking_frame(step_run):
    g, _, reads = step_run[:3]
    kinds = {}
    for i in range(1, N_FRAMES):
        init = g["status"][i - 1] == 3
        kind = ("bootstrap" if init and g["is_kf"][i] else "initializing" if init
                else "keyframe" if g["is_kf"][i] else "tracking")
        kinds.setdefault(kind, []).append(reads[i])
    assert len(kinds["tracking"]) >= 20
    assert set(kinds["tracking"]) == {1}, kinds
    # a keyframe frame: the flags, the pipeline's two gated reads and the
    # reset read; an initializing frame: the bootstrap gate and the flags;
    # the bootstrap frame both; the first frame also reads the fresh
    # state's branch
    assert set(kinds["keyframe"]) == {4}, kinds
    assert set(kinds["initializing"]) == {2}, kinds
    assert kinds["bootstrap"] == [5] and reads[0] == 5, (kinds, reads[0])


def test_every_host_read_is_counted(step_run):
    """Outside the packed reads (the flags, and the first frame's branch),
    every read of a device value is a ``host_bool`` read: no ``Tensor.item``
    behind a 0-d index or a Python conversion, which would wait for the
    card uncounted."""
    reads, items = step_run[2], step_run[7]
    packed = [2] + [1] * (N_FRAMES - 1)
    assert items == [r - p for r, p in zip(reads, packed)], (items, reads)


def test_no_host_data_tensor_in_slam_step(step_run):
    host, tables = step_run[3], step_run[4]
    assert sum(host) == 0, host
    assert sum(step_run[6]) == 0
    # orb's three tables, the 5-point solver's two gathers, the rotation W
    assert tables <= 6, tables


@pytest.fixture(scope="module")
def ba_problem(frames, step_run):
    """The local BA problem of the run's last keyframe, kept by wrapping
    ``keyframe.local_ba`` while the frame runs again."""
    g, states = step_run[:2]
    last_kf = int(np.nonzero(g["is_kf"])[0][-1])
    seen = []
    local_ba = tkf.local_ba
    mp = pytest.MonkeyPatch()
    mp.setattr(tkf, "local_ba", lambda prob, cam, **kw: seen.append(prob) or local_ba(prob, cam, **kw))
    try:
        tstep.slam_step(states[last_kf - 1], torch.from_numpy(frames[last_kf]), camera(), CFG)
    finally:
        mp.undo()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("iters", [3, 5, 10])
def test_no_host_data_tensor_in_local_ba(ba_problem, iters, monkeypatch):
    from alvaar_tpu_torch.solvers.ba import local_ba
    counts = _Counts(monkeypatch)
    counts.active = True
    res = local_ba(ba_problem, camera(), iters=iters, refine_iters=2,
                   huber_delta=CFG.huber_thresh)
    counts.active = False
    assert counts.host == 0 and counts.tables == 0
    assert bool(torch.isfinite(res.cost)) and int(res.num_obs) > 0


# ---------------------------------------------------------------------------
# the facade: sync, async, process_frames
# ---------------------------------------------------------------------------

def _facade():
    return AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu")


def test_find_camera_pose_bit_equal(frames, step_run):
    slam = _facade()
    poses, statuses = [], []
    for f in frames:
        poses.append(slam.find_camera_pose(f))
        statuses.append(slam.last_status)
    _assert_rows(statuses, poses, step_run[0])
    assert state_digests(slam.state)[0] == step_run[0]["digest"][-1]


@pytest.mark.parametrize("reading", ["one_late", "drain", "at_end"])
def test_async_bit_equal(frames, step_run, reading):
    slam = _facade()
    pending = []
    for f in frames:
        pending.append(slam.find_camera_pose_async(f))
        if reading == "one_late" and len(pending) >= 2:
            pending[-2].status
        elif reading == "drain" and len(pending) % 7 == 0:
            PendingResult.drain(pending[-7:])
    if reading != "at_end":
        assert pending[-1]._read is None        # the last frame is still pending
    PendingResult.drain(pending)
    _assert_rows([r.status for r in pending], [r.pose for r in pending], step_run[0])
    assert slam.last_status == step_run[0]["status"][-1]
    assert pending[-1].frame_points().shape[1] == 2
    assert state_digests(slam.state)[0] == step_run[0]["digest"][-1]


def test_async_call_reads_only_the_previous_frame(frames):
    """Inside ``find_camera_pose_async`` a tracking frame makes one read:
    the previous frame's flags."""
    slam = _facade()
    per_call = []
    for f in frames[:24]:
        s0 = tkf.host_bool.syncs
        slam.find_camera_pose_async(f)
        per_call.append(tkf.host_bool.syncs - s0)
    # frames 17-23 track; each call completes its predecessor (one read)
    # and dispatches itself (the CPU's compaction read, counted on the CPU only)
    assert set(per_call[18:]) == {2}, per_call


def test_process_frames_bit_equal(frames, step_run):
    slam = _facade()
    st, po = slam.process_frames(np.stack(frames), chunk=16)
    assert st.dtype == np.int32 and po.shape == (N_FRAMES, 4, 4) and po.dtype == np.float32
    _assert_rows(st, po, step_run[0])
    assert state_digests(slam.state)[0] == step_run[0]["digest"][-1]


# ---------------------------------------------------------------------------
# the branch re-derived where the state changed outside the step
# ---------------------------------------------------------------------------

def test_branch_after_reset_and_load_map(frames, step_run, tmp_path):
    g = step_run[0]
    slam = _facade()
    for f in frames[:20]:
        slam.find_camera_pose_async(f)
    path = str(tmp_path / "map.npz")
    slam.save_map(path)                  # completes frame 19
    # load_map: the next frames continue the sequence as the sync path does
    other = _facade()
    other.load_map(path)
    assert other.state.next_branch is None
    other.find_camera_pose_async(frames[20])
    res = other.find_camera_pose_async(frames[21])
    assert res.status == g["status"][21] == 1
    np.testing.assert_array_equal(res.pose, g["pose"][21])
    assert other.state.next_branch is not None
    # reset: the next frame is a first frame, as on a fresh instance with
    # the generator carried on
    slam.reset()
    res = slam.find_camera_pose_async(frames[0])
    assert res.status == 3 and res.is_keyframe
    assert slam.state.next_branch.in_tracking is False


def test_branch_after_relocalization(frames, monkeypatch):
    """``_try_autorelocalize`` snaps the pose and asks for P3P: the next
    frame (async) runs P3P before PnP and equals ``slam_step`` run from
    the relocalized state handed in."""
    slam = AlvaAR(320, 240, fov=60.0, config=CFG, device="cpu", enable_loop_closure=True)
    for f in frames[:P3P_FRAME]:
        slam.find_camera_pose(f)
    assert slam.last_status == 1 and slam._try_autorelocalize()
    st = slam.state
    assert st.next_branch is None and bool(st.p3p_req)
    rng = torch.Generator()
    rng.set_state(st.rng.get_state())     # the reference draws what the facade draws
    st = st.replace(rng=rng)
    calls = []
    p3p = tstep.p3p_lmeds
    monkeypatch.setattr(tstep, "p3p_lmeds", lambda *a, **k: calls.append(1) or p3p(*a, **k))
    res = slam.find_camera_pose_async(frames[P3P_FRAME])
    ref_state, ref = tstep.slam_step(st, torch.from_numpy(frames[P3P_FRAME]), camera(), CFG)
    assert calls == [1, 1]
    assert res.status == int(ref.status) == 1
    np.testing.assert_array_equal(res.pose, ref.pose_wc.numpy())
    assert state_digests(slam.state)[0] == state_digests(ref_state)[0]


if __name__ == "__main__":
    out, _ = golden_run(render_frames())
    np.savez_compressed(sys.argv[1], **out)
    print(sys.argv[1], out["status"].tolist(), int(out["p3p.status"]), int(out["roll.status"]))
