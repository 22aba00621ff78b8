"""The stream mesh's worker processes (alvaar_tpu_torch/parallel/workers.py)
on the CPU, at tests/test_torch_multistream.SMALL's 128x96 size, two
workers on ``["cpu", "cpu"]``:

* a worker that raises makes the call raise with its traceback, one that
  is killed makes the next call raise, one that answers nothing makes the
  call raise after ``ANSWER_TIMEOUT_S``; each closes the mesh and leaves
  no child process;
* ``close()``, and dropping the mesh and its handles, leave no child;
* workers started from several threads at once each get the
  ``CUDA_VISIBLE_DEVICES`` entry of their own device;
* a stale handle, or one of another mesh, raises;
* the parent's counters gain exactly the shards' deltas;
* fresh rows of one state tiled over the shards give shards that each
  equal that state's unsharded run, outputs, state tensors and
  generators bit for bit.
"""

import gc
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from alvaar_tpu_torch import SlamConfig
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.ops.klt import fb_klt_track
from alvaar_tpu_torch.parallel import multistream as tms
from alvaar_tpu_torch.parallel import workers
from alvaar_tpu_torch.worldmap import state as tstate
from alvaar_tpu_torch.worldmap.keyframe import host_bool
from tests.test_image_ops import smooth_noise
from tests.test_torch_multistream import SMALL

torch.set_num_threads(1)

CFG = SlamConfig(**SMALL)
CAM = Camera.from_fov(CFG.width, CFG.height, 60.0)
DEVICES = ["cpu", "cpu"]


def _frames(b, steps, seed=1):
    """[steps, b, H, W]: stream j sees one texture shifted by j + step."""
    tex = smooth_noise(np.random.default_rng(seed), CFG.height, CFG.width)
    return np.stack([np.stack([np.roll(tex, i + j, axis=1) for j in range(b)])
                     for i in range(steps)]).astype(np.float32)


def _mesh(b=2):
    step = tms.make_multistream_step(CFG, CAM, kf_slots=1, devices=DEVICES)
    return step, tms.shard_states(tstate.init_multistream_state(CFG, b, device="cpu"), DEVICES)


def _children(before):
    return [p for p in multiprocessing.active_children() if p not in before]


def test_worker_error_raises_with_its_traceback():
    before = multiprocessing.active_children()
    step, blocks = _mesh()
    f = _frames(2, 1)[0]
    with pytest.raises(RuntimeError, match="raised") as err:
        step(blocks, f, active=np.ones(2, np.float32))      # a float mask: the step's & fails
    assert "Traceback" in str(err.value) and "bitwise_and" in str(err.value)
    assert "multistream_step_local" in str(err.value)
    assert _children(before) == []
    with pytest.raises(RuntimeError, match="closed"):
        step(blocks, f)


def test_killed_worker_makes_the_next_call_raise():
    before = multiprocessing.active_children()
    step, blocks = _mesh()
    frames = _frames(2, 2)
    blocks, _ = step(blocks, frames[0])
    procs = _children(before)
    assert len(procs) == 2
    os.kill(procs[0].pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        step(blocks, frames[1])
    assert time.monotonic() - t0 < workers.ANSWER_TIMEOUT_S
    assert _children(before) == []


def test_silent_worker_times_out(monkeypatch):
    before = multiprocessing.active_children()
    step, blocks = _mesh()
    frames = _frames(2, 2)
    blocks, _ = step(blocks, frames[0])
    # the short budget only once the workers have started and answered: a
    # spawn (the torch import) can take longer than it on a loaded host
    monkeypatch.setattr(workers, "ANSWER_TIMEOUT_S", 3.0)
    procs = _children(before)
    os.kill(procs[1].pid, signal.SIGSTOP)                   # alive, answers nothing
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no answer within 3.0 s"):
        step(blocks, frames[1])
    assert 3.0 <= time.monotonic() - t0 < 60.0
    assert _children(before) == []


@pytest.mark.parametrize("how", ["close", "drop"])
def test_close_and_drop_leave_no_child(how):
    before = multiprocessing.active_children()
    step, blocks = _mesh()
    f = _frames(2, 1)[0]
    blocks, out = step(blocks, f)
    assert len(_children(before)) == 2 and out.status.shape == (2,)
    if how == "close":
        step.close()
        with pytest.raises(RuntimeError, match="closed"):
            step(blocks, f)
    else:
        del step, blocks
        gc.collect()
    assert _children(before) == []


def test_stale_and_foreign_handles_raise():
    step, blocks = _mesh()
    other, other_blocks = _mesh()
    frames = _frames(2, 3)
    try:
        first, _ = step(blocks, frames[0])
        latest, _ = step(first, frames[1])
        with pytest.raises(ValueError, match="stale"):
            step(first, frames[2])
        with pytest.raises(ValueError, match="stale"):
            tms.gather_states(first)
        foreign, _ = other(other_blocks, frames[0])
        with pytest.raises(ValueError, match="another stream mesh"):
            step(foreign, frames[2])
        with pytest.raises(ValueError, match="position"):
            step(latest[::-1], frames[2])
        with pytest.raises(ValueError, match="mix"):
            step([latest[0], other_blocks[1]], frames[2])
        latest, out = step(latest, frames[2])        # the mesh is still open
        assert out.status.shape == (2,)
        assert tms.num_streams(tms.gather_states(latest)) == 2
    finally:
        step.close()
        other.close()


def test_parent_counters_sum_the_shards_deltas():
    fresh = tstate.init_multistream_state(CFG, 4, device="cpu")
    frames = _frames(4, 3)
    counters = [(fb_klt_track, "launches"), (tms.multistream_step_local, "syncs"),
                (host_bool, "syncs")]

    def read():
        return [getattr(fn, attr) for fn, attr in counters]

    step = tms.make_multistream_step(CFG, CAM, kf_slots=1, devices=DEVICES)
    blocks = tms.shard_states(fresh, DEVICES)
    try:
        c0 = read()
        for f in frames:
            blocks, _ = step(blocks, f)
        mesh = [a - b for a, b in zip(read(), c0)]
    finally:
        step.close()
    c0 = read()
    for k, blk in enumerate(tms.shard_states(fresh, DEVICES)):
        for f in frames:
            blk, _ = tms.multistream_step_local(blk, torch.from_numpy(f[2 * k:2 * k + 2]),
                                                torch.ones(2), CAM, CFG, 1)
    serial = [a - b for a, b in zip(read(), c0)]
    assert mesh == serial
    assert mesh[1] == 3 * len(DEVICES) * len(frames)         # three election reads per shard


def test_tiled_rows_equal_one_unsharded_block():
    b, steps = 2, 4
    fresh = tstate.init_multistream_state(CFG, b, seed=5, device="cpu")
    tiled = tstate.gather_rows(fresh, list(range(b)) * len(DEVICES))
    frames = _frames(b, steps)
    step = tms.make_multistream_step(CFG, CAM, kf_slots=1, devices=DEVICES)
    blocks, outs = tms.shard_states(tiled, DEVICES), []
    try:
        for f in frames:
            blocks, out = step(blocks, np.concatenate([f] * len(DEVICES)))
            outs.append(out)
        got = tms.gather_states(blocks)
    finally:
        step.close()
    alone = tms.make_multistream_step(CFG, CAM, kf_slots=1)
    ref = tms.shard_states(fresh, ["cpu"])[0]              # its own generators
    for s, f in enumerate(frames):
        ref, rout = alone(ref, f)
        for k in range(len(DEVICES)):
            for fld in tms.dataclasses.fields(rout):
                assert torch.equal(getattr(outs[s], fld.name)[k * b:(k + 1) * b],
                                   getattr(rout, fld.name)), (s, k, fld.name)
    assert int(sum(o.is_keyframe.sum() for o in outs)) > 0
    for k in range(len(DEVICES)):
        shard = tstate.gather_rows(got, list(range(k * b, (k + 1) * b)))
        for (name, x), (_, y) in zip(shard.tensors(), ref.tensors()):
            assert torch.equal(x, y), (k, name)
        for g, h in zip(shard.rng, ref.rng):
            assert torch.equal(g.get_state(), h.get_state())


def test_workers_started_from_threads_each_get_their_own_card(monkeypatch):
    """Meshes started from several threads at once (as chip_smoke.py phase
    6e starts them) hand each worker its own device's entry of this
    process's ``CUDA_VISIBLE_DEVICES``, and leave the value as it was."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    seen = {}

    class Started:          # records what a process started now would inherit
        def __init__(self, key):
            self.key = key

        def start(self):
            time.sleep(0.05)
            seen[self.key] = os.environ["CUDA_VISIBLE_DEVICES"]

    devices = [torch.device("cuda", k) for k in range(4)] + [torch.device("cpu")]
    threads = [threading.Thread(target=workers._spawn, args=(Started(str(d)), d))
               for d in devices]
    for t in threads:
        t.start()
        time.sleep(0.01)    # each starts while an earlier one's value is set
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"cuda:0": "4", "cuda:1": "5", "cuda:2": "6", "cuda:3": "7", "cpu": ""}
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "4,5,6,7"
