"""The stream mesh of the port (alvaar_tpu_torch/parallel/multistream.py
``shard_states``, ``gather_states``, ``make_multistream_step(devices=...)``)
against the JAX package's ``shard_states`` / ``shard_map`` step, on the
CPU: the JAX side on the conftest's virtual 8-device CPU mesh (no step is
compiled), the port's shards on ``["cpu", "cpu"]``.

* Block k of the port holds the rows that JAX's ``PartitionSpec("streams")``
  places on mesh device k, for B = 8 over 2, 4 and 8 devices.
* Generators are carried bit for bit; the gather is the inverse; a B
  that does not divide raises.
* The sharded step (one host thread per shard) equals
  ``multistream_step_local`` run serially on each block alone, bit for
  bit, at 320x240 under tests/test_torch_bootstrap.CFG_ARGS; ``kf_slots``
  is counted per device, as JAX's per-device election over each block.
* The loop-closure variant returns sharded databases, equal to each
  block's serial run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from alvaar_tpu.config import SlamConfig as JSlamConfig
from alvaar_tpu.parallel import multistream as jms
from alvaar_tpu_torch import SlamConfig
from alvaar_tpu_torch.frontend import step as tstep
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.parallel import multistream as tms
from alvaar_tpu_torch.worldmap import state as tstate
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_image_ops import smooth_noise
from tests.test_torch_bootstrap import CFG_ARGS
from tests.test_torch_multistream import SMALL, _jax_kf_election

torch.set_num_threads(1)


def _marked(cfg, b):
    """A fresh stacked port state whose rows can be told apart."""
    st = tstate.init_multistream_state(cfg, b, seed=4, device="cpu")
    return st.replace(frame_id=torch.arange(b), kp_px=torch.randn(st.kp_px.shape,
                                                                  generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_shard_blocks_match_jax_partition(n_dev):
    b = 8
    jst = jms.init_multistream_state(JSlamConfig(**SMALL), b, seed=4)
    jst = jst._replace(frame_id=jnp.arange(b, dtype=jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("streams",))
    jsh = jms.shard_states(jst, mesh)
    blocks = tms.shard_states(_marked(SlamConfig(**SMALL), b), ["cpu"] * n_dev)
    assert len(blocks) == n_dev
    position = {d: k for k, d in enumerate(mesh.devices.tolist())}
    for leaf, name in ((jsh.frame_id, "frame_id"), (jsh.prev_pyr[0], "prev_pyr"),
                       (jsh.kp_px, "kp_px")):
        shards = leaf.addressable_shards
        assert len(shards) == n_dev
        for sh in shards:
            k = position[sh.device]
            rows = np.arange(b)[sh.index[0]]
            np.testing.assert_array_equal(blocks[k].frame_id.numpy(), rows, err_msg=name)
            if name == "frame_id":
                np.testing.assert_array_equal(np.asarray(sh.data), blocks[k].frame_id.numpy())
    assert [tms.num_streams(blk) for blk in blocks] == [b // n_dev] * n_dev


def test_shard_carries_generators_and_gather_inverts():
    cfg = SlamConfig(**SMALL)
    st = _marked(cfg, 6)
    for g in st.rng[::2]:
        torch.rand(3, generator=g)                  # generators in distinct states
    blocks = tms.shard_states(st, ["cpu", "cpu", "cpu"])
    flat = [g for blk in blocks for g in blk.rng]
    for g, h in zip(st.rng, flat):
        assert g is not h
        assert torch.equal(g.get_state(), h.get_state())
    back = tms.gather_states(blocks)
    for (name, a), (_, c) in zip(st.tensors(), back.tensors()):
        assert a.dtype == c.dtype and torch.equal(a, c), name
    assert [torch.equal(g.get_state(), h.get_state()) for g, h in zip(st.rng, back.rng)] == [True] * 6
    draws = [torch.rand(4, generator=g) for g in back.rng]
    assert all(torch.equal(d, torch.rand(4, generator=g)) for d, g in zip(draws, st.rng))
    dbs = tms.init_multistream_loopdbs(cfg, 6, capacity=4, device="cpu")
    dbs = tms._map_db(lambda t: t + torch.arange(6).reshape((6,) + (1,) * (t.dim() - 1)).to(t.dtype)
                      if t.dtype != torch.bool else t, dbs)
    dblocks = tms.shard_states(dbs, ["cpu", "cpu"])
    assert [int(blk.kf_id.shape[0]) for blk in dblocks] == [3, 3]
    back_db = tms.gather_states(dblocks)
    for f in tms.dataclasses.fields(tms.LoopDB):
        assert torch.equal(getattr(back_db, f.name), getattr(dbs, f.name)), f.name


def test_uneven_split_raises():
    st = tstate.init_multistream_state(SlamConfig(**SMALL), 8, device="cpu")
    with pytest.raises(ValueError, match="evenly"):
        tms.shard_states(st, ["cpu"] * 3)
    mesh = Mesh(np.array(jax.devices()[:3]), ("streams",))
    with pytest.raises(ValueError):
        jms.shard_states(jms.init_multistream_state(JSlamConfig(**SMALL), 8), mesh)


def test_mesh_refuses_misplaced_blocks():
    cfg = SlamConfig(**SMALL)
    blocks = tms.shard_states(tstate.init_multistream_state(cfg, 4, device="cpu"), ["cpu"] * 2)
    step = tms.make_multistream_step(cfg, Camera.from_fov(cfg.width, cfg.height, 60.0),
                                     kf_slots=1, devices=["cpu"] * 4)
    frames = np.zeros((4, cfg.height, cfg.width), np.float32)
    with pytest.raises(ValueError, match="blocks"):
        step(blocks, frames)


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

B, SHARDS, SLOTS, STEPS = 4, 2, 1, 2


def _scene_frames(cfg, b, n):
    scene = TwoPlaneScene(np.random.default_rng(3), width=cfg.width, height=cfg.height,
                          fov=60.0, tex_scale=120.0)
    gt = trajectory(n + b, step=0.05)
    frames = np.stack([scene.render(T) for T in gt]).astype(np.float32)
    return np.stack([frames[i:i + b] for i in range(n)])             # stream b: frames b ..


def _serial(block, frames, cam, cfg, dbs=None, loop_delay=50):
    """``multistream_step_local`` on one block alone, step after step."""
    outs = []
    for f in frames:
        res = tms.multistream_step_local(block, torch.from_numpy(f), torch.ones(f.shape[0]),
                                         cam, cfg, SLOTS, dbs, loop_delay)
        block, outs = res[0], outs + [res[-1]]
        if dbs is not None:
            dbs = res[1]
    return block, dbs, outs


@pytest.fixture(scope="module")
def mesh_run():
    cfg = SlamConfig(**CFG_ARGS)
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    frames = _scene_frames(cfg, B, STEPS)
    fresh = tstate.init_multistream_state(cfg, B, seed=11, device="cpu")
    step = tms.make_multistream_step(cfg, cam, kf_slots=SLOTS, devices=["cpu"] * SHARDS)
    blocks, outs = tms.shard_states(fresh, ["cpu"] * SHARDS), []
    for f in frames:
        blocks, out = step(blocks, f)
        outs.append(out)
    n = B // SHARDS
    ref = [_serial(blk, frames[:, k * n:(k + 1) * n], cam, cfg)
           for k, blk in enumerate(tms.shard_states(fresh, ["cpu"] * SHARDS))]
    first = tstep.track_phase_batched(fresh, torch.from_numpy(frames[0]), cam, cfg,
                                      torch.ones(B))[1]
    return dict(cfg=cfg, blocks=blocks, outs=outs, ref=ref, first=first, fresh=fresh)


def test_sharded_step_equals_each_block_alone(mesh_run):
    n = B // SHARDS
    for s, out in enumerate(mesh_run["outs"]):
        assert out.status.shape == (B,)
        for k, (_, _, routs) in enumerate(mesh_run["ref"]):
            for f in tstep.dataclasses.fields(tstep.StepOutput):
                got = getattr(out, f.name)[k * n:(k + 1) * n]
                assert torch.equal(got, getattr(routs[s], f.name)), (s, k, f.name)
    for blk, (rblk, _, _) in zip(mesh_run["blocks"], mesh_run["ref"]):
        for (name, a), (_, c) in zip(blk.tensors(), rblk.tensors()):
            assert torch.equal(a, c), name
        for g, h in zip(blk.rng, rblk.rng):
            assert torch.equal(g.get_state(), h.get_state())
    assert (mesh_run["outs"][-1].status != 0).all()


def test_kf_slots_count_per_device(mesh_run):
    """Frame 0: every stream asks for its first keyframe; each shard
    serves ``kf_slots`` of them, elected as JAX's ``top_k`` over that
    block's flags alone (one keyframe per shard here, two in all)."""
    fl, fresh = mesh_run["first"], mesh_run["fresh"]
    n = B // SHARDS
    served = set(np.flatnonzero(mesh_run["outs"][0].is_keyframe.numpy()).tolist())
    assert len(served) == SHARDS * SLOTS
    expect = set()
    for k in range(SHARDS):
        rows = slice(k * n, (k + 1) * n)
        a = lambda t: jnp.asarray(t[rows].numpy())
        false = jnp.zeros(n, bool)
        _, idx, live = _jax_kf_election(a(fl.kf_req), false, a(fresh.kf_pending),
                                        a(fresh.reset_requested), a(fresh.next_kf_id),
                                        jnp.ones(n, bool), SLOTS)
        expect |= {int(i) + k * n for i, ok in zip(np.asarray(idx), np.asarray(live)) if ok}
    assert served == expect
    alone = tms.multistream_step_local(fresh, torch.from_numpy(_scene_frames(
        mesh_run["cfg"], B, 1)[0]), torch.ones(B), Camera.from_fov(320, 240, 60.0),
        mesh_run["cfg"], SLOTS)[1]
    assert int(alone.is_keyframe.sum()) == SLOTS              # one device: one slot in all


def test_loop_closure_mesh_returns_sharded_dbs():
    cfg = SlamConfig(**SMALL)
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    r = np.random.default_rng(1)
    tex = smooth_noise(r, cfg.height, cfg.width)
    frames = np.stack([np.stack([np.roll(tex, i + b, axis=1) for b in range(B)])
                       for i in range(3)]).astype(np.float32)
    fresh = tstate.init_multistream_state(cfg, B, device="cpu")
    dbs0 = tms.init_multistream_loopdbs(cfg, B, capacity=8, device="cpu")
    step = tms.make_multistream_step(cfg, cam, kf_slots=SLOTS, loop_closure=True, loop_delay=1,
                                     devices=["cpu"] * SHARDS)
    blocks, dbs = tms.shard_states(fresh, ["cpu"] * SHARDS), tms.shard_states(dbs0, ["cpu"] * SHARDS)
    for f in frames:
        blocks, dbs, out = step(blocks, dbs, f)
    assert len(dbs) == SHARDS and all(isinstance(d, tms.LoopDB) for d in dbs)
    assert [int(d.kf_id.shape[0]) for d in dbs] == [B // SHARDS] * SHARDS
    assert (tms.gather_states(dbs).ptr >= 1).any()
    n = B // SHARDS
    for k, (blk, db) in enumerate(zip(tms.shard_states(fresh, ["cpu"] * SHARDS),
                                      tms.shard_states(dbs0, ["cpu"] * SHARDS))):
        _, rdb, routs = _serial(blk, frames[:, k * n:(k + 1) * n], cam, cfg, db, loop_delay=1)
        for f in tms.dataclasses.fields(tms.LoopDB):
            assert torch.equal(getattr(dbs[k], f.name), getattr(rdb, f.name)), f.name
        assert torch.equal(out.status[k * n:(k + 1) * n], routs[-1].status)
