"""Multi-stream SLAM serving on one GPU, or sharded over several.

Port of alvaar_tpu/parallel/multistream.py.  B independent camera streams
share one stacked state (worldmap/state.py ``init_multistream_state``:
every tensor has a leading [B] axis, each stream its own generator), and
one call of the step advances all of them by a frame:

  * track phase, every frame, all streams at once
    (frontend/step.py ``track_phase_batched``): preprocess, motion prior,
    the two KLT stages (one kernel launch each for all B streams on the
    card), PnP, the bootstrap gate and the keyframe decision, with the
    heavy RANSAC solves deferred;
  * four gated phases, each on a top-k sub-batch of the streams that ask
    for it: P3P recovery and the essential bootstrap (at most
    ``max(2, kf_slots // 2)`` streams each), the keyframe pipeline (plus
    loop closure, with ``dbs``; at most ``kf_slots`` streams) and, after
    finalize, the reset (``max(2, kf_slots // 2)``).  Keyframe requests
    that miss the cut carry ``kf_pending`` and outrank fresh ones at the
    next election; bootstrap keyframes (``next_kf_id <= 1``) outrank
    everything.  The election scores and sizes are the JAX package's.

Where the JAX package runs a gated sub-batch as a vmapped phase under a
``lax.cond``, the port reads the election on the host, gathers the live
elected rows into one stack (an ``index_select`` per tensor), runs the
single-stream phase once on that stack under ``torch.func.vmap`` (every
branch computed and selected per row, as ``lax.cond`` under ``jax.vmap``)
and writes the rows back: the same result as running each row alone.
RANSAC draws stay per stream: each elected row draws from its own
generator outside ``vmap``, in the single-stream order, and the draws go
in through the solvers' ``samples=``.  The elections cost three host reads
per step, whatever B (``multistream_step_local.syncs`` counts them): P3P
recovery and the bootstrap together, the keyframe election, the reset.
No phase reads the host inside, so a step makes three host syncs
(``host_bool.syncs`` counts them all), whatever B and ``kf_slots``.

The stream mesh (the JAX package's ``shard_map`` over a 1-D "streams"
axis): ``shard_states`` splits a stacked state into contiguous blocks of
streams, one per device, and ``make_multistream_step(..., devices=...)``
advances every block with ``multistream_step_local`` on its own device,
with ``kf_slots`` counted per device.  Streams share nothing, so there is
no collective; each block lives in a worker process of its own
(parallel/workers.py: the step is paced by the host, so shards that share
one interpreter add their host time up).  A device may appear more than
once: several shards on one card, or on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.frontend.step import (finalize_phase,
                                            init_essential_phase_batched,
                                            keyframe_phase, keyframe_phase_batched,
                                            recovery_phase_batched, track_phase_batched)
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.loopclosure.detector import LoopDB
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.parallel.workers import ShardHandle, StreamMesh
from alvaar_tpu_torch.utils.stats import count
from alvaar_tpu_torch.worldmap.keyframe import host_bool
from alvaar_tpu_torch.worldmap.state import (MapState, apply_world_correction, from_tensors,
                                             gather_rows, map_rows, map_tensors, num_streams,
                                             reset_map_state, select_rows, write_rows)
# the JAX package's multistream module exports the stacked state's constructor
from alvaar_tpu_torch.worldmap.state import init_multistream_state  # noqa: F401


# ---------------------------------------------------------------------------
# Elections
# ---------------------------------------------------------------------------

def _elect(score, slots: int):
    """Top-``slots`` streams by ``score`` [B] (ties to the lower index, as
    ``jax.lax.top_k``); a slot is live where its score is positive.
    Returns (idx [S], live [S]) on the device."""
    _, idx = top_k(score, min(slots, score.shape[0]))
    return idx, score[idx] > 0.0


def _read_elections(*elections):
    """Every election's (idx, live) read on the host in one sync.
    Returns a list of (rows, live) pairs of Python lists."""
    count(multistream_step_local, "syncs")
    count(host_bool, "syncs")
    flat = torch.cat([torch.cat([idx, live.to(idx.dtype)]) for idx, live in elections]).tolist()
    out, o = [], 0
    for idx, _ in elections:
        s = idx.shape[0]
        out.append((flat[o:o + s], [bool(v) for v in flat[o + s:o + 2 * s]]))
        o += 2 * s
    return out


def _kf_request(kf_req, became_ready, pending, reset, next_kf_id, active=None):
    """The keyframe requests of this frame and their election scores:
    pending (deferred) requests outrank fresh ones, bootstrap keyframes
    (``next_kf_id <= 1``) outrank everything; a stream flagged for reset
    or inactive asks for nothing.  Returns (req [B], score [B])."""
    req = (kf_req | became_ready | pending) & ~reset
    if active is not None:
        req = req & active
    urgent = req & (next_kf_id <= 1)
    score = (req.to(torch.float32) + 2.0 * pending.to(torch.float32)
             + 4.0 * urgent.to(torch.float32))
    return req, score


def _served_mask(b: int, rows, device):
    served = torch.zeros(b, dtype=torch.bool, device=device)
    if rows:
        served[torch.tensor(rows, device=device)] = True
    return served


def _live_rows(election) -> list:
    idx, live = election
    return [i for i, a in zip(idx, live) if a]


def _serve(states: MapState, election, batched_fn) -> tuple[MapState, list]:
    """``batched_fn`` (stacked sub-state → stacked sub-state) once, on the
    stack of the live elected rows (one ``index_select`` per tensor), the
    rows written back.  Returns (states, the rows served)."""
    rows = _live_rows(election)
    if rows:
        states = write_rows(states, rows, batched_fn(gather_rows(states, rows)))
    return states, rows


def _gated_subbatch(states: MapState, flags, phase_fn, slots: int):
    """Run ``phase_fn`` (a single-stream state transform) on the top-k
    flagged streams only: election (one host read), the phase under
    ``vmap`` on the stack of the elected rows, write-back.  Returns
    (states, served [B] bool)."""
    election, = _read_elections(_elect(flags.to(torch.float32), slots))
    states, rows = _serve(states, election, lambda sub: map_rows(phase_fn, sub))
    return states, _served_mask(flags.shape[0], rows, flags.device)


# ---------------------------------------------------------------------------
# Loop closure in the keyframe sub-batch
# ---------------------------------------------------------------------------

def init_multistream_loopdbs(cfg: SlamConfig, num_streams: int, capacity: int = 256,
                             device="cuda") -> LoopDB:
    """Stacked per-stream LoopDB with a leading [num_streams] axis."""
    base = detector.db_init(capacity, cfg.max_keypoints, device)
    return _map_db(lambda t: t.expand((num_streams,) + t.shape).clone(), base)


def _map_db(fn, db: LoopDB, *others: LoopDB) -> LoopDB:
    return LoopDB(**{f.name: fn(getattr(db, f.name), *(getattr(o, f.name) for o in others))
                     for f in dataclasses.fields(LoopDB)})


def loopdbs_to_numpy(dbs: LoopDB) -> dict:
    """Stacked LoopDB → {field: ndarray with a leading [B] axis}, rows as
    ``detector.loop_db_to_numpy`` writes them."""
    rows = [detector.loop_db_to_numpy(_map_db(lambda t: t[i], dbs))
            for i in range(dbs.kf_id.shape[0])]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def loopdbs_from_numpy(d: dict, device="cuda") -> LoopDB:
    """{field: ndarray with a leading [B] axis} (from
    :func:`loopdbs_to_numpy`, or a stacked JAX LoopDB through
    ``np.asarray``) → stacked LoopDB on ``device``."""
    b = np.asarray(d["kf_id"]).shape[0]
    rows = [detector.loop_db_from_numpy({k: np.asarray(v)[i] for k, v in d.items()}, device)
            for i in range(b)]
    return _map_db(lambda *ts: torch.stack(ts), *rows)


def loopclosure_phase(state: MapState, db: LoopDB, cam: Camera, cfg: SlamConfig,
                      delay: int = 50):
    """Per-keyframe loop closure for batched serving: query the stream's
    database with the new keyframe, insert it, verify a hit against the
    stored landmarks from the current pose, and apply the world correction
    where it is confirmed (a select, no host sync).
    Returns (state, db, loop_found)."""
    slot = state.cur_kf_slot
    lm = state.kf_obs_lm[slot]
    desc = state.lm_desc[lm]
    valid = state.kf_obs_valid[slot] & state.lm_valid[lm]
    kf_id = state.kf_id[slot]
    pose = state.kf_pose[slot]
    # window residency floors the delay: in-window keyframes are local BA's
    db, res = detector.detect_loop(db, desc, valid, kf_id, delay=max(delay, cfg.window_size))
    db = detector.db_add(db, desc, state.lm_pos[lm], state.lm_is3d[lm] & valid, valid,
                         kf_id, pose)
    r_pose, r_ok, _ = detector.verify_loop(db, res.entry, desc, state.kf_obs_px[slot], valid,
                                           cam, pose)
    confirm = res.found & r_ok
    corrected = apply_world_correction(state, r_pose.inverse().compose(state.pose))
    state = map_tensors(lambda a, c: torch.where(confirm, a, c), corrected, state)
    return state, db, confirm


def _db_tensors(db: LoopDB) -> dict:
    return {f.name: getattr(db, f.name) for f in dataclasses.fields(LoopDB)}


def keyframe_loop_phase_batched(states: MapState, dbs: LoopDB, cam: Camera, cfg: SlamConfig,
                                delay: int = 50):
    """The keyframe pipeline then ``loopclosure_phase`` on every row of a
    stacked sub-state and its stacked databases in one pass, under
    ``vmap`` (the JAX package's two vmapped phases on the sub-batch).
    Returns (states, dbs)."""
    def one(d, db):
        st = keyframe_phase(from_tensors(d), cam, cfg, select=True)
        st, db, _ = loopclosure_phase(st, LoopDB(**db), cam, cfg, delay=delay)
        return dict(st.tensors()), _db_tensors(db)

    out, db = vmap(one)(dict(states.tensors()), _db_tensors(dbs))
    return from_tensors(out, rng=states.rng), LoopDB(**db)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def multistream_step_local(states: MapState, frames, dts, cam: Camera, cfg: SlamConfig,
                           kf_slots: int, dbs: LoopDB | None = None, loop_delay: int = 50,
                           active=None):
    """One frame for B streams: batched track (heavy RANSAC deferred), the
    gated P3P recovery, essential bootstrap and keyframe sub-batches, the
    batched finalize, the gated reset.  frames [B, H, W] on the states'
    device, dts [B].  Returns (states, StepOutput of [B] tensors), or
    (states, dbs, outs) with ``dbs`` (a stacked LoopDB), whose loop closure
    runs inside the keyframe sub-batch.

    ``active`` ([B] bool): streams with no frame this tick claim no slot
    and come back unchanged, generators included (the serving front door
    lets clients at different frame rates share one batch)."""
    b = num_streams(states)
    states0, dbs0 = states, dbs
    small = max(2, kf_slots // 2)

    states, fl = track_phase_batched(states, frames, cam, cfg, dts)
    if active is not None:
        # inactive streams must not claim sub-batch slots
        fl.p3p_need, fl.init_gate, fl.kf_req = (fl.p3p_need & active, fl.init_gate & active,
                                                fl.kf_req & active)

    # ---- gated P3P recovery and essential bootstrap: one read for both
    # (their flags come from the track phase; the two sets are disjoint) ----
    e_p3p, e_init = _read_elections(_elect(fl.p3p_need.to(torch.float32), small),
                                    _elect(fl.init_gate.to(torch.float32), small))
    states, _ = _serve(states, e_p3p, lambda sub: recovery_phase_batched(sub, cam, cfg))
    pre_ready = states.ready_for_init
    states, _ = _serve(states, e_init, lambda sub: init_essential_phase_batched(sub, cam, cfg))
    became_ready = states.ready_for_init & ~pre_ready

    # ---- keyframe election: age-prioritized top-k sub-batch ----
    req, score = _kf_request(fl.kf_req, became_ready, states.kf_pending,
                             states.reset_requested, states.next_kf_id, active)
    e_kf, = _read_elections(_elect(score, kf_slots))
    if dbs is None:
        states, rows = _serve(states, e_kf, lambda sub: keyframe_phase_batched(sub, cam, cfg))
    else:
        rows = _live_rows(e_kf)
        if rows:
            index = torch.tensor(rows, device=dbs.kf_id.device)
            sub, sub_dbs = keyframe_loop_phase_batched(
                gather_rows(states, rows), _map_db(lambda t: t.index_select(0, index), dbs),
                cam, cfg, delay=loop_delay)
            states = write_rows(states, rows, sub)
            dbs = _map_db(lambda full, new: full.index_copy(0, index, new), dbs, sub_dbs)
    served = _served_mask(b, rows, req.device)
    states = states.replace(kf_pending=req & ~served)

    states, outs = finalize_phase(states, served, cfg, defer_reset=True)

    # ---- gated reset: flagged streams past the slots keep their flag and
    # report status 2 again next frame ----
    reset_req = states.reset_requested if active is None else states.reset_requested & active
    states, _ = _gated_subbatch(states, reset_req, lambda s: reset_map_state(s, cfg), small)
    if active is not None:
        states = select_rows(active, states, states0)
        if dbs is not None:
            dbs = _map_db(lambda new, old: torch.where(
                active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old), dbs, dbs0)
    if dbs is None:
        return states, outs
    return states, dbs, outs


multistream_step_local.syncs = 0


def _dts(dts, b: int, device):
    if dts is None:
        return torch.ones(b, dtype=torch.float32, device=device)
    return torch.as_tensor(dts, dtype=torch.float32).to(device)


def _frames(frames, device):
    return torch.as_tensor(frames).to(device=device, dtype=torch.float32)


def make_multistream_step(cfg: SlamConfig, cam: Camera, kf_slots: int = 4,
                          loop_closure: bool = False, loop_delay: int = 50, *,
                          devices=None):
    """The batched step as a callable: ``(states, frames [B, H, W], dts=None,
    active=None) → (states, outs)``; with ``loop_closure``, ``(states, dbs,
    frames, dts=None, active=None) → (states, dbs, outs)`` with a stacked
    per-stream LoopDB (:func:`init_multistream_loopdbs`).  ``kf_slots`` is
    the keyframe sub-batch size (the JAX bench: ``max(3, ceil(B / 6))``).

    With ``devices`` (a list, a device may repeat), the step runs over the
    stream mesh and is a :class:`~alvaar_tpu_torch.parallel.workers.StreamMesh`:
    one worker process per entry of ``devices``, started at the first
    call, stopped by its ``close()`` or when it is dropped.  ``states``
    (and ``dbs``) are the blocks of :func:`shard_states` over the same
    ``devices``, or the handles the previous call returned; ``frames``
    [B, H, W], ``dts`` and ``active`` [B] are global, and each block
    advances on its device with ``kf_slots`` keyframe slots of its own
    (per device, as in the JAX package).  Returns handles to the new
    blocks (:func:`gather_states` reads them) and a StepOutput on
    ``devices[0]`` whose row b is stream b's."""
    if devices is not None:
        return StreamMesh(cfg, cam, kf_slots, loop_closure, loop_delay,
                          [_device(d) for d in devices])
    if loop_closure:
        def run_lc(states: MapState, dbs: LoopDB, frames, dts=None, active=None):
            dev = states.kp_px.device
            return multistream_step_local(states, _frames(frames, dev),
                                          _dts(dts, num_streams(states), dev), cam, cfg,
                                          kf_slots, dbs, loop_delay, active)
        return run_lc

    def run(states: MapState, frames, dts=None, active=None):
        dev = states.kp_px.device
        return multistream_step_local(states, _frames(frames, dev),
                                      _dts(dts, num_streams(states), dev), cam, cfg,
                                      kf_slots, active=active)
    return run


# ---------------------------------------------------------------------------
# The stream mesh
# ---------------------------------------------------------------------------

def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _generator_on(gen: torch.Generator, dev: torch.device) -> torch.Generator:
    """A new generator on ``dev`` in ``gen``'s state.  A CUDA generator is
    bound to one device and its state carries between CUDA devices; CPU
    and CUDA generator states differ, so the type must stay."""
    if gen.device.type != dev.type:
        raise ValueError(f"a {gen.device.type} generator cannot move to {dev}")
    out = torch.Generator(device=dev)
    out.set_state(gen.get_state())
    return out


def _block(x, rows: slice, dev: torch.device):
    """Rows ``rows`` of a stacked MapState or LoopDB, copied onto ``dev``."""
    take = lambda t: t[rows].to(dev, copy=True)
    if isinstance(x, LoopDB):
        return _map_db(take, x)
    return map_tensors(take, x).replace(rng=tuple(_generator_on(g, dev) for g in x.rng[rows]))


def shard_states(states, devices) -> list:
    """A stacked MapState (or stacked LoopDB) of B streams as
    ``len(devices)`` contiguous blocks of B / len(devices) streams, block k
    copied onto ``devices[k]`` with its streams' generators re-created
    there in the same state: the blocks that ``PartitionSpec("streams")``
    gives over a 1-D mesh of ``devices`` (the JAX package's
    ``shard_states``).  A B that does not divide evenly raises."""
    devices = [_device(d) for d in devices]
    b = states.kf_id.shape[0]            # MapState [B, W], LoopDB [B, D]
    if not devices or b % len(devices):
        raise ValueError(f"{b} streams do not split evenly over {len(devices)} devices")
    n = b // len(devices)
    return [_block(states, slice(k * n, (k + 1) * n), d) for k, d in enumerate(devices)]


def gather_states(blocks, device=None):
    """The inverse of :func:`shard_states`: the blocks concatenated in
    stream order onto ``device`` (block 0's by default), generators
    included, e.g. for ``multistream_state_to_numpy`` or a checkpoint.
    ``blocks`` may be the handles that a mesh's latest step returned: the
    states are fetched from its workers (a stale handle raises)."""
    if isinstance(blocks[0], ShardHandle):
        blocks = blocks[0].mesh.fetch(blocks, None if device is None else _device(device))
    dev = _device(device) if device is not None else blocks[0].kf_id.device
    cat = lambda *ts: torch.cat([t.to(dev) for t in ts])
    if isinstance(blocks[0], LoopDB):
        return _map_db(cat, *blocks)
    return map_tensors(cat, *blocks).replace(
        rng=tuple(_generator_on(g, dev) for blk in blocks for g in blk.rng))


def make_multistream_scan(cfg: SlamConfig, cam: Camera, kf_slots: int = 4,
                          loop_closure: bool = False, loop_delay: int = 50):
    """The serving loop over pre-staged frames [N, B, H, W] (a Python loop
    where the JAX package scans): ``run(states, frames, dts) → (states,
    (statuses [N, B], poses [N, B, 4, 4]))``; with ``loop_closure``
    ``run(states, frames, dts, dbs) → ((states, dbs), outs)``.  Each frame
    moves to the states' device when its step comes; the outputs stay on
    the device until the end."""
    step = make_multistream_step(cfg, cam, kf_slots, loop_closure, loop_delay)

    def scan(states, dbs, frames, dts):
        statuses, poses = [], []
        for n in range(len(frames)):
            dt = None if dts is None else dts[n]
            if dbs is None:
                states, out = step(states, frames[n], dt)
            else:
                states, dbs, out = step(states, dbs, frames[n], dt)
            statuses.append(out.status)
            poses.append(out.pose_wc)
        return states, dbs, (torch.stack(statuses), torch.stack(poses))

    if loop_closure:
        def run_lc(states: MapState, frames, dts, dbs: LoopDB):
            states, dbs, outs = scan(states, dbs, frames, dts)
            return (states, dbs), outs
        return run_lc

    def run(states: MapState, frames, dts):
        states, _, outs = scan(states, None, frames, dts)
        return states, outs
    return run

