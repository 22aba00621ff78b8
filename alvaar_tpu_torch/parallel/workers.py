"""The stream mesh's worker processes: one per shard.

``make_multistream_step(..., devices=...)`` (parallel/multistream.py)
returns a :class:`StreamMesh`.  At its first call the mesh starts one
worker process per entry of ``devices`` (the ``spawn`` context of
``torch.multiprocessing``: the parent may hold CUDA contexts and threads,
which ``fork`` does not survive), and each worker owns its block's
``MapState`` (and ``LoopDB``) on its own device for the life of the mesh,
advancing it with ``multistream_step_local`` (``kf_slots`` per device).
Streams share nothing, so no worker talks to another: this is the JAX
package's ``shard_map`` over a 1-D "streams" axis, with one host per shard.
The batched step is paced by the host (thousands of launches per keyframe
pass), so shards that shared one interpreter added their host time up;
processes run it side by side.

* A CUDA worker sees only its own card: it starts with
  ``CUDA_VISIBLE_DEVICES`` set to that card (as the parent numbers it), so
  nothing in it can open a context elsewhere, and calls it ``cuda:0``.  Several entries on one card are several
  workers on that card, each with its own context, taking turns on it.
  A CPU worker sees no card.
* Each worker runs ``torch.set_num_threads(1)`` (``WORKER_THREADS``): its
  work is launches on its card, and on the CPU one thread per worker keeps
  N workers from oversubscribing the host (and keeps the CPU arithmetic
  that of a one-thread parent).  It takes the parent's float32 settings
  (TF32 on or off for matmuls and cuDNN) at start.
* K1 (``ops/lk_level.build_kernel``) is built once in the parent before
  the workers start; they load the built library.
* Frames go in through host shared memory, one buffer per worker reused
  across steps (n·H·W·4 bytes per shard per step: 19 660 800 B at 16
  streams of 640x480), which the worker copies to its card through a
  pinned buffer (``utils/pinned.UploadRing``).  The ``StepOutput`` rows come
  back through a second shared buffer per worker (1817 B per stream at
  192 keypoints: 29 072 B at 16 streams) and are concatenated on
  ``devices[0]``.  ``dts``, ``active``, the counter deltas and the
  handshake go through a pipe; so do whole states, which cross only when
  the mesh is loaded (real blocks passed in) or gathered.
* The step returns light :class:`ShardHandle` s for the blocks (and
  databases); ``gather_states`` fetches the states they stand for.  Only
  the handles of the latest step of this mesh are accepted.
* Each step's counter deltas (kernel launches, local-map matching and
  loop-query calls, election reads, host reads) come back from each
  worker and are added to the parent's counters.
* A worker that raises makes the call raise with its traceback; one that
  dies, or gives no answer within ``ANSWER_TIMEOUT_S`` seconds of the
  call's dispatch, makes the call raise.  Any such failure, and
  :meth:`StreamMesh.close` or a finaliser when the mesh is dropped, stops
  every worker and closes the mesh for good.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
import weakref
from multiprocessing import connection, shared_memory

import numpy as np
import torch
import torch.multiprocessing

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.frontend.step import StepOutput
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.loopclosure.detector import LoopDB
from alvaar_tpu_torch.ops.detect import detect_grid
from alvaar_tpu_torch.ops.hamming import hamming_best_two, hamming_matrix, hamming_min_crossbag
from alvaar_tpu_torch.ops.image import build_pyramid, pyr_down, rgba_to_gray
from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
from alvaar_tpu_torch.ops.lk_level import lk_level
from alvaar_tpu_torch.ops.orb import describe
from alvaar_tpu_torch.solvers.ba import _residuals_jacobians, ba_linearize, ba_residuals, ba_schur
from alvaar_tpu_torch.solvers.pnp import pnp_refine
from alvaar_tpu_torch.utils.pinned import UploadRing
from alvaar_tpu_torch.utils.stats import count
from alvaar_tpu_torch.worldmap.keyframe import host_bool
from alvaar_tpu_torch.worldmap.matching import match_to_local_map
from alvaar_tpu_torch.worldmap.state import from_tensors, num_streams

ANSWER_TIMEOUT_S = 300.0   # a step, a load, a gather or a worker's start-up
SHUTDOWN_GRACE_S = 10.0    # close(): how long a worker may take to exit before it is killed
WORKER_THREADS = 1
_ENVIRON_LOCK = threading.Lock()


def _counters():
    """The (function, attribute) counters a worker reports per step."""
    from alvaar_tpu_torch.parallel.multistream import multistream_step_local
    return ((fb_klt_track, "launches"), (klt_pyramidal, "launches"), (lk_level, "launches"),
            (ba_linearize, "launches"), (ba_residuals, "launches"), (ba_schur, "launches"),
            (pnp_refine, "launches"), (_residuals_jacobians, "calls"),
            (hamming_min_crossbag, "launches"), (hamming_matrix, "launches"),
            (hamming_best_two, "launches"), (hamming_best_two, "calls"),
            (match_to_local_map, "calls"),
            (rgba_to_gray, "launches"), (pyr_down, "launches"), (build_pyramid, "calls"),
            (build_pyramid, "launches"),
            (detect_grid, "launches"), (detect_grid, "calls"), (describe, "launches"),
            (describe, "calls"), (multistream_step_local, "syncs"),
            (host_bool, "syncs"))


# ---------------------------------------------------------------------------
# States as plain data (what crosses the pipe)
# ---------------------------------------------------------------------------

def _plain(block) -> dict:
    """A MapState or LoopDB block as numpy arrays, generators as their
    states."""
    if isinstance(block, LoopDB):
        return {"db": {f.name: getattr(block, f.name).cpu().numpy()
                       for f in dataclasses.fields(LoopDB)}}
    return {"tensors": {name: t.cpu().numpy() for name, t in block.tensors()},
            "rng": [g.get_state().numpy() for g in block.rng],
            "rng_type": block.kf_id.device.type}


def _from_plain(d: dict, dev: torch.device):
    """The inverse of :func:`_plain`, onto ``dev``."""
    if "db" in d:
        return LoopDB(**{k: torch.from_numpy(v).to(dev) for k, v in d["db"].items()})
    if d["rng_type"] != dev.type:
        raise ValueError(f"a {d['rng_type']} generator cannot move to {dev}")
    rng = []
    for s in d["rng"]:
        g = torch.Generator(device=dev)
        g.set_state(torch.from_numpy(s))
        rng.append(g)
    return from_tensors({k: torch.from_numpy(v).to(dev) for k, v in d["tensors"].items()},
                        rng=tuple(rng))


def _release(shm) -> None:
    """Close and unlink a shared buffer (either may already be done)."""
    if shm is None:
        return
    try:
        shm.close()
    except BufferError:        # a view still alive: the unlink frees it at its end
        pass
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

class _Shard:
    """One worker's block, on its device, and the step that advances it."""

    def __init__(self, cfg: SlamConfig, cam: Camera, kf_slots: int, loop_delay: int,
                 device: torch.device):
        from alvaar_tpu_torch.parallel.multistream import multistream_step_local
        self.step_fn = multistream_step_local
        self.cfg, self.cam, self.kf_slots, self.loop_delay = cfg, cam, kf_slots, loop_delay
        self.device = device
        self.states = self.dbs = None
        self.upload = UploadRing(device) if device.type == "cuda" else None
        self.frames = None      # the parent's frame buffer, attached
        self.out = None         # this worker's output buffer, which the parent unlinks

    def load(self, states, dbs):
        if states is not None:
            self.states = _from_plain(states, self.device)
        if dbs is not None:
            self.dbs = _from_plain(dbs, self.device)

    def get(self, kind: str) -> dict:
        return _plain(self.states if kind == "states" else self.dbs)

    def _frames_in(self, name: str, shape) -> torch.Tensor:
        if self.frames is None or self.frames.name != name:
            if self.frames is not None:
                self.frames.close()
            self.frames = shared_memory.SharedMemory(name=name)
        view = np.ndarray(shape, np.float32, buffer=self.frames.buf)
        if self.upload is not None:
            return self.upload.upload(view)
        return torch.from_numpy(view.copy())     # the state may keep the frame

    def _write_out(self, out: StepOutput):
        arrays = [(f.name, getattr(out, f.name).cpu().numpy())
                  for f in dataclasses.fields(StepOutput)]
        spec, size = [], 0
        for name, a in arrays:
            spec.append((name, a.dtype.str, a.shape, size))
            size += a.nbytes
        if self.out is None or self.out.size < size:
            if self.out is not None:
                self.out.close()
            self.out = shared_memory.SharedMemory(create=True, size=size)
        for (name, a), (_, _, _, off) in zip(arrays, spec):
            np.ndarray(a.shape, a.dtype, buffer=self.out.buf, offset=off)[...] = a
        return self.out.name, spec

    def step(self, frames_name: str, shape, dts, active) -> dict:
        from alvaar_tpu_torch.parallel.multistream import _dts
        t0 = time.perf_counter()
        before = [getattr(fn, attr) for fn, attr in _counters()]
        frames = self._frames_in(frames_name, shape)
        dev = self.device
        res = self.step_fn(self.states, frames, _dts(dts, shape[0], dev), self.cam, self.cfg,
                           self.kf_slots, self.dbs, self.loop_delay,
                           None if active is None else torch.as_tensor(active).to(dev))
        out = self._write_out(res[-1])
        self.states = res[0]
        if self.dbs is not None:
            self.dbs = res[1]
        return {"out": out, "ms": (time.perf_counter() - t0) * 1e3,
                "counts": [getattr(fn, attr) - b for (fn, attr), b in zip(_counters(), before)]}

    def close(self):
        for shm in (self.frames, self.out):
            if shm is not None:
                shm.close()


def _serve(conn, device_type: str, cfg_fields: dict, cam_fields: dict, kf_slots: int,
           loop_delay: int, float32_flags) -> None:
    """A worker's life: set up on its one device, answer ``ok``, then
    answer each request (``load``, ``step``, ``get``) with
    ``("ok", value)`` or ``("error", traceback)`` until ``close`` or the
    parent's end of the pipe closes."""
    shard = None
    try:
        try:
            visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
            if (device_type == "cuda") != bool(visible) or "," in visible:
                raise RuntimeError(f"a {device_type} mesh worker started with "
                                   f"CUDA_VISIBLE_DEVICES={visible!r}")
            torch.set_num_threads(WORKER_THREADS)
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = float32_flags
            device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
            if device.type == "cuda":
                torch.cuda.set_device(device)
            shard = _Shard(SlamConfig(**cfg_fields), Camera(**cam_fields), kf_slots, loop_delay,
                           device)
            conn.send(("ok", None))
        except Exception:
            conn.send(("error", traceback.format_exc()))
            return
        while True:
            try:
                msg = conn.recv()
            except EOFError:       # the parent is gone
                return
            if msg[0] == "close":
                return
            try:
                reply = ("ok", getattr(shard, msg[0])(*msg[1:]))
            except Exception:
                reply = ("error", traceback.format_exc())
            conn.send(reply)
    finally:
        if shard is not None:
            shard.close()
        conn.close()


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

class ShardHandle:
    """Block ``index`` of a :class:`StreamMesh` as its worker holds it after
    the mesh's step number ``version``: what the step returns in place of
    the block (``kind`` "states" or "dbs").  ``gather_states`` reads it."""

    __slots__ = ("mesh", "index", "version", "kind")

    def __init__(self, mesh: "StreamMesh", index: int, version: int, kind: str):
        self.mesh, self.index, self.version, self.kind = mesh, index, version, kind

    def __repr__(self) -> str:
        return (f"ShardHandle({self.kind} block {self.index} on "
                f"{self.mesh.devices[self.index]}, step {self.version})")


@dataclasses.dataclass
class _Worker:
    proc: object
    conn: object
    frames: object = None        # SharedMemory the parent writes frames into
    frames_view: object = None   # [n, H, W] float32 tensor over it
    out: object = None           # the worker's output SharedMemory, attached


def _spawn(proc, dev: torch.device) -> None:
    """Start ``proc`` with ``CUDA_VISIBLE_DEVICES`` naming ``dev``'s card
    alone, as this process numbers its cards ("" for the CPU): the
    environment the worker starts with, before anything in it can start
    CUDA.  This process's own value is read, set and restored under one
    lock, so that meshes started from several threads at once each read
    the real value, never another's."""
    with _ENVIRON_LOCK:
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        if dev.type != "cuda":
            visible = ""
        elif old is None:
            visible = str(dev.index)
        else:
            visible = [s.strip() for s in old.split(",")][dev.index]
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
        try:
            proc.start()
        finally:
            if old is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old


def _shutdown(workers: list, grace_s: float) -> None:
    """Ask every worker to exit, kill any still alive after ``grace_s``,
    release the shared buffers."""
    for w in workers:
        try:
            w.conn.send(("close",))
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    for w in workers:
        w.proc.join(max(0.0, deadline - time.monotonic()))
        if w.proc.is_alive():
            w.proc.kill()
            w.proc.join()
        w.conn.close()
        w.frames_view = None
        _release(w.frames)
        _release(w.out)
    workers.clear()


class StreamMesh:
    """The sharded step (see the module docstring): ``mesh(blocks, frames,
    dts=None, active=None) → (handles, out)``, with loop closure
    ``mesh(blocks, dbs, frames, dts=None, active=None) → (handles,
    db_handles, out)``.  ``blocks`` (and ``dbs``) are either the blocks of
    ``shard_states`` over the same devices, which the workers take up in
    place of what they held, or the handles the previous call returned."""

    def __init__(self, cfg: SlamConfig, cam: Camera, kf_slots: int, loop_closure: bool,
                 loop_delay: int, devices: list):
        self.devices = list(devices)
        self.loop_closure = loop_closure
        self.last_shard_ms = []     # each worker's own time for the last step
        self._args = (dataclasses.asdict(cfg), dataclasses.asdict(cam), kf_slots, loop_delay)
        self._workers = []
        self._version = 0
        self._n = None
        self._closed = False
        self._finalizer = weakref.finalize(self, _shutdown, self._workers, SHUTDOWN_GRACE_S)

    def __call__(self, blocks, *args, **kwargs):
        if self.loop_closure:
            return self._step(blocks, *args, **kwargs)
        return self._step(blocks, None, *args, **kwargs)

    def close(self) -> None:
        """Stop the workers; their states go with them.  The mesh takes no
        call after this."""
        self._close(SHUTDOWN_GRACE_S)

    def _close(self, grace_s: float) -> None:
        self._closed = True
        if self._finalizer.detach() is not None:
            _shutdown(self._workers, grace_s)

    # -- validation -------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the stream mesh is closed")

    def _check_handles(self, handles, kind: str, in_order: bool) -> None:
        for k, h in enumerate(handles):
            if not isinstance(h, ShardHandle):
                raise ValueError("blocks mix handles and states")
            if h.mesh is not self:
                raise ValueError(f"{h!r} belongs to another stream mesh")
            if h.kind != kind:
                raise ValueError(f"{h!r} where {kind} were expected")
            if h.version != self._version:
                raise ValueError(f"stale {h!r}: the mesh is at step {self._version}")
            if in_order and h.index != k:
                raise ValueError(f"{h!r} at position {k}")

    def _placed(self, blocks, kind: str):
        """None for this mesh's latest handles, else the blocks, each
        checked to lie on its device."""
        if len(blocks) != len(self.devices):
            raise ValueError(f"{len(blocks)} blocks for a mesh of {len(self.devices)} devices")
        if any(isinstance(b, ShardHandle) for b in blocks):
            self._check_handles(blocks, kind, in_order=True)
            return None
        for k, (b, dev) in enumerate(zip(blocks, self.devices)):
            if b.kf_id.device != dev:
                raise ValueError(f"block {k} is on {b.kf_id.device}, the mesh puts it on {dev}")
        return list(blocks)

    # -- the workers ------------------------------------------------------

    def _start(self) -> None:
        if any(d.type == "cuda" for d in self.devices):
            # the workers build nothing: the kernels' libraries are built here first
            from alvaar_tpu_torch.ops.lk_level import build_kernel
            from alvaar_tpu_torch.solvers import ba_kernels, pnp_kernel
            build_kernel()
            ba_kernels.build_kernel()
            pnp_kernel.build_kernel()
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        ctx = torch.multiprocessing.get_context("spawn")
        for k, dev in enumerate(self.devices):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(theirs, dev.type, *self._args, flags),
                               name=f"stream-mesh-{k}", daemon=True)
            _spawn(proc, dev)
            theirs.close()
            self._workers.append(_Worker(proc, ours))
        self._answers(range(len(self.devices)))

    def _send(self, k: int, msg) -> None:
        try:
            self._workers[k].conn.send(msg)
        except OSError as e:
            raise RuntimeError(f"stream mesh worker {k} on {self.devices[k]} is gone "
                               f"(exit code {self._workers[k].proc.exitcode})") from e

    def _answers(self, indices) -> list:
        """Each worker's answer, in ``indices`` order; raises on an error,
        a dead worker or no answer by the deadline."""
        deadline = time.monotonic() + ANSWER_TIMEOUT_S
        values = []
        for k in indices:
            w, where = self._workers[k], f"stream mesh worker {k} on {self.devices[k]}"
            ready = connection.wait([w.conn, w.proc.sentinel],
                                    max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(f"{where} gave no answer within {ANSWER_TIMEOUT_S} s")
            try:
                if not w.conn.poll():
                    raise EOFError
                status, value = w.conn.recv()
            except (EOFError, OSError):    # the pipe closed or was reset
                w.proc.join(SHUTDOWN_GRACE_S)
                raise RuntimeError(f"{where} died (exit code {w.proc.exitcode})") from None
            if status != "ok":
                raise RuntimeError(f"{where} raised:\n{value}")
            values.append(value)
        return values

    def _frames_buffer(self, w: _Worker, shape) -> torch.Tensor:
        if w.frames_view is None or tuple(w.frames_view.shape) != shape:
            w.frames_view = None
            _release(w.frames)
            w.frames = shared_memory.SharedMemory(create=True,
                                                  size=int(np.prod(shape)) * 4)
            w.frames_view = torch.from_numpy(np.ndarray(shape, np.float32, buffer=w.frames.buf))
        return w.frames_view

    def _outputs(self, w: _Worker, name: str, spec) -> dict:
        if w.out is None or w.out.name != name:
            _release(w.out)
            w.out = shared_memory.SharedMemory(name=name)
        return {field: np.ndarray(shape, np.dtype(dt), buffer=w.out.buf, offset=off).copy()
                for field, dt, shape, off in spec}

    def _run(self, states, dbs, frames, n: int, dts, active):
        if not self._workers:
            self._start()
        if states is not None or dbs is not None:
            for k in range(len(self.devices)):
                self._send(k, ("load", None if states is None else _plain(states[k]),
                               None if dbs is None else _plain(dbs[k])))
            self._answers(range(len(self.devices)))
        part = lambda x, k: None if x is None else x[k * n:(k + 1) * n].cpu().numpy()
        for k, w in enumerate(self._workers):
            buf = self._frames_buffer(w, (n,) + tuple(frames.shape[1:]))
            buf.copy_(frames[k * n:(k + 1) * n])
            self._send(k, ("step", w.frames.name, tuple(buf.shape), part(dts, k), part(active, k)))
        replies = self._answers(range(len(self.devices)))
        for r in replies:
            for (fn, attr), d in zip(_counters(), r["counts"]):
                if d:
                    count(fn, attr, d)
        self.last_shard_ms = [r["ms"] for r in replies]
        rows = [self._outputs(w, *r["out"]) for w, r in zip(self._workers, replies)]
        return StepOutput(**{f.name: torch.from_numpy(np.concatenate([r[f.name] for r in rows]))
                             .to(self.devices[0]) for f in dataclasses.fields(StepOutput)})

    def _step(self, blocks, dbs, frames, dts=None, active=None):
        self._check_open()
        states = self._placed(blocks, "states")
        tables = None if dbs is None else self._placed(dbs, "dbs")
        if states is not None:
            sizes = {num_streams(b) for b in states}
            if len(sizes) != 1:
                raise ValueError(f"blocks of unequal sizes {sorted(sizes)}")
            n = sizes.pop()
        else:
            n = self._n
        frames = torch.as_tensor(frames)
        if frames.shape[0] != n * len(self.devices):
            raise ValueError(f"{frames.shape[0]} frames for {n * len(self.devices)} streams")
        dts = None if dts is None else torch.as_tensor(dts)
        active = None if active is None else torch.as_tensor(active)
        try:
            out = self._run(states, tables, frames, n, dts, active)
        except BaseException:
            self._close(0.0)         # the shards may no longer be at one step
            raise
        self._n = n
        self._version += 1
        handles = [ShardHandle(self, k, self._version, "states") for k in range(len(self.devices))]
        if dbs is None:
            return handles, out
        return handles, [ShardHandle(self, k, self._version, "dbs")
                         for k in range(len(self.devices))], out

    def fetch(self, handles, device=None) -> list:
        """The blocks that this mesh's latest ``handles`` stand for, as
        MapState or LoopDB blocks on ``device`` (``devices[0]`` by
        default), generators included."""
        self._check_open()
        self._check_handles(handles, handles[0].kind, in_order=False)
        dev = self.devices[0] if device is None else device
        try:
            for h in handles:
                self._send(h.index, ("get", h.kind))
            plain = self._answers([h.index for h in handles])
        except BaseException:
            self._close(0.0)
            raise
        return [_from_plain(p, dev) for p in plain]
