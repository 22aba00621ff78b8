"""Network front door for the batched SLAM engine (port of
alvaar_tpu/serving/server.py).

Many independent camera streams share one batched step
(parallel/multistream.py ``multistream_step_local``), each TCP client
owning one stream slot.

  * stdlib only (socket/threading/struct);
  * one engine thread owns every device operation: it builds the stacked
    state, runs the batched step with the ``active`` mask (clients at
    different frame rates share a batch, no lockstep) and reads the
    outputs back; client threads only move bytes and host arrays;
  * a slot's state row is overwritten with a fresh one when its client
    disconnects, so slots recycle.

Wire protocol (little-endian), the JAX package's byte for byte:
  client hello:  magic b"ALVA", u16 version=1, u16 flags, u32 w, u32 h,
                 f32 fov_deg           (flags bit0: send tracked points)
  per frame  →:  u32 frame_id, u32 nbytes, gray u8[h*w] (nbytes = h*w)
  per frame  ←:  u32 frame_id, i32 status (1 tracking / 2 lost / 3 init),
                 f32[16] column-major T_wc, u32 n, f32[n*2] points
                 (status==1 and points requested, else n=0).
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.parallel.multistream import make_multistream_step
from alvaar_tpu_torch.worldmap.state import (init_map_state, init_multistream_state,
                                             stack_states, write_rows)

MAGIC = b"ALVA"
VERSION = 1
FLAG_POINTS = 1

_HELLO = struct.Struct("<4sHHIIf")
_FRAME_HDR = struct.Struct("<II")
_REPLY_HDR = struct.Struct("<Ii16fI")


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


@dataclass
class _Slot:
    lock: threading.Lock
    sock: Optional[socket.socket] = None
    frame: Optional[np.ndarray] = None   # pending gray frame
    frame_id: int = 0
    want_points: bool = False
    needs_reset: bool = False


class SlamServer:
    """Serve ``num_streams`` concurrent SLAM sessions over TCP on one
    device (``"cuda"`` unless the caller passes ``device="cpu"``).

    Usage::

        srv = SlamServer(num_streams=8, width=640, height=480, fov=60.0)
        srv.start()          # returns immediately; srv.port is bound
        ...
        srv.stop()
    """

    def __init__(self, num_streams: int = 8, width: int = 640,
                 height: int = 480, fov: float = 60.0,
                 host: str = "127.0.0.1", port: int = 0,
                 config: Optional[SlamConfig] = None, kf_slots: int = 3,
                 device="cuda"):
        self.cfg = config or SlamConfig(width=width, height=height)
        self.num_streams = num_streams
        self.fov = fov
        self.host, self.port = host, port
        self.kf_slots = kf_slots
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamServer(device='cuda'): CUDA is not available")
        self._slots = [_Slot(lock=threading.Lock()) for _ in range(num_streams)]
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lsock: Optional[socket.socket] = None
        self.frames_served = 0
        self.engine_error: Optional[BaseException] = None

    # ---- engine ---------------------------------------------------------

    def _engine_loop(self):
        try:
            self._serve_batches()
        except BaseException as e:     # recorded for the owner, then re-raised
            self.engine_error = e
            raise

    def _serve_batches(self):
        cfg, dev, b = self.cfg, self.device, self.num_streams
        cam = Camera.from_fov(cfg.width, cfg.height, self.fov)
        step = make_multistream_step(cfg, cam, self.kf_slots)
        states = init_multistream_state(cfg, b, device=dev)
        zero = np.zeros((cfg.height, cfg.width), np.float32)
        dts = torch.ones(b, dtype=torch.float32, device=dev)

        while not self._stop.is_set():
            batch, active, meta = [], [], []
            for i, sl in enumerate(self._slots):
                with sl.lock:
                    if sl.needs_reset:
                        # recycle the slot: a fresh row (its generator
                        # carries on)
                        fresh = init_map_state(cfg, dev, rng=states.rng[i])
                        states = write_rows(states, [i], stack_states([fresh]))
                        sl.needs_reset = False
                    if sl.frame is not None:
                        batch.append(sl.frame)
                        active.append(True)
                        meta.append((i, sl.frame_id, sl.sock, sl.want_points))
                        sl.frame = None
                    else:
                        batch.append(zero)
                        active.append(False)
            if not any(active):
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            frames = torch.as_tensor(np.stack(batch)).to(dev)
            states, outs = step(states, frames, dts,
                                torch.tensor(active, dtype=torch.bool, device=dev))
            status = outs.status.cpu().numpy()
            poses = outs.pose_wc.cpu().numpy()
            pts = outs.points.cpu().numpy()
            pts_ok = outs.points_valid.cpu().numpy()
            for i, fid, sock, want_pts in meta:
                if sock is None:
                    continue
                pose = poses[i].T.reshape(-1)  # column-major 16 floats
                if want_pts and status[i] == 1:
                    p = pts[i][pts_ok[i]].astype(np.float32)
                else:
                    p = np.zeros((0, 2), np.float32)
                msg = _REPLY_HDR.pack(fid, int(status[i]), *pose.tolist(), len(p)) + p.tobytes()
                try:
                    sock.sendall(msg)
                except OSError:
                    pass
                self.frames_served += 1

    # ---- network --------------------------------------------------------

    def _client_loop(self, sock: socket.socket, slot_idx: int):
        sl = self._slots[slot_idx]
        cfg = self.cfg
        try:
            hello = _recv_exact(sock, _HELLO.size)
            if hello is None:
                return
            magic, ver, flags, w, h, _fov = _HELLO.unpack(hello)
            if magic != MAGIC or ver != VERSION or (w, h) != (cfg.width, cfg.height):
                return
            with sl.lock:
                sl.want_points = bool(flags & FLAG_POINTS)
            nbytes = cfg.width * cfg.height
            while not self._stop.is_set():
                hdr = _recv_exact(sock, _FRAME_HDR.size)
                if hdr is None:
                    break
                fid, n = _FRAME_HDR.unpack(hdr)
                if n != nbytes:
                    break
                payload = _recv_exact(sock, n)
                if payload is None:
                    break
                gray = np.frombuffer(payload, np.uint8).reshape(
                    cfg.height, cfg.width).astype(np.float32)
                # latest-frame-wins: a slow engine drops stale frames
                # rather than building a queue
                with sl.lock:
                    sl.frame = gray
                    sl.frame_id = fid
                self._wake.set()
        except OSError:
            pass       # the client went away; the slot is recycled below
        finally:
            with sl.lock:
                sl.sock = None
                sl.frame = None
                sl.needs_reset = True
            try:
                sock.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            idx = None
            for i, sl in enumerate(self._slots):
                with sl.lock:
                    if sl.sock is None:
                        sl.sock = sock
                        idx = i
                        break
            if idx is None:
                sock.close()     # at capacity
                continue
            t = threading.Thread(target=self._client_loop, args=(sock, idx), daemon=True)
            t.start()
            self._threads.append(t)

    def start(self) -> "SlamServer":
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.host, self.port))
        self.port = self._lsock.getsockname()[1]
        self._lsock.listen(self.num_streams)
        for target in (self._engine_loop, self._accept_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop accepting, disconnect the clients, end the engine and wait
        for the threads."""
        self._stop.set()
        self._wake.set()
        socks = [self._lsock] if self._lsock is not None else []
        for sl in self._slots:
            with sl.lock:
                if sl.sock is not None:
                    socks.append(sl.sock)
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=timeout)


class SlamClient:
    """Minimal client for SlamServer (one stream)."""

    def __init__(self, host: str, port: int, width: int, height: int,
                 fov: float = 60.0, want_points: bool = False):
        self.sock = socket.create_connection((host, port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.width, self.height = width, height
        flags = FLAG_POINTS if want_points else 0
        self.sock.sendall(_HELLO.pack(MAGIC, VERSION, flags, width, height, fov))
        self._fid = 0
        self.last_frame_id: Optional[int] = None   # frame id of the last reply

    def process(self, gray: np.ndarray, timeout: float = 30.0):
        """Send one grayscale frame; returns (status, pose 4x4 T_wc or
        None, points [N, 2])."""
        g = np.ascontiguousarray(gray, np.uint8)
        if g.shape != (self.height, self.width):
            raise ValueError(f"frame {g.shape}, the session is {(self.height, self.width)}")
        self._fid += 1
        self.sock.sendall(_FRAME_HDR.pack(self._fid, g.size) + g.tobytes())
        self.sock.settimeout(timeout)
        hdr = _recv_exact(self.sock, _REPLY_HDR.size)
        if hdr is None:
            raise ConnectionError("server closed")
        vals = _REPLY_HDR.unpack(hdr)
        status, n = vals[1], vals[-1]
        self.last_frame_id = vals[0]
        pose = None
        if status == 1:
            pose = np.asarray(vals[2:18], np.float32).reshape(4, 4).T
        pts = np.zeros((0, 2), np.float32)
        if n:
            raw = _recv_exact(self.sock, n * 8)
            pts = np.frombuffer(raw, np.float32).reshape(n, 2)
        return status, pose, pts

    def close(self):
        self.sock.close()
