"""Live camera ingest: V4L2 capture via stdlib ioctl + mmap.

Port of alvaar_tpu/io/camera.py, unchanged in behaviour: the counterpart
of the reference's getUserMedia camera layer (reference
examples/public/assets/utils.js:112-239 Camera class).  Headless Linux
has no getUserMedia, so this speaks Video4Linux2 directly (no OpenCV, no
ffmpeg binary): VIDIOC_S_FMT → REQBUFS(MMAP) → QBUF/STREAMON → DQBUF
loop, converting YUYV (the near-universal webcam format) or GREY to the
engine's grayscale float32 frames, which ``AlvaAR`` uploads to its
device.

The ioctl request numbers are computed from the struct sizes with the
kernel's _IOC macro; the tests pin them against the known kernel values
(e.g. VIDIOC_QUERYCAP = 0x80685600), which checks the struct layouts
below.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import select
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

# ---- _IOC encoding (linux/ioctl.h) ----------------------------------------
_IOC_WRITE, _IOC_READ = 1, 2


def _ioc(direction: int, nr: int, size: int, typ: int = ord("V")) -> int:
    return (direction << 30) | (size << 16) | (typ << 8) | nr


def fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


# ---- struct sizes (x86-64 kernel ABI) --------------------------------------
SIZEOF_CAPABILITY = 104      # v4l2_capability
SIZEOF_FORMAT = 208          # v4l2_format (4 type + 4 pad + 200 union)
SIZEOF_REQUESTBUFFERS = 20   # v4l2_requestbuffers
SIZEOF_BUFFER = 88           # v4l2_buffer (64-bit)

VIDIOC_QUERYCAP = _ioc(_IOC_READ, 0, SIZEOF_CAPABILITY)
VIDIOC_S_FMT = _ioc(_IOC_READ | _IOC_WRITE, 5, SIZEOF_FORMAT)
VIDIOC_REQBUFS = _ioc(_IOC_READ | _IOC_WRITE, 8, SIZEOF_REQUESTBUFFERS)
VIDIOC_QUERYBUF = _ioc(_IOC_READ | _IOC_WRITE, 9, SIZEOF_BUFFER)
VIDIOC_QBUF = _ioc(_IOC_READ | _IOC_WRITE, 15, SIZEOF_BUFFER)
VIDIOC_DQBUF = _ioc(_IOC_READ | _IOC_WRITE, 17, SIZEOF_BUFFER)
VIDIOC_STREAMON = _ioc(_IOC_WRITE, 18, 4)
VIDIOC_STREAMOFF = _ioc(_IOC_WRITE, 19, 4)

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_CAP_VIDEO_CAPTURE = 0x00000001
V4L2_CAP_STREAMING = 0x04000000
V4L2_FIELD_NONE = 1

PIX_FMT_YUYV = fourcc("YUYV")
PIX_FMT_GREY = fourcc("GREY")


class CameraCapture:
    """Stream grayscale frames from a V4L2 device.

    Usage::

        with CameraCapture("/dev/video0", width=1280, height=720) as cam:
            for gray, ts in cam.frames():
                pose = alva.find_camera_pose(gray, timestamp=ts)

    Negotiates YUYV first (webcams), falling back to GREY (mono/IR
    sensors); the driver may adjust width/height — the actual geometry is
    in ``self.width/height`` after open.
    """

    def __init__(self, device: str = "/dev/video0", width: int = 1280,
                 height: int = 720, num_buffers: int = 4):
        self.device = device
        self._fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self._maps: list = []
        self._streaming = False
        try:
            caps = self._querycap()
            if not (caps & V4L2_CAP_VIDEO_CAPTURE) or \
               not (caps & V4L2_CAP_STREAMING):
                raise OSError(f"{device} lacks streaming video capture "
                              f"(caps=0x{caps:08x})")
            self.pixelformat, self.width, self.height, self._stride = \
                self._set_format(width, height)
            self._request_buffers(num_buffers)
            for i in range(self._nbufs):
                self._queue(i)
            self._stream(on=True)
        except Exception:
            self.close()
            raise

    # ---- V4L2 plumbing ---------------------------------------------------
    def _querycap(self) -> int:
        buf = bytearray(SIZEOF_CAPABILITY)
        fcntl.ioctl(self._fd, VIDIOC_QUERYCAP, buf)
        # capabilities is the u32 right after driver[16]+card[32]+bus[32]+version
        return struct.unpack_from("<I", buf, 16 + 32 + 32 + 4)[0]

    def _set_format(self, width: int, height: int):
        last_err: Optional[OSError] = None
        for pixfmt in (PIX_FMT_YUYV, PIX_FMT_GREY):
            buf = bytearray(SIZEOF_FORMAT)
            struct.pack_from("<I", buf, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            # v4l2_pix_format at offset 8 (union is 8-aligned)
            struct.pack_from("<IIII", buf, 8, width, height, pixfmt,
                             V4L2_FIELD_NONE)
            try:
                fcntl.ioctl(self._fd, VIDIOC_S_FMT, buf)
            except OSError as e:
                last_err = e
                continue
            w, h, got_fmt, _, stride = struct.unpack_from("<IIIII", buf, 8)
            if got_fmt == pixfmt:
                return pixfmt, w, h, stride
        raise OSError(f"{self.device}: no YUYV/GREY format "
                      f"({last_err})")

    def _request_buffers(self, count: int) -> None:
        buf = bytearray(SIZEOF_REQUESTBUFFERS)
        struct.pack_from("<III", buf, 0, count, V4L2_BUF_TYPE_VIDEO_CAPTURE,
                         V4L2_MEMORY_MMAP)
        fcntl.ioctl(self._fd, VIDIOC_REQBUFS, buf)
        self._nbufs = struct.unpack_from("<I", buf, 0)[0]
        if self._nbufs < 2:
            raise OSError("driver granted <2 buffers")
        for i in range(self._nbufs):
            qb = bytearray(SIZEOF_BUFFER)
            struct.pack_from("<II", qb, 0, i, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_from("<I", qb, 60, V4L2_MEMORY_MMAP)  # memory @60
            fcntl.ioctl(self._fd, VIDIOC_QUERYBUF, qb)
            offset = struct.unpack_from("<I", qb, 64)[0]   # union m.offset
            length = struct.unpack_from("<I", qb, 72)[0]   # length
            self._maps.append(mmap.mmap(self._fd, length, mmap.MAP_SHARED,
                                        mmap.PROT_READ, offset=offset))

    def _buffer_ioctl(self, req: int, index: int) -> Tuple[int, float, int]:
        qb = bytearray(SIZEOF_BUFFER)
        struct.pack_from("<II", qb, 0, index, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_from("<I", qb, 60, V4L2_MEMORY_MMAP)
        fcntl.ioctl(self._fd, req, qb)
        idx, _, bytesused = struct.unpack_from("<III", qb, 0)
        sec, usec = struct.unpack_from("<qq", qb, 24)      # timeval
        return idx, sec + usec * 1e-6, bytesused

    def _queue(self, index: int) -> None:
        self._buffer_ioctl(VIDIOC_QBUF, index)

    def _stream(self, on: bool) -> None:
        arg = struct.pack("<i", V4L2_BUF_TYPE_VIDEO_CAPTURE)
        fcntl.ioctl(self._fd, VIDIOC_STREAMON if on else VIDIOC_STREAMOFF,
                    arg)
        self._streaming = on

    # ---- public ------------------------------------------------------------
    def read(self, timeout: float = 2.0):
        """One grayscale frame: (gray f32 [H, W], timestamp s) or None on
        timeout."""
        r, _, _ = select.select([self._fd], [], [], timeout)
        if not r:
            return None
        idx, ts, _ = self._buffer_ioctl(VIDIOC_DQBUF, 0)
        raw = np.frombuffer(self._maps[idx], np.uint8,
                            count=self._stride * self.height)
        rows = raw.reshape(self.height, self._stride)
        if self.pixelformat == PIX_FMT_YUYV:
            gray = rows[:, : self.width * 2 : 2]   # Y of YUYV pairs
        else:
            gray = rows[:, : self.width]
        gray = gray.astype(np.float32)
        self._queue(idx)
        return gray, ts

    def frames(self) -> Iterator[Tuple[np.ndarray, float]]:
        while True:
            out = self.read()
            if out is None:
                return
            yield out

    def close(self) -> None:
        if self._fd is None:
            return
        if self._streaming:
            try:
                self._stream(on=False)
            except OSError:
                pass
        for m in self._maps:
            m.close()
        self._maps.clear()
        os.close(self._fd)
        self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            if getattr(self, "_fd", None) is not None:
                self.close()
        except Exception:
            pass
