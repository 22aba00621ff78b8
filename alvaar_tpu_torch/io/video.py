"""ctypes wrapper over the native video decoder (native/video_decoder.cpp).

Port of alvaar_tpu/io/video.py, with the same API: demux, decode and gray
conversion run in native code (FFmpeg's libav*); Python sees grayscale
uint8 frames and presentation timestamps, ready for the FrameRing or for
``AlvaAR.find_camera_pose``.

The library: where the compiler finds the libav headers, native/
video_decoder.cpp is built with ``g++ -O3 -fPIC -shared`` into ``build/``
at first use (utils/build.py); where it does not, the repository's
prebuilt native/libvideodec.so is loaded (it needs the libav runtime
libraries).  When neither works the error says why.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from alvaar_tpu_torch.utils.build import build_library, find_tool

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE_DIR / "video_decoder.cpp"
_PREBUILT = _NATIVE_DIR / "libvideodec.so"
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h", "libavutil/imgutils.h",
            "libswscale/swscale.h")
_lib: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def _missing_headers(gxx: str) -> str:
    """'' when ``gxx`` preprocesses the decoder's libav includes, else
    the preprocessor's complaint."""
    src = "".join(f"#include <{h}>\n" for h in _HEADERS)
    res = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", "/dev/null"], input=src,
                         capture_output=True, text=True)
    return "" if res.returncode == 0 else (res.stderr.strip() or f"g++ -E exited {res.returncode}")


def _library_path() -> Path:
    """The decoder library to load: built from source where the libav
    headers are present, else the repository's prebuilt copy."""
    gxx = find_tool("g++", why="a C++ compiler is needed to build the video decoder")
    missing = _missing_headers(gxx)
    if not missing:
        return build_library(_SRC, gxx, _FLAGS, _LIBS)
    if not _PREBUILT.exists():
        raise RuntimeError(f"cannot build {_SRC.name}: the libav headers are missing "
                           f"({missing}), and there is no prebuilt {_PREBUILT}")
    return _PREBUILT


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            path = _library_path()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the video decoder {path}: {e} (the libav "
                                   f"runtime libraries are needed)") from e
            lib.vd_open.restype = ctypes.c_void_p
            lib.vd_open.argtypes = [ctypes.c_char_p]
            lib.vd_close.argtypes = [ctypes.c_void_p]
            lib.vd_close.restype = None
            lib.vd_width.argtypes = [ctypes.c_void_p]
            lib.vd_width.restype = ctypes.c_int
            lib.vd_height.argtypes = [ctypes.c_void_p]
            lib.vd_height.restype = ctypes.c_int
            lib.vd_fps.argtypes = [ctypes.c_void_p]
            lib.vd_fps.restype = ctypes.c_double
            lib.vd_nframes.argtypes = [ctypes.c_void_p]
            lib.vd_nframes.restype = ctypes.c_longlong
            lib.vd_next_gray.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_double)]
            lib.vd_next_gray.restype = ctypes.c_int
            _lib = lib
    return _lib


class VideoReader:
    """Iterate grayscale uint8 frames (+ pts seconds) from a video file."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.vd_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.width = int(self._lib.vd_width(self._h))
        self.height = int(self._lib.vd_height(self._h))
        self.fps = float(self._lib.vd_fps(self._h))
        self.nframes = int(self._lib.vd_nframes(self._h))  # 0 if unknown
        self._last_pts: Optional[float] = None

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self) -> Optional[Tuple[np.ndarray, float]]:
        """Next (gray [H, W] uint8, pts seconds) or None at end-of-stream."""
        if not getattr(self, "_h", None):
            return None
        out = np.empty((self.height, self.width), np.uint8)
        pts = ctypes.c_double(-1.0)
        r = self._lib.vd_next_gray(self._h, out.ctypes.data_as(ctypes.c_void_p),
                                   ctypes.byref(pts))
        if r == 0:
            return None
        if r < 0:
            raise IOError("video decode error")
        # containers with broken edit lists emit garbage or duplicate pts
        # (the reference's own demo mp4 does: µs-scale deltas after the
        # first frame): keep the clock strictly increasing, stepping by the
        # nominal frame interval where it is not
        t = float(pts.value)
        step = 1.0 / self.fps if self.fps > 1e-6 else 1.0 / 30.0
        if self._last_pts is not None and t <= self._last_pts + 0.1 * step:
            t = self._last_pts + step
        self._last_pts = t
        return out, t

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        while True:
            item = self.read()
            if item is None:
                return
            yield item
