"""ctypes wrapper over the native frame ring (native/frame_ring.cpp).

Port of alvaar_tpu/io/frame_ring.py, with the same API.  Producers push
raw RGBA or gray bytes, the native code converts them to grayscale
float32 (BT.601, the reference's cv::cvtColor pass, system.cpp:111-112),
and the consumer maps the oldest slot zero-copy as a numpy array, copies
it, and releases the slot; ``AlvaAR`` uploads the copy as it does any
numpy frame.

The library is built from native/frame_ring.cpp with ``g++ -O3 -fPIC
-shared`` into ``build/`` at first use (utils/build.py).  Without
``-march=native`` the compiler contracts no multiply-add, so an RGBA slot
holds ``0.299 r + 0.587 g + 0.114 b`` in float32, rounded after each
operation as ``ops/image.rgba_to_gray`` computes it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from alvaar_tpu_torch.utils.build import build_library, find_tool

_SRC = Path(__file__).resolve().parents[2] / "native" / "frame_ring.cpp"
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            gxx = find_tool("g++", why="a C++ compiler is needed to build the frame ring")
            lib = ctypes.CDLL(str(build_library(_SRC, gxx, _FLAGS)))
            lib.fr_create.restype = ctypes.c_void_p
            lib.fr_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.fr_destroy.argtypes = [ctypes.c_void_p]
            lib.fr_destroy.restype = None
            lib.fr_capacity.argtypes = [ctypes.c_void_p]
            lib.fr_capacity.restype = ctypes.c_int
            lib.fr_count.argtypes = [ctypes.c_void_p]
            lib.fr_count.restype = ctypes.c_longlong
            lib.fr_push_rgba.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double]
            lib.fr_push_rgba.restype = ctypes.c_longlong
            lib.fr_push_gray_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double]
            lib.fr_push_gray_u8.restype = ctypes.c_longlong
            lib.fr_front.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
            lib.fr_front.restype = ctypes.POINTER(ctypes.c_float)
            lib.fr_release.argtypes = [ctypes.c_void_p]
            lib.fr_release.restype = ctypes.c_int
            _lib = lib
    return _lib


class FrameRing:
    """Bounded ring of grayscale float32 frames with native pixel prep.
    One producer thread and one consumer thread may use it at once."""

    def __init__(self, width: int, height: int, capacity: int = 8):
        self._lib = _load_lib()
        self.width = width
        self.height = height
        self._h = self._lib.fr_create(width, height, capacity)
        if not self._h:
            raise MemoryError("frame ring allocation failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fr_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.fr_count(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.fr_capacity(self._h))

    def push_rgba(self, rgba: np.ndarray, timestamp: float = 0.0) -> int:
        """Push an [H, W, 4] uint8 frame; RGBA→gray runs natively.
        Returns the sequence number or -1 if the ring is full."""
        rgba = np.ascontiguousarray(rgba, np.uint8)
        if rgba.shape != (self.height, self.width, 4):
            raise ValueError(f"RGBA frame of shape {rgba.shape}, the ring takes "
                             f"{(self.height, self.width, 4)}")
        return int(self._lib.fr_push_rgba(
            self._h, rgba.ctypes.data_as(ctypes.c_void_p), timestamp))

    def push_gray(self, gray: np.ndarray, timestamp: float = 0.0) -> int:
        """Push an [H, W] uint8 frame (widened to float32).  Returns the
        sequence number or -1 if the ring is full."""
        gray = np.ascontiguousarray(gray, np.uint8)
        if gray.shape != (self.height, self.width):
            raise ValueError(f"gray frame of shape {gray.shape}, the ring takes "
                             f"{(self.height, self.width)}")
        return int(self._lib.fr_push_gray_u8(
            self._h, gray.ctypes.data_as(ctypes.c_void_p), timestamp))

    def front(self) -> Optional[Tuple[np.ndarray, float]]:
        """Zero-copy view of the oldest frame + its timestamp, or None.
        The view is valid until release()."""
        ts = ctypes.c_double()
        ptr = self._lib.fr_front(self._h, ctypes.byref(ts))
        if not ptr:
            return None
        arr = np.ctypeslib.as_array(ptr, shape=(self.height, self.width))
        return arr, float(ts.value)

    def release(self) -> bool:
        return bool(self._lib.fr_release(self._h))
