"""Frame capture: a decode thread that feeds a FrameRing from a video.

Port of alvaar_tpu/io/capture.py (the role of the reference's capture
utilities, examples/public/assets/utils.js Camera/Video classes): a
background thread decodes frames into the port's native ring while the
SLAM loop consumes them, so decode jitter stays off the per-frame step.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from alvaar_tpu_torch.io.frame_ring import FrameRing
from alvaar_tpu_torch.io.video import VideoReader


class VideoCapture:
    """Decode a video file into a FrameRing on a background thread.

    Usage::

        cap = VideoCapture("video.mp4")
        for gray, ts in cap.frames():
            pose = alva.find_camera_pose(gray, timestamp=ts)
    """

    def __init__(self, path: str, capacity: int = 8, max_frames: Optional[int] = None):
        self._reader = VideoReader(path)
        self.width = self._reader.width
        self.height = self._reader.height
        self.fps = self._reader.fps
        self.ring = FrameRing(self.width, self.height, capacity)
        self._max_frames = max_frames
        self._done = threading.Event()
        self._stop = threading.Event()
        self._space = threading.Semaphore(capacity)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        n = 0
        try:
            for gray, ts in self._reader:
                if self._stop.is_set() or (self._max_frames is not None
                                           and n >= self._max_frames):
                    break
                self._space.acquire()
                if self._stop.is_set():
                    break
                if self.ring.push_gray(gray, ts) < 0:
                    raise RuntimeError("frame ring overflow despite the semaphore")
                n += 1
        finally:
            self._done.set()

    def frames(self) -> Iterator[Tuple[np.ndarray, float]]:
        """Yield (gray float32 [H, W] copy, timestamp) in decode order."""
        while True:
            item = self.ring.front()
            if item is None:
                if self._done.is_set() and len(self.ring) == 0:
                    return
                self._done.wait(timeout=0.005)
                continue
            view, ts = item
            frame = view.copy()          # detach from the ring slot
            self.ring.release()
            self._space.release()
            yield frame, ts

    def close(self) -> None:
        self._stop.set()
        self._space.release()            # unblock a waiting producer
        self._thread.join(timeout=2.0)
        self._done.set()
