"""AlvaAR-compatible facade over the PyTorch pipeline.

Port of the single-stream surface of alvaar_tpu/system.py: construction
from (width, height, fov), ``find_camera_pose``, ``last_status``,
``get_frame_points`` and ``reset``, with the same status codes (1 =
tracking → pose returned; 2 = reset → None; 3 = initializing → None).

The map state stays on the device across calls; each frame costs one
upload and one small packed readback (status, pose, counts), plus the
host syncs of the data-dependent branches in the step
(``host_bool.syncs`` counts them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.frontend.step import slam_step
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.ops.image import rgba_to_gray
from alvaar_tpu_torch.worldmap.state import init_map_state

_UNPORTED = ("use_five_point", "use_homography_init", "use_clahe")


def pose_to_array(T_wc: np.ndarray) -> np.ndarray:
    """4x4 → 16-float column-major array (the reference's wire format)."""
    return np.asarray(T_wc, np.float32).T.reshape(-1).copy()


class AlvaAR:
    """Monocular visual SLAM with the AlvaAR API, on PyTorch.

    ``device="cuda"`` (the default) raises when CUDA is not available; the
    port never moves to the CPU on its own.  Tests pass ``device="cpu"``."""

    def __init__(self, width: int, height: int, fov: float = 45.0,
                 config: Optional[SlamConfig] = None, device="cuda",
                 camera: Optional[Camera] = None):
        cfg = config or SlamConfig()
        if cfg.width != width or cfg.height != height:
            cfg = dataclasses.replace(cfg, width=width, height=height)
        on = [name for name in _UNPORTED if getattr(cfg, name)]
        if on:
            raise NotImplementedError(
                f"not ported to alvaar_tpu_torch yet: {', '.join(on)} "
                "(set them False)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AlvaAR(device='cuda'): CUDA is not available")
        # the solvers and BA depend on full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = cfg
        self.camera = camera if camera is not None else Camera.from_fov(width, height, fov)
        self.state = init_map_state(cfg, self.device)
        self._last = None           # host copy of the last frame's outputs
        self._last_ts: Optional[float] = None

    def _dt(self, timestamp: Optional[float]) -> float:
        if timestamp is None:
            self._last_ts = None
            return 1.0
        dt = 1.0 if self._last_ts is None else float(timestamp) - self._last_ts
        self._last_ts = float(timestamp)
        return dt if dt > 0 else 1.0

    def find_camera_pose(self, frame, timestamp: Optional[float] = None
                         ) -> Optional[np.ndarray]:
        """Run one SLAM iteration on a [H, W] gray or [H, W, 4] RGBA frame.
        Returns the 4x4 camera-to-world pose when tracking (status 1),
        else None."""
        f = np.asarray(frame)
        if f.dtype == np.float64:       # upload float32, as JAX does without x64
            f = f.astype(np.float32)
        f = torch.as_tensor(f).to(self.device)
        gray = rgba_to_gray(f) if f.ndim == 3 else f.to(torch.float32)
        self.state, out = slam_step(self.state, gray, self.camera, self.config,
                                    self._dt(timestamp))
        packed = torch.cat([
            out.status.reshape(1).to(torch.float32), out.pose_wc.reshape(-1),
            out.num_tracked.reshape(1).to(torch.float32),
            out.num_3d.reshape(1).to(torch.float32),
            out.is_keyframe.reshape(1).to(torch.float32)]).cpu().numpy()
        self._last = (packed, out.points, out.points_valid)
        if int(packed[0]) != 1:
            return None
        return packed[1:17].reshape(4, 4).copy()

    @property
    def last_status(self) -> int:
        """Status of the last processed frame (0 before the first)."""
        return int(self._last[0][0]) if self._last is not None else 0

    @property
    def last_is_keyframe(self) -> bool:
        return self._last is not None and bool(self._last[0][19] > 0.5)

    def get_frame_points(self) -> np.ndarray:
        """[N, 2] int32 tracked keypoint pixels of the last frame."""
        if self._last is None:
            return np.zeros((0, 2), np.int32)
        pts = self._last[1].cpu().numpy()
        valid = self._last[2].cpu().numpy()
        return pts[valid].astype(np.int32)

    def reset(self) -> None:
        """Full reset (the random stream carries on)."""
        self.state = init_map_state(self.config, self.device, rng=self.state.rng)
        self._last = None
        self._last_ts = None
