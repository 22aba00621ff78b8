"""Pinhole camera with radial-tangential distortion — batched torch.

Port of alvaar_tpu/geom/camera.py.  Intrinsics are Python floats rounded
through float32, so every product with a float32 tensor stays float32 and
the values equal the JAX package's float32 scalars.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> "Camera":
        return Camera(*(_f32(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2)))

    @staticmethod
    def from_fov(width: int, height: int, fov_deg: float = 45.0) -> "Camera":
        """fx = fy = min over both axes of half-size / tan(fov / 2), zero
        distortion, computed in float32 as the JAX package does."""
        fov = np.float32(np.deg2rad(np.float32(fov_deg)))
        tan_half = np.tan(np.float32(fov / np.float32(2.0)))
        fx = np.float32(width / 2.0) / tan_half
        fy = np.float32(height / 2.0) / tan_half
        f = min(np.float32(fx), np.float32(fy))
        return Camera.create(f, f, width / 2.0, height / 2.0)

    @property
    def has_distortion(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.p1, self.p2))

    def _distort_normalized(self, xn):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xy = x * y
        xd = x * radial + 2.0 * self.p1 * xy + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * xy
        return torch.stack([xd, yd], dim=-1)

    def project(self, x_cam):
        """Camera-frame points [..., 3] → undistorted pixels [..., 2]."""
        z = x_cam[..., 2:3]
        xn = x_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return self._k_apply(xn)

    def project_dist(self, x_cam):
        """Camera-frame points → distorted pixels."""
        z = x_cam[..., 2:3]
        xn = x_cam[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return self._k_apply(self._distort_normalized(xn))

    def _k_apply(self, xn):
        return torch.stack([self.fx * xn[..., 0] + self.cx,
                            self.fy * xn[..., 1] + self.cy], dim=-1)

    def _k_unapply(self, px):
        return torch.stack([(px[..., 0] - self.cx) / self.fx,
                            (px[..., 1] - self.cy) / self.fy], dim=-1)

    def undistort(self, px, iters: int = 5):
        """Distorted pixels [..., 2] → undistorted pixels by the
        fixed-point iteration of cv::undistortPoints."""
        xd = self._k_unapply(px)
        xu = xd
        for _ in range(iters):
            x, y = xu[..., 0], xu[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            xu = torch.stack([(xd[..., 0] - dx) / radial,
                              (xd[..., 1] - dy) / radial], dim=-1)
        return self._k_apply(xu)

    def bearing(self, px_undist):
        """Undistorted pixels [..., 2] → unit bearings [..., 3]."""
        xn = self._k_unapply(px_undist)
        v = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    def in_roi(self, px, width: int, height: int, border: int = 20):
        x, y = px[..., 0], px[..., 1]
        return (x >= border) & (x < width - border) & (y >= border) & (y < height - border)

    @property
    def focal(self) -> float:
        """(fx + fy) / 2 in float32, the angular-threshold focal."""
        return _f32(np.float32(0.5) * (np.float32(self.fx) + np.float32(self.fy)))
