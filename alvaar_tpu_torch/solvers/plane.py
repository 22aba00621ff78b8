"""Horizontal-plane detection by batched 3-point RANSAC over map points
(port of alvaar_tpu/solvers/plane.py).

Each hypothesis is the plane through 3 sampled points; hypotheses whose
normal is more than ``max_tilt_deg`` off +z are dropped; the score is the
20th-percentile point-plane distance; inliers lie within
``inlier_scale`` × the best score.  The winner is refit on its inliers
(centroid + the smallest eigenvector of the 3×3 scatter), its normal is
turned toward the camera, and the pose takes +z to that normal with the
origin at the centroid.
"""

from __future__ import annotations

import dataclasses

import torch

from alvaar_tpu_torch.geom.lie import SE3, so3_exp
from alvaar_tpu_torch.solvers.ransac import masked_quantile, sample_minimal


@dataclasses.dataclass
class PlaneResult:
    pose: SE3                  # plane-to-world: +z to the normal, t = centroid
    normal: torch.Tensor       # [3]
    success: torch.Tensor


def _rotation_from_up_to(n):
    """Unit quaternion taking +z to the unit normal n (Rodrigues of up × n)."""
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    axis = torch.linalg.cross(up, n, dim=-1)
    s = torch.linalg.norm(axis)
    angle = torch.atan2(s, torch.dot(up, n))
    axis = axis / torch.where(s < 1e-9, 1.0, s)
    return so3_exp(torch.where(s < 1e-9, torch.zeros_like(axis), axis * angle))


def find_plane_ransac(gen, points_w, valid, cam_center_w, *, iters: int = 250,
                      min_points: int = 32, max_tilt_deg: float = 5.0,
                      inlier_scale: float = 1.4, samples=None) -> PlaneResult:
    """Dominant horizontal plane among world points [N, 3] (``valid`` [N])
    seen from the camera centre ``cam_center_w`` [3].  ``samples`` =
    (idx [iters, 3], ok [iters]) replaces the generator's draw."""
    n_pts = torch.sum(valid)
    idx, samp_ok = samples if samples is not None else sample_minimal(
        gen, valid, 3, iters)
    p = points_w[idx]                                     # [H, 3, 3]
    normal = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    degenerate = nn[:, 0] < 1e-9
    normal = normal / torch.where(nn < 1e-9, 1.0, nn)
    normal = normal * torch.sign(normal[:, 2:3] + 1e-12)  # +z for the tilt gate
    cos_max = torch.cos(torch.deg2rad(torch.tensor(max_tilt_deg, dtype=normal.dtype)))
    horizontal = normal[:, 2] >= cos_max.to(normal.device)

    d = -torch.sum(normal * p[:, 0], dim=-1)
    dist = torch.abs(points_w @ normal.T + d[None, :]).T  # [H, N]
    score = masked_quantile(dist, valid[None], 0.2)
    cand_ok = samp_ok & horizontal & ~degenerate
    score = torch.where(cand_ok, score, torch.inf)
    best = torch.argmin(score)

    inliers = (dist[best] < inlier_scale * score[best]) & valid
    num_inl = torch.sum(inliers)

    w = inliers.to(points_w.dtype)[:, None]
    centroid = torch.sum(points_w * w, dim=0) / torch.sum(w).clamp_min(1.0)
    centered = (points_w - centroid) * w
    _, eigvecs = torch.linalg.eigh(centered.T @ centered)
    n_refit = eigvecs[:, 0]                               # smallest eigenvalue
    n_refit = n_refit * torch.sign(torch.dot(n_refit, cam_center_w - centroid) + 1e-12)

    success = (n_pts >= min_points) & (num_inl >= min_points) & cand_ok[best]
    return PlaneResult(SE3(_rotation_from_up_to(n_refit), centroid), n_refit, success)
