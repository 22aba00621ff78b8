"""Midpoint two-view triangulation — batched (port of
alvaar_tpu/geom/triangulation.py)."""

from __future__ import annotations

import torch

from alvaar_tpu_torch.geom.lie import SE3


def triangulate_midpoint(rel_pose_01: SE3, f0, f1):
    """Point [..., 3] in cam0 midway between the closest points of the ray
    f0 (cam0) and the ray f1 (cam1), given T_c0_c1."""
    t = torch.broadcast_to(rel_pose_01.t,
                           torch.broadcast_shapes(rel_pose_01.t.shape, f0.shape))
    f1_w = rel_pose_01.rotate(f1)
    b0 = torch.sum(f0 * t, dim=-1)
    b1 = torch.sum(f1_w * t, dim=-1)
    a00 = torch.sum(f0 * f0, dim=-1)
    a01 = -torch.sum(f0 * f1_w, dim=-1)
    a11 = torch.sum(f1_w * f1_w, dim=-1)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    l0 = (a11 * b0 - a01 * (-b1)) / det
    l1 = (a00 * (-b1) - a01 * b0) / det
    p0 = f0 * l0[..., None]
    p1 = t + f1_w * l1[..., None]
    return 0.5 * (p0 + p1)


def triangulation_depths(rel_pose_01: SE3, f0, f1):
    """(point_cam0, depth0, depth1)."""
    x0 = triangulate_midpoint(rel_pose_01, f0, f1)
    x1 = rel_pose_01.inverse().apply(x0)
    return x0, x0[..., 2], x1[..., 2]
