"""Motion-only PnP problems for the port's tests, the CPU rehearsal of K9
and chip_smoke.py phase 2c, built with numpy and the port's own geometry
(no JAX).

``build_problem`` draws a camera pose, N points in front of it whose
projections land inside the 640x480 image, noisy observations, a fraction
of outliers (observations replaced by uniform pixels), points behind the
camera (their observations those of their mirror image in front), masked
slots, and a start pose ``pose0`` perturbed from the truth.  ``stack``
puts several problems into the [S, ...] rows K9 takes."""

from __future__ import annotations

import numpy as np
import torch

from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3

CAM = Camera.create(500.0, 500.0, 320.0, 240.0)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def build_problem(rng, N=192, px_noise=0.5, outlier_frac=0.0, behind=0, masked_frac=0.1,
                  pose_noise=0.03, device="cpu"):
    """(pose0, points_w [N, 3], px_obs [N, 2], valid [N] bool) on ``device``
    and the camera."""
    pose = SE3.exp(_f32(np.concatenate([rng.normal(size=3), rng.normal(size=3) * 0.3])))
    uv = np.stack([rng.uniform(20, 620, N), rng.uniform(20, 460, N)], axis=1)
    depth = rng.uniform(2.0, 10.0, N)
    Xc = np.stack([(uv[:, 0] - CAM.cx) / CAM.fx * depth, (uv[:, 1] - CAM.cy) / CAM.fy * depth,
                   depth], axis=1)
    obs = uv + rng.normal(size=uv.shape) * px_noise
    if outlier_frac > 0:
        idx = rng.choice(N, size=int(N * outlier_frac), replace=False)
        obs[idx] = rng.uniform([0, 0], [640, 480], size=(len(idx), 2))
    if behind:
        Xc[rng.choice(N, size=behind, replace=False)] *= -1.0
    points_w = pose.inverse().apply(_f32(Xc))
    valid = rng.random(N) >= masked_frac
    pose0 = SE3.exp(_f32(rng.normal(size=6) * pose_noise)).compose(pose)
    on = lambda x: x.to(device)
    return (SE3(on(pose0.q), on(pose0.t)), on(points_w), on(_f32(obs)),
            on(torch.as_tensor(valid))), CAM


def stack(problems):
    """Problems of one N as K9's rows: (q [S, 4], t [S, 3], points_w [S, N,
    3], px_obs [S, N, 2], valid [S, N]), contiguous."""
    cols = list(zip(*[(p[0].q, p[0].t, p[1], p[2], p[3]) for p in problems]))
    return tuple(torch.stack(c).contiguous() for c in cols)


def to_f64(problem):
    """The problem's floating tensors in float64 (the plain version's
    float64 evaluation)."""
    pose0, pts, obs, valid = problem
    return SE3(pose0.q.double(), pose0.t.double()), pts.double(), obs.double(), valid
