"""Local-BA problems for the port's tests and chip_smoke.py, built with
numpy and the port's own geometry (no JAX).

``build_problem`` is tests/test_ba.py's synthetic forward-moving window
(the same draws from ``rng`` in the same order, any W, L and K);
``bench_problem`` is the JAX bench's random problem (bench.py:516-537);
``clamp_problem`` puts slots at local BA's inverse-depth and depth clamps.
Each returns a ``BAProblem`` on ``device`` and the camera."""

from __future__ import annotations

import numpy as np
import torch

from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3, so3_exp
from alvaar_tpu_torch.solvers.ba import BAProblem

CAM = Camera.create(500.0, 500.0, 320.0, 240.0)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _on(prob: BAProblem, device) -> BAProblem:
    return BAProblem(**{k: (SE3(v.q.to(device), v.t.to(device)) if isinstance(v, SE3)
                            else v.to(device)) for k, v in vars(prob).items()})


def build_problem(rng, W=8, L=128, K=96, pose_noise=0.02, depth_noise=0.05, px_noise=0.3,
                  outlier_frac=0.0, device="cpu"):
    """tests/test_ba.py ``build_problem`` (there W, L, K = 8, 128, 96):
    every keyframe of a forward-moving ring observes the first K of L
    points, anchors in the first half of the window, the first two poses
    constant, the others and all depths perturbed."""
    qs, ts = [], []
    for k in range(W):
        phi = np.array([0.01, 0.02, 0.005]) * k
        c = np.array([0.15 * k, 0.01 * k, 0.0])
        q = so3_exp(_f32(phi))
        qs.append(q)
        ts.append(-SE3(q, torch.zeros(3)).rotate(_f32(c)))
    gt = SE3(torch.stack(qs), torch.stack(ts))
    pts_w = _f32(np.stack([rng.uniform(-3, 4, L), rng.uniform(-2, 2, L),
                           rng.uniform(4, 9, L)], axis=1))
    anchor_kf = torch.as_tensor(rng.integers(0, W // 2, size=L), dtype=torch.int64)
    X_a = gt[anchor_kf].apply(pts_w)
    gt_invd = 1.0 / X_a[:, 2]
    anchor_mxy = X_a[:, :2] / X_a[:, 2:3]
    obs_lm = torch.arange(K)[None].expand(W, K).contiguous()
    Xc = SE3(gt.q[:, None], gt.t[:, None]).apply(pts_w[None, :K])          # [W, K, 3]
    z = Xc[..., 2:3]
    xn = Xc[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    px = torch.stack([CAM.fx * xn[..., 0] + CAM.cx, CAM.fy * xn[..., 1] + CAM.cy], -1)
    px = px + _f32(rng.normal(size=px.shape) * px_noise)
    obs_valid = Xc[..., 2] > 0.1
    if outlier_frac > 0:
        m = torch.as_tensor(rng.random((W, K)) < outlier_frac)
        off = _f32(rng.uniform(20, 80, px.shape) * rng.choice([-1, 1], px.shape))
        px = torch.where(m[..., None], px + off, px)
    constant = torch.arange(W) < 2
    noise = _f32(rng.normal(size=(W, 6)) * pose_noise)
    noise = torch.where(constant[:, None], 0.0, noise)
    poses = SE3.exp(noise).compose(gt)
    invd = gt_invd * _f32(1.0 + rng.normal(size=L) * depth_noise)
    prob = BAProblem(poses=poses, kf_valid=torch.ones(W, dtype=torch.bool), constant=constant,
                     anchor_kf=anchor_kf, anchor_mxy=anchor_mxy, invdepth=invd,
                     lm_valid=torch.ones(L, dtype=torch.bool), obs_lm=obs_lm, obs_px=px,
                     obs_valid=obs_valid)
    return _on(prob, device), CAM


def bench_problem(rng, W=30, K=192, L=10240, device="cpu"):
    """The JAX bench's local-BA problem (bench.py:516-537, seed 0 there):
    random unit quaternions and translations, K landmarks of an L pool
    observed in every row, 60% of the observations valid, the first two
    poses constant.  Returns the problem and the 640x480 camera of
    ``Camera.from_fov(640, 480, 60)``."""
    q = rng.normal(0, 1, (W, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    obs_lm = np.tile(rng.integers(0, L, (1, K)), (W, 1))
    prob = BAProblem(
        poses=SE3(_f32(q), _f32(rng.normal(0, 0.5, (W, 3)))),
        kf_valid=torch.ones(W, dtype=torch.bool), constant=torch.arange(W) < 2,
        anchor_kf=torch.as_tensor(rng.integers(0, W, L), dtype=torch.int64),
        anchor_mxy=_f32(rng.normal(0, 0.3, (L, 2))),
        invdepth=_f32(1 / rng.uniform(2, 8, L)),
        lm_valid=torch.ones(L, dtype=torch.bool),
        obs_lm=torch.as_tensor(obs_lm, dtype=torch.int64),
        obs_px=_f32(rng.uniform(20, 460, (W, K, 2))),
        obs_valid=torch.as_tensor(rng.random((W, K)) < 0.6))
    return _on(prob, device), Camera.from_fov(640, 480, 60.0)


def clamp_problem(rng, W=8, L=128, K=96, device="cpu"):
    """``build_problem`` with slots at local BA's clamps: landmarks 1-4 at
    inverse depths inside +-1e-6 (``lam_safe``), and landmark 0 in
    keyframe 5's image plane (``z_safe``): anchored at keyframe 2, moved to
    the identity, at X_a = (1, 0, 1), seen by keyframe 5 turned 45 degrees
    about y at the origin, where z = cos 45 - sin 45 is float32 round-off
    (well inside 1e-6 whatever the order of the products)."""
    prob, cam = build_problem(rng, W=W, L=L, K=K)
    prob.invdepth[1:5] = torch.tensor([5e-7, -5e-7, 0.0, 9e-7])
    h = np.pi / 8
    prob.poses.q[2] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    prob.poses.q[5] = _f32([np.cos(h), 0.0, np.sin(h), 0.0])
    prob.poses.t[2] = 0.0
    prob.poses.t[5] = 0.0
    prob.anchor_kf[0] = 2
    prob.anchor_mxy[0] = torch.tensor([1.0, 0.0])
    prob.invdepth[0] = 1.0
    prob.obs_valid[5, 0] = True
    return _on(prob, device), cam
