"""Motion-only PnP: masked Levenberg-Marquardt pose refinement.

Port of alvaar_tpu/solvers/pnp.py: Huber IRLS over all valid points with
a fixed LM iteration budget and branch-free accept/reject, then a
chi²/negative-depth prune and an L2 re-solve on the inliers.  The 6x6
normal equations are solved by the same unrolled Cholesky.
"""

from __future__ import annotations

import dataclasses

import torch

from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3, so3_hat

CHI2_THRESH_2DOF = 5.9915


@dataclasses.dataclass
class PnPResult:
    pose: SE3                  # refined T_c_w
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor
    cost: torch.Tensor


def _residuals_jacobian(pose_cw: SE3, cam: Camera, points_w, px_obs):
    """Per-point residual [N, 2], Jacobian [N, 2, 6], depth [N]."""
    Xc = pose_cw.apply(points_w)
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    r = torch.stack([u, v], dim=-1) - px_obs
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * Xc[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * Xc[..., 1] * inv_z * inv_z], -1),
    ], dim=-2)                                                   # [N, 2, 3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    J_gen = torch.cat([eye, -so3_hat(Xc)], dim=-1)              # [N, 3, 6]
    return r, J_proj @ J_gen, z


def _robust_weights(r2, huber_delta):
    if huber_delta <= 0:
        return torch.ones_like(r2)
    rn = torch.sqrt(r2.clamp_min(1e-12))
    return torch.where(rn <= huber_delta, 1.0, huber_delta / rn)


def _chol_solve6(H, g):
    """x = H⁻¹ g for SPD [..., 6, 6] H via a fully unrolled Cholesky."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _lm_solve(pose0: SE3, cam: Camera, points_w, px_obs, weights_fixed, *,
              iters: int, huber_delta: float):
    """Fixed-length branch-free LM with deferred accept/reject: each
    iteration linearizes once at the trial point, and the carried
    best-point normal equations are reused when the trial is rejected."""
    eye6 = torch.eye(6, dtype=points_w.dtype, device=points_w.device)

    def linearize(pose):
        r, J, _ = _residuals_jacobian(pose, cam, points_w, px_obs)
        r2 = torch.sum(r * r, dim=-1)
        w = _robust_weights(r2, huber_delta) * weights_fixed
        H = torch.einsum("n,nki,nkj->ij", w, J, J)
        g = torch.einsum("n,nki,nk->i", w, J, r)
        if huber_delta > 0:
            rn = torch.sqrt(r2.clamp_min(1e-12))
            rho = torch.where(rn <= huber_delta, r2,
                              2 * huber_delta * rn - huber_delta ** 2)
        else:
            rho = r2
        return H, g, torch.sum(rho * weights_fixed)

    def damped(H, lam):
        # the clip applies to the whole diag matrix, off-diagonals included,
        # as in the JAX package
        return H + lam * torch.diag(torch.diagonal(H)).clamp_min(1e-8) + 1e-9 * eye6

    H_b, g_b, cost_best = linearize(pose0)
    lam = torch.tensor(1e-3, dtype=points_w.dtype, device=points_w.device)
    pose_best = pose0
    pose_trial = pose0.retract(-_chol_solve6(damped(H_b, lam), g_b))
    for _ in range(iters):
        H_t, g_t, cost_t = linearize(pose_trial)
        accept = cost_t < cost_best
        pose_best = SE3.where(accept, pose_trial, pose_best)
        H_b = torch.where(accept, H_t, H_b)
        g_b = torch.where(accept, g_t, g_b)
        cost_best = torch.where(accept, cost_t, cost_best)
        lam = torch.where(accept, lam * 0.33, lam * 10.0).clamp(1e-8, 1e6)
        pose_trial = pose_best.retract(-_chol_solve6(damped(H_b, lam), g_b))
    return pose_best, cost_best


def pnp_refine(pose0: SE3, cam: Camera, points_w, px_obs, valid, *,
               iters: int = 5, huber_delta: float = CHI2_THRESH_2DOF ** 0.5,
               chi2_thresh: float = CHI2_THRESH_2DOF,
               refine_l2: bool = True) -> PnPResult:
    """Huber LM over the valid points, chi²/depth prune, L2 re-solve on
    the inliers (points_w [N, 3], px_obs [N, 2] undistorted, valid [N])."""
    wfix = valid.to(points_w.dtype)
    pose1, _ = _lm_solve(pose0, cam, points_w, px_obs, wfix,
                         iters=iters, huber_delta=huber_delta)
    r, _, z = _residuals_jacobian(pose1, cam, points_w, px_obs)
    chi2 = torch.sum(r * r, dim=-1)
    inl = valid & (chi2 <= chi2_thresh) & (z > 0)
    if refine_l2:
        pose2, cost = _lm_solve(pose1, cam, points_w, px_obs,
                                inl.to(points_w.dtype),
                                iters=max(1, iters - 2), huber_delta=0.0)
    else:
        pose2, cost = pose1, torch.sum(chi2 * inl)
    r, _, z = _residuals_jacobian(pose2, cam, points_w, px_obs)
    chi2 = torch.sum(r * r, dim=-1)
    inliers = valid & (chi2 <= chi2_thresh) & (z > 0)
    return PnPResult(pose=pose2.normalize(), inliers=inliers,
                     num_inliers=torch.sum(inliers), cost=cost)
