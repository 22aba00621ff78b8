"""Two-view relative pose: batched 8-point essential matrix + RANSAC.

Port of alvaar_tpu/solvers/essential.py.  All hypotheses are solved as
one batched SVD, decomposed into four (R, t) candidates each, and scored
by triangulation, cheirality and the two-view angular error; the winner
gets a least-squares refit on its inlier set.  The 5-point solver
(solvers/fivept.py) and the homography (solvers/homography.py) share the
scoring and the result type.
"""

from __future__ import annotations

import dataclasses

import torch

from alvaar_tpu_torch.geom.lie import SE3, matrix_to_quat
from alvaar_tpu_torch.geom.triangulation import triangulate_midpoint
from alvaar_tpu_torch.solvers.ransac import minimal_samples


@dataclasses.dataclass
class RelativePoseResult:
    pose: SE3                  # T_c0_c1 with |t| = 1
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor
    success: torch.Tensor

    @staticmethod
    def where(cond, a: "RelativePoseResult", b: "RelativePoseResult"
              ) -> "RelativePoseResult":
        """Select ``a`` where the 0-d ``cond`` holds, else ``b`` (no host
        sync)."""
        return RelativePoseResult(SE3.where(cond, a.pose, b.pose),
                                  torch.where(cond, a.inliers, b.inliers),
                                  torch.where(cond, a.num_inliers, b.num_inliers),
                                  torch.where(cond, a.success, b.success))


def essential_thresh(err_px: float, focal, like):
    """Angular inlier threshold of the two-view error: twice 1 − cos of
    the angle that ``err_px`` subtends at ``focal``."""
    tan = torch.tensor(err_px, dtype=like.dtype, device=like.device) / focal
    return 2.0 * (1.0 - torch.cos(torch.atan(tan)))


def essential_from_8pt(f0, f1):
    """Least-squares E [..., 3, 3] from ≥ 8 bearing pairs [..., M, 3]
    (f1ᵀ E f0 = 0), projected onto the essential manifold."""
    A = (f1[..., :, :, None] * f0[..., :, None, :]).reshape(
        f0.shape[:-2] + (f0.shape[-2], 9))
    Vt = torch.linalg.svd(A, full_matrices=True).Vh
    E = Vt[..., -1, :].reshape(f0.shape[:-2] + (3, 3))
    U, _, Vt2 = torch.linalg.svd(E)
    S = torch.zeros_like(E)
    S[..., 0, 0] = 1.0
    S[..., 1, 1] = 1.0
    return U @ S @ Vt2


def decompose_essential(E):
    """E [..., 3, 3] → four (R_10, t_10) candidates with X_c1 = R X_c0 + t:
    R [..., 4, 3, 3], t [..., 4, 3] (unit translation)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _score_candidates(pose_01: SE3, f0, f1):
    """Angular two-view error [C, N] and positive-depth mask [C, N] for
    candidates with leading dim [C]; f0/f1 are [N, 3]."""
    rel = SE3(pose_01.q[:, None, :], pose_01.t[:, None, :])
    X0 = triangulate_midpoint(rel, f0[None], f1[None])
    X1 = rel.inverse().apply(X0)
    n0 = X0 / torch.linalg.norm(X0, dim=-1, keepdim=True).clamp_min(1e-12)
    n1 = X1 / torch.linalg.norm(X1, dim=-1, keepdim=True).clamp_min(1e-12)
    err = (1.0 - torch.sum(n0 * f0[None], dim=-1)) + (1.0 - torch.sum(n1 * f1[None], dim=-1))
    return err, (X0[..., 2] > 0) & (X1[..., 2] > 0)


def refine_relative_pose(pose_01: SE3, inliers, f0, f1, thresh, valid):
    """LSQ E refit on the inlier set, kept only if it scores at least as
    many inliers AND the system has a unique null direction (the planar
    degeneracy guard).  Returns (pose_01, inliers, count)."""
    w = inliers.to(f0.dtype)
    fw0, fw1 = f0 * w[:, None], f1 * w[:, None]
    A = (fw1[:, :, None] * fw0[:, None, :]).reshape(-1, 9)
    svals = torch.linalg.svdvals(A)
    well_posed = svals[7] > 1e-4 * svals[0].clamp_min(1e-12)
    R4, t4 = decompose_essential(essential_from_8pt(fw0, fw1))
    cand_01 = SE3(matrix_to_quat(R4), t4).inverse()
    err, posdepth = _score_candidates(cand_01, f0, f1)
    inl = (err < thresh) & posdepth & valid[None]
    counts = torch.sum(inl, dim=-1)
    b = torch.argmax(counts)

    err0, pos0 = _score_candidates(pose_01.unsqueeze(0), f0, f1)
    inl0 = (err0 < thresh) & pos0 & valid[None]
    n0 = torch.sum(inl0[0])

    better = (counts[b] >= n0) & well_posed
    pose = SE3.where(better, cand_01[b], pose_01)
    return (pose, torch.where(better, inl[b], inl0[0]),
            torch.where(better, counts[b], n0))


def essential_ransac(gen, f0, f1, valid, *, focal, iters: int = 100,
                     err_px: float = 3.0, min_inliers: int = 10,
                     samples=None) -> RelativePoseResult:
    """RANSAC relative pose from bearings f0 (older frame) and f1 (current),
    both [N, 3].  ``samples`` = (idx [iters, 8], ok [iters]), or a uniform
    draw [iters, N], replaces the generator's draw (the parity tests
    inject the JAX package's draw)."""
    idx, samp_ok = minimal_samples(gen, valid, 8, iters, samples)
    R4, t4 = decompose_essential(essential_from_8pt(f0[idx], f1[idx]))
    C = iters * 4
    pose_01 = SE3(matrix_to_quat(R4.reshape(C, 3, 3)), t4.reshape(C, 3)).inverse()

    thresh = essential_thresh(err_px, focal, f0)
    err, posdepth = _score_candidates(pose_01, f0, f1)
    inl = (err < thresh) & posdepth & valid[None]
    counts = torch.where(samp_ok.repeat_interleave(4), torch.sum(inl, dim=-1), -1)
    best = torch.argmax(counts)

    best_pose, inliers, num = refine_relative_pose(
        pose_01[best], inl[best], f0, f1, thresh, valid)
    return RelativePoseResult(best_pose, inliers, num, num >= min_inliers)
