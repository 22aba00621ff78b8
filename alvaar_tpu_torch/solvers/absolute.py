"""Absolute pose: batched P3P + LMedS (port of
alvaar_tpu/solvers/absolute.py).  H minimal samples → 4H Grunert
candidates → [4H, N] angular scoring → masked-median selection."""

from __future__ import annotations

import dataclasses

import torch

from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.solvers.p3p import p3p_grunert
from alvaar_tpu_torch.solvers.ransac import (
    masked_quantile,
    minimal_samples,
    select_best_by_median,
)


@dataclasses.dataclass
class AbsolutePoseResult:
    pose: SE3                  # T_c_w
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor
    success: torch.Tensor


def angular_error(pose_cw: SE3, bearings, points_w):
    """1 − cos between bearings and predicted point directions, [..., N]."""
    Xc = pose_cw.apply(points_w)
    Xn = Xc / torch.linalg.norm(Xc, dim=-1, keepdim=True).clamp_min(1e-12)
    return 1.0 - torch.sum(Xn * bearings, dim=-1)


def p3p_lmeds(gen, bearings, points_w, valid, *, focal, iters: int = 100,
              err_px: float = 3.0, min_inliers: int = 5,
              samples=None) -> AbsolutePoseResult:
    """LMedS over P3P.  ``samples`` = (idx [iters, 3], ok [iters]), or a
    uniform draw [iters, N], replaces the generator's draw."""
    idx, samp_ok = minimal_samples(gen, valid, 3, iters, samples)
    pose_c, cand_ok = p3p_grunert(bearings[idx], points_w[idx])   # [H, 4]
    cand_ok = (cand_ok & samp_ok[:, None]).reshape(-1)
    C = iters * 4
    pose_flat = SE3(pose_c.q.reshape(C, 4), pose_c.t.reshape(C, 3))

    errs = angular_error(pose_flat.unsqueeze(1), bearings[None], points_w[None])
    med = masked_quantile(errs, valid[None], 0.5)
    best, _ = select_best_by_median(med, cand_ok)

    tan = torch.tensor(err_px, dtype=bearings.dtype, device=bearings.device) / focal
    thresh = 1.0 - torch.cos(torch.atan(tan))
    inliers = (errs[best] < thresh) & valid
    num = torch.sum(inliers)
    return AbsolutePoseResult(pose_flat[best], inliers, num,
                              (num >= min_inliers) & cand_ok[best])
