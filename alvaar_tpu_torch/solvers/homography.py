"""Planar homography: batched 4-point DLT, RANSAC and the Faugeras
decomposition (port of alvaar_tpu/solvers/homography.py).

The bootstrap scores this model against the essential one when a scene
is dominated by one plane.  Every decomposition case is computed and
gated by how well it rebuilds ``H̃ = R + t nᵀ``, so there is no
per-candidate control flow.  Plane points satisfy nᵀX₀ = d in camera 0
and ``H ∝ R + (t/d) nᵀ`` with X₁ = R X₀ + t.
"""

from __future__ import annotations

import torch

from alvaar_tpu_torch.geom.lie import SE3, matrix_to_quat
from alvaar_tpu_torch.solvers.essential import (
    RelativePoseResult,
    _score_candidates,
    essential_thresh,
)
from alvaar_tpu_torch.solvers.ransac import minimal_samples
from alvaar_tpu_torch.utils.stats import count


def _to_norm(f):
    """Unit bearings [..., 3] → normalized image coordinates [..., 2]."""
    z = torch.where(torch.abs(f[..., 2]) < 1e-9, 1e-9, f[..., 2])
    return f[..., :2] / z[..., None]


def homography_from_4pt(x0, x1, weights=None):
    """DLT homography from ≥ 4 pairs x0, x1 [..., M, 2] with x1 ~ H x0.
    ``weights`` [..., M] scale the rows (masked least squares).  Returns H
    [..., 3, 3] with unit Frobenius norm."""
    z = torch.zeros_like(x0[..., 0])
    o = torch.ones_like(z)
    r1 = torch.stack([x0[..., 0], x0[..., 1], o, z, z, z,
                      -x1[..., 0] * x0[..., 0], -x1[..., 0] * x0[..., 1],
                      -x1[..., 0]], dim=-1)
    r2 = torch.stack([z, z, z, x0[..., 0], x0[..., 1], o,
                      -x1[..., 1] * x0[..., 0], -x1[..., 1] * x0[..., 1],
                      -x1[..., 1]], dim=-1)
    if weights is not None:
        r1 = r1 * weights[..., None]
        r2 = r2 * weights[..., None]
    A = torch.cat([r1, r2], dim=-2)                       # [..., 2M, 9]
    h = torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]
    H = h.unflatten(-1, (3, 3))
    return H / torch.linalg.norm(H, dim=(-2, -1), keepdim=True).clamp_min(1e-12)


def _transfer_err(H, x0, x1):
    """One-way transfer error |proj(H x0) − x1| in normalized coordinates."""
    X = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    y = torch.sum(H[..., None, :, :] * X[..., :, None, :], dim=-1)   # [..., N, 3]
    z = torch.where(torch.abs(y[..., 2]) < 1e-9, 1e-9, y[..., 2])
    return torch.linalg.norm(y[..., :2] / z[..., None] - x1, dim=-1)


def _rot_xz(r00, r02, r11, r20, r22):
    """[..., 3, 3] matrices [[r00, 0, r02], [0, r11, 0], [r20, 0, r22]]."""
    z = torch.zeros_like(r00)
    return torch.stack([r00, z, r02, z, r11 + z, z, r20, z, r22],
                       dim=-1).unflatten(-1, (3, 3))


def decompose_homography(H):
    """Faugeras SVD decomposition of a calibrated homography H [..., 3, 3]
    → (R [..., 8, 3, 3], t [..., 8, 3], n [..., 8, 3], ok [..., 8]): all
    eight (rotation, translation/d, normal) cases, ``ok`` where the case
    rebuilds ±H/d₂ to 1e-3, normals oriented toward camera 0."""
    U, D, Vt = torch.linalg.svd(H)
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2]
    d2s = torch.where(d2 < 1e-12, 1e-12, d2)

    denom = d1 ** 2 - d3 ** 2
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    x1v = torch.sqrt(torch.clamp_min((d1 ** 2 - d2 ** 2) / denom, 0.0))
    x3v = torch.sqrt(torch.clamp_min((d2 ** 2 - d3 ** 2) / denom, 0.0))

    Rs, ts, ns = [], [], []
    for proper in (True, False):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                a, b = e1 * x1v, e3 * x3v
                zero = torch.zeros_like(a)
                if proper:      # d' = +d2
                    s_t = (d1 - d3) * a * b / d2s
                    c_t = (d1 * b ** 2 + d3 * a ** 2) / d2s
                    Rs.append(_rot_xz(c_t, -s_t, 1.0, s_t, c_t))
                    ts.append(torch.stack([(d1 - d3) * a, zero, -(d1 - d3) * b], -1) / d2s)
                else:           # d' = −d2: a reflection before the fix-up
                    s_p = (d1 + d3) * a * b / d2s
                    c_p = (d3 * a ** 2 - d1 * b ** 2) / d2s
                    Rs.append(_rot_xz(c_p, s_p, -1.0, s_p, -c_p))
                    ts.append(torch.stack([(d1 + d3) * a, zero, (d1 + d3) * b], -1) / d2s)
                ns.append(torch.stack([a, zero, b], -1))
    Rc = torch.stack(Rs, dim=-3)                          # [..., 8, 3, 3]
    tc = torch.stack(ts, dim=-2)                          # [..., 8, 3]
    nc = torch.stack(ns, dim=-2)

    # back out of the SVD frame; the sign fixes an improper U/V
    s = detUV[..., None, None, None]
    R = s * (U[..., None, :, :] @ Rc @ Vt[..., None, :, :])
    t = torch.sum(U[..., None, :, :] * tc[..., :, None, :], dim=-1) * detUV[..., None, None]
    n = torch.sum(Vt.transpose(-1, -2)[..., None, :, :] * nc[..., :, None, :], dim=-1)

    Ht = H[..., None, :, :] / d2s[..., None, None, None]
    recon = R + t[..., :, None] * n[..., None, :]
    err_p = torch.linalg.norm(recon - Ht, dim=(-2, -1))
    err_m = torch.linalg.norm(recon + Ht, dim=(-2, -1))
    ok = torch.minimum(err_p, err_m) < 1e-3

    flip = n[..., 2] < 0
    return (R, torch.where(flip[..., None], -t, t),
            torch.where(flip[..., None], -n, n), ok)


def homography_ransac(gen, f0, f1, valid, *, focal, iters: int = 100,
                      err_px: float = 3.0, min_inliers: int = 10,
                      samples=None):
    """RANSAC planar relative pose from bearings f0 (older frame) and f1
    (current), both [N, 3].  Returns (RelativePoseResult with T_c0_c1,
    the best homography's inlier count).  ``samples`` = (idx [iters, 4],
    ok [iters]), or a uniform draw [iters, N], replaces the generator's
    draw.
    ``homography_ransac.calls`` counts the calls."""
    count(homography_ransac, "calls")
    x0, x1 = _to_norm(f0), _to_norm(f1)
    idx, samp_ok = minimal_samples(gen, valid, 4, iters, samples)
    H = homography_from_4pt(x0[idx], x1[idx])             # [Hyp, 3, 3]

    # symmetric transfer error, pixels
    Hi = torch.linalg.inv(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))
    err = (_transfer_err(H, x0[None], x1[None])
           + _transfer_err(Hi, x1[None], x0[None])) * focal * 0.5
    h_inl = (err < err_px) & valid[None]
    h_counts = torch.where(samp_ok, torch.sum(h_inl, dim=-1), -1)
    best_h = torch.argmax(h_counts)

    # refit on the best inlier set (row-weighted least squares)
    H_best = homography_from_4pt(x0, x1, weights=h_inl[best_h].to(x0.dtype))
    R8, t8, _, ok8 = decompose_homography(H_best)          # [8, ...]
    tn = torch.linalg.norm(t8, dim=-1)
    t8u = t8 / torch.where(tn < 1e-9, 1.0, tn)[..., None]
    pose_01 = SE3(matrix_to_quat(R8), t8u).inverse()

    thresh = essential_thresh(err_px, focal, f0)
    err_c, posdepth = _score_candidates(pose_01, f0, f1)
    inl = (err_c < thresh) & posdepth & valid[None]
    counts = torch.where(ok8 & (tn > 1e-6), torch.sum(inl, dim=-1), -1)
    b = torch.argmax(counts)
    num = torch.sum(inl[b])
    success = (num >= min_inliers) & (counts[b] > 0)
    return RelativePoseResult(pose_01[b], inl[b], num, success), h_counts[best_h]


homography_ransac.calls = 0
