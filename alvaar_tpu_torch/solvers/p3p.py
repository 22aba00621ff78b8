"""Batched P3P: Grunert's distance-based solution (port of
alvaar_tpu/solvers/p3p.py).  Each real root of the quartic gives ray
depths, camera-frame points and a Kabsch alignment to the world points."""

from __future__ import annotations

import torch

from alvaar_tpu_torch.geom.lie import SE3, matrix_to_quat
from alvaar_tpu_torch.solvers.quartic import solve_quartic_real

_EPS = 1e-10


def _kabsch(P, X):
    """Rigid alignment X ≈ R @ P + t over the second-to-last axis.
    P, X: [..., N, 3].  Returns (R [..., 3, 3], t [..., 3])."""
    Pc = P.mean(dim=-2, keepdim=True)
    Xc = X.mean(dim=-2, keepdim=True)
    C = torch.einsum("...ni,...nj->...ij", X - Xc, P - Pc)
    U, _, Vt = torch.linalg.svd(C)
    D = torch.zeros_like(C)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = torch.linalg.det(U @ Vt)
    R = U @ D @ Vt
    t = Xc[..., 0, :] - (R @ Pc[..., 0, :, None])[..., 0]
    return R, t


def p3p_grunert(f, P):
    """f: [..., 3, 3] unit bearings (rows f1, f2, f3); P: [..., 3, 3] world
    points.  Returns up to 4 T_c_w candidates (SE3 with batch [..., 4]) and
    their validity [..., 4]."""
    P1, P2, P3 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]

    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)
    ca2, cb2, cg2 = ca * ca, cb * cb, cg * cg

    A4 = (a2 ** 2 - 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2
          - 4 * b2 * c2 * ca2 + 2 * b2 * c2 + c2 ** 2)
    A3 = -4.0 * (a2 ** 2 * cb - a2 * b2 * ca * cg - a2 * b2 * cb
                 - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
                 - 2 * b2 * c2 * ca2 * cb - b2 * c2 * ca * cg
                 + b2 * c2 * cb + c2 ** 2 * cb)
    A2 = 2.0 * (2 * a2 ** 2 * cb2 + a2 ** 2 - 4 * a2 * b2 * ca * cb * cg
                - 2 * a2 * b2 * cg2 - 4 * a2 * c2 * cb2 - 2 * a2 * c2
                + 2 * b2 ** 2 * ca2 + 2 * b2 ** 2 * cg2 - b2 ** 2
                - 2 * b2 * c2 * ca2 - 4 * b2 * c2 * ca * cb * cg
                + 2 * c2 ** 2 * cb2 + c2 ** 2)
    A1 = -4.0 * (a2 ** 2 * cb - a2 * b2 * ca * cg - 2 * a2 * b2 * cb * cg2
                 + a2 * b2 * cb - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
                 - b2 * c2 * ca * cg - b2 * c2 * cb + c2 ** 2 * cb)
    A0 = (a2 ** 2 - 4 * a2 * b2 * cg2 + 2 * a2 * b2 - 2 * a2 * c2
          + b2 ** 2 - 2 * b2 * c2 + c2 ** 2)

    v, v_ok = solve_quartic_real(A4, A3, A2, A1, A0)            # [..., 4]

    a2e, b2e, c2e = a2[..., None], b2[..., None], c2[..., None]
    cae, cbe, cge = ca[..., None], cb[..., None], cg[..., None]
    lin_a = 2.0 * b2e * (cae * v - cge)
    lin_b = (-2.0 * a2e * cbe * v + a2e * v ** 2 + a2e - b2e * v ** 2 + b2e
             + 2.0 * c2e * cbe * v - c2e * v ** 2 - c2e)
    lin_ok = torch.abs(lin_a) > _EPS
    u = -lin_b / torch.where(lin_ok, lin_a, 1.0)

    den = 1.0 + v ** 2 - 2.0 * v * cbe
    den_ok = den > _EPS
    s1 = torch.sqrt(b2e / torch.where(den_ok, den, 1.0))
    s2 = u * s1
    s3 = v * s1
    depth_ok = (s1 > 0) & (s2 > 0) & (s3 > 0)

    Xc = torch.stack([s1[..., None] * f1[..., None, :],
                      s2[..., None] * f2[..., None, :],
                      s3[..., None] * f3[..., None, :]], dim=-2)  # [..., 4, 3, 3]
    Pw = P[..., None, :, :].expand(Xc.shape)
    R, t = _kabsch(Pw, Xc)
    return SE3(matrix_to_quat(R), t), v_ok & lin_ok & den_ok & depth_ok
