"""Nister five-point minimal essential-matrix solver (port of
alvaar_tpu/solvers/fivept.py).

The 5 epipolar constraints give a 4-D null space E = x·X + y·Y + z·Z + W;
det(E) = 0 and 2·E Eᵀ E − tr(E Eᵀ)·E = 0 give 10 cubics in (x, y, z, w),
built from static monomial-product tables; Gauss-Jordan elimination and
Nister's z-elimination leave a degree-10 polynomial in z.  Its real roots
are found as the JAX package finds them: a sign scan of the homogeneous
polynomial on a trig grid z = tan θ, then a fixed number of bisections on
every sign-change interval (not an eigensolver: the scan is what the
reference computes, so roots compare one to one).  Every shape is fixed,
so all RANSAC samples run as one batch.

Where the JAX package scatter-adds monomial products (``.at[].add``), the
port sums gathered products in a fixed order: no atomics, so the result
is the same on every run on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from alvaar_tpu_torch.geom.lie import SE3, matrix_to_quat
from alvaar_tpu_torch.ops.index import take_row
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.solvers.essential import (
    RelativePoseResult,
    _score_candidates,
    decompose_essential,
    essential_thresh,
    refine_relative_pose,
)
from alvaar_tpu_torch.solvers.ransac import minimal_samples
from alvaar_tpu_torch.utils.stats import count
from alvaar_tpu_torch.utils.tables import device_table

# ---------------------------------------------------------------------------
# Static monomial algebra tables (numpy, built at import as in JAX)
# ---------------------------------------------------------------------------
# A monomial is its exponent tuple (ex, ey, ez, ew).


def _monomials(total):
    out = []
    for ex in range(total, -1, -1):
        for ey in range(total - ex, -1, -1):
            for ez in range(total - ex - ey, -1, -1):
                out.append((ex, ey, ez, total - ex - ey - ez))
    return out


_DEG1 = _monomials(1)          # 4
_DEG2 = _monomials(2)          # 10
_DEG3_RAW = _monomials(3)      # 20

# Nister's order of the 20 cubic monomials: the 10 of degree >= 2 in
# (x, y) first, then the basis v = [xz², xzw, xw², yz², yzw, yw², z³, z²w,
# zw², w³]
_HEAD_ORDER = [(3, 0, 0, 0), (2, 1, 0, 0), (1, 2, 0, 0), (0, 3, 0, 0),
               (2, 0, 1, 0), (2, 0, 0, 1), (1, 1, 1, 0), (1, 1, 0, 1),
               (0, 2, 1, 0), (0, 2, 0, 1)]
_TAIL_ORDER = [(1, 0, 2, 0), (1, 0, 1, 1), (1, 0, 0, 2),
               (0, 1, 2, 0), (0, 1, 1, 1), (0, 1, 0, 2),
               (0, 0, 3, 0), (0, 0, 2, 1), (0, 0, 1, 2), (0, 0, 0, 3)]
_DEG3 = _HEAD_ORDER + _TAIL_ORDER
assert sorted(_DEG3) == sorted(_DEG3_RAW)

_D2 = {m: i for i, m in enumerate(_DEG2)}
_D3 = {m: i for i, m in enumerate(_DEG3)}


def _mul_table(basis_a, basis_b, out_index):
    """[len(a), len(b)] int table: index of a_i * b_j in the out basis."""
    t = np.zeros((len(basis_a), len(basis_b)), np.int32)
    for i, ma in enumerate(basis_a):
        for j, mb in enumerate(basis_b):
            t[i, j] = out_index[tuple(ea + eb for ea, eb in zip(ma, mb))]
    return t


_T11 = _mul_table(_DEG1, _DEG1, _D2)   # deg1*deg1 -> deg2
_T21 = _mul_table(_DEG2, _DEG1, _D3)   # deg2*deg1 -> deg3


def _gather_table(table, n_out):
    """For each output monomial, the flat product indices that land on it,
    in increasing order, padded with the index of an appended zero."""
    flat = table.reshape(-1)
    lists = [np.nonzero(flat == o)[0].tolist() for o in range(n_out)]
    width = max(len(lst) for lst in lists)
    pad = flat.shape[0]
    return np.array([lst + [pad] * (width - len(lst)) for lst in lists], np.int64)


_G11 = _gather_table(_T11, 10)         # [10, 2]
_G21 = _gather_table(_T21, 20)         # [20, 3]

_ROW_X2Z = _HEAD_ORDER.index((2, 0, 1, 0))
_ROW_X2W = _HEAD_ORDER.index((2, 0, 0, 1))
_ROW_Y2Z = _HEAD_ORDER.index((0, 2, 1, 0))
_ROW_Y2W = _HEAD_ORDER.index((0, 2, 0, 1))
_ROW_XYZ = _HEAD_ORDER.index((1, 1, 1, 0))
_ROW_XYW = _HEAD_ORDER.index((1, 1, 0, 1))


def _poly_mul(a, b, gather):
    """Coefficient vectors a [..., A] x b [..., B] → [..., n_out]: every
    product a_i·b_j summed into its output monomial, in index order."""
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)
    prod = torch.cat([prod, torch.zeros_like(prod[..., :1])], dim=-1)
    g = device_table(gather, a.device)
    out = prod[..., g[:, 0]]
    for k in range(1, g.shape[1]):
        out = out + prod[..., g[:, k]]
    return out


def _p1_mul(a, b):
    """deg1 [..., 4] x deg1 [..., 4] → deg2 [..., 10]."""
    return _poly_mul(a, b, _G11)


def _p2_mul(a, b):
    """deg2 [..., 10] x deg1 [..., 4] → deg3 [..., 20]."""
    return _poly_mul(a, b, _G21)


def _constraint_matrix(basis):
    """basis [..., 4, 3, 3] null-space matrices (X, Y, Z, W) →
    M [..., 10, 20] cubic-constraint coefficients."""
    P = torch.movedim(basis, -3, -1)                       # [..., 3, 3, 4]

    def p1(i, j):
        return P[..., i, j, :]

    det = 0
    for j, (a, b) in zip(range(3), [(1, 2), (0, 2), (0, 1)]):
        minor = _p1_mul(p1(1, a), p1(2, b)) - _p1_mul(p1(1, b), p1(2, a))
        term = _p2_mul(minor, p1(0, j))
        det = det + (term if j != 1 else -term)

    EEt = [[sum(_p1_mul(p1(i, k), p1(j, k)) for k in range(3))
            for j in range(3)] for i in range(3)]
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]

    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = 0
            for k in range(3):
                c2 = 2.0 * EEt[i][k]
                if i == k:
                    c2 = c2 - trace
                acc = acc + _p2_mul(c2, p1(k, j))
            rows.append(acc)
    return torch.stack(rows, dim=-2)                       # [..., 10, 20]


def _shift_sum(terms, width):
    """Σ terms[i] placed at offset shifts[i] of a [..., width] vector, added
    in list order.  ``terms``: [(shift, tensor [..., n])]."""
    out = None
    for s, t in terms:
        placed = torch.nn.functional.pad(t, (s, width - s - t.shape[-1]))
        out = placed if out is None else out + placed
    return out


def _poly_conv(a, b):
    """1-D polynomial product along the last axis (ascending powers)."""
    la, lb = a.shape[-1], b.shape[-1]
    return _shift_sum([(i, a[..., i:i + 1] * b) for i in range(la)], la + lb - 1)


def _degree10(C):
    """C [..., 10, 10] elimination result (head = C @ v).  Returns (the
    degree-10 z-polynomial [..., 11] ascending, and the (x, y, 1) row
    polynomials k, l, m of B(z) for recovering x and y)."""

    def group(r_hi, r_lo):
        row = torch.stack([C[..., r_hi, :], -C[..., r_lo, :]], dim=-1)  # [..., 10, 2]

        def comb(idxs, shifts, width):
            return _shift_sum([(s, row[..., i, :]) for i, s in zip(idxs, shifts)],
                              width)

        return (comb([0, 1, 2], [2, 1, 0], 4), comb([3, 4, 5], [2, 1, 0], 4),
                comb([6, 7, 8, 9], [3, 2, 1, 0], 5))

    k = group(_ROW_X2Z, _ROW_X2W)
    l = group(_ROW_Y2Z, _ROW_Y2W)
    m = group(_ROW_XYZ, _ROW_XYW)

    def minor(a, b, c, d):
        return _poly_conv(a, d) - _poly_conv(b, c)

    p = (_poly_conv(k[0], minor(l[1], l[2], m[1], m[2]))
         - _poly_conv(k[1], minor(l[0], l[2], m[0], m[2]))
         + _poly_conv(k[2], minor(l[0], l[1], m[0], m[1])))
    return p, (k, l, m)


def _int_pow(x, n: int):
    """x**n by square-and-multiply in the order XLA's integer_pow uses."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _real_roots_deg10(p, n_grid: int = 128, bisect_iters: int = 30):
    """All real roots of p(z) (ascending coefficients [..., 11]) through
    the homogeneous form p_h(θ) = Σ a_i sⁱ c^(10−i), (s, c) = (sin θ,
    cos θ), θ ∈ (−π/2, π/2): a sign scan on ``n_grid`` intervals, then
    ``bisect_iters`` bisections.  Returns (roots [..., n_grid], mask
    [..., n_grid]); at most 10 entries are live."""
    deg = p.shape[-1] - 1

    def ph(theta):
        # summed term by term in index order: near a root the sign of this
        # ill-conditioned sum is decided by its rounding, so the order is
        # the JAX package's sequential reduction
        s, c = torch.sin(theta), torch.cos(theta)
        out = 0.0
        for i in range(deg + 1):
            out = out + p[..., i:i + 1] * (_int_pow(s, i) * _int_pow(c, deg - i))
        return out

    eps = 1e-3
    thetas = torch.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, n_grid + 1,
                            dtype=p.dtype, device=p.device)
    grid = thetas.expand(p.shape[:-1] + (n_grid + 1,))
    vals = ph(grid)
    lo_v, hi_v = vals[..., :-1], vals[..., 1:]
    has_root = torch.sign(lo_v) * torch.sign(hi_v) < 0
    lo, hi = grid[..., :-1], grid[..., 1:]
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        mv = ph(mid)
        left = torch.sign(mv) * torch.sign(lo_v) < 0
        lo, hi, lo_v = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                        torch.where(left, lo_v, mv))
    return torch.tan(0.5 * (lo + hi)), has_root


def essential_from_5pt(f0, f1, n_grid: int = 64, bisect_iters: int = 26):
    """f0, f1 [..., 5, 3] bearings → (E [..., 10, 3, 3] unit-norm
    candidates, valid [..., 10])."""
    A = (f1[..., :, :, None] * f0[..., :, None, :]).flatten(-2)      # [..., 5, 9]
    Vt = torch.linalg.svd(A, full_matrices=True).Vh
    basis = Vt[..., 5:9, :].unflatten(-1, (3, 3))          # X, Y, Z, W
    return essential_from_basis(basis, n_grid=n_grid, bisect_iters=bisect_iters)


def essential_from_basis(basis, n_grid: int = 64, bisect_iters: int = 26):
    """The solver past the SVD: null-space basis [..., 4, 3, 3] → (E
    [..., 10, 3, 3], valid [..., 10]).  Any basis of the same space gives
    the same set of essential matrices."""
    M = _constraint_matrix(basis)                          # [..., 10, 20]
    eye = torch.eye(10, dtype=M.dtype, device=M.device)
    # M1·head + M2·v = 0 → head = −(M1⁻¹ M2)·v; the 1e-12 regularizes the
    # singular left block of degenerate samples
    C = -torch.linalg.solve(M[..., :, :10] + 1e-12 * eye, M[..., :, 10:])
    p, (k, l, _) = _degree10(C)
    roots, mask = _real_roots_deg10(p, n_grid=n_grid, bisect_iters=bisect_iters)

    # keep the first 10 live slots (a degree-10 polynomial has no more),
    # in slot order
    _, top = top_k(mask.to(torch.int32), 10)
    top = torch.sort(top, dim=-1).values
    roots = torch.gather(roots, -1, top)
    mask = torch.gather(mask, -1, top)

    def polyval(c, z):
        out = 0.0
        for i in range(c.shape[-1]):
            out = out + c[..., i:i + 1] * _int_pow(z, i)
        return out

    # (x, y) from the null vector of B(z)'s first two rows
    n1 = torch.stack([polyval(c, roots) for c in k], dim=-1)
    n2 = torch.stack([polyval(c, roots) for c in l], dim=-1)
    nv = torch.linalg.cross(n1, n2, dim=-1)                # [..., 10, 3]
    wcomp = nv[..., 2]
    live = torch.abs(wcomp) > 1e-12
    safe = torch.where(live, wcomp, 1.0)
    coeff = torch.stack([nv[..., 0] / safe, nv[..., 1] / safe, roots,
                         torch.ones_like(roots)], dim=-1)  # [..., 10, 4]
    E = torch.sum(coeff[..., :, :, None, None] * basis[..., None, :, :, :], dim=-3)
    En = torch.linalg.norm(E, dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    return E / En, mask & live


def essential_ransac_5pt(gen, f0, f1, valid, *, focal, iters: int = 100,
                         err_px: float = 3.0, min_inliers: int = 10,
                         n_grid: int = 64, samples=None) -> RelativePoseResult:
    """RANSAC relative pose with the Nister solver: 5-point samples, ≤ 10
    essential candidates each, scored like the 8-point path.
    ``samples`` = (idx [iters, 5], ok [iters]), or a uniform draw [iters,
    N], replaces the generator's draw.  ``essential_ransac_5pt.calls``
    counts the calls."""
    count(essential_ransac_5pt, "calls")
    idx, samp_ok = minimal_samples(gen, valid, 5, iters, samples)
    E, emask = essential_from_5pt(f0[idx], f1[idx], n_grid=n_grid)  # [H, 10, ...]
    H, R = emask.shape
    cand_ok = (emask & samp_ok[:, None]).reshape(H * R)

    R4, t4 = decompose_essential(E.reshape(H * R, 3, 3))
    C = H * R * 4
    pose_01 = SE3(matrix_to_quat(R4.reshape(C, 3, 3)), t4.reshape(C, 3)).inverse()

    thresh = essential_thresh(err_px, focal, f0)
    err, posdepth = _score_candidates(pose_01, f0, f1)
    inl = (err < thresh) & posdepth & valid[None]
    counts = torch.where(cand_ok.repeat_interleave(4), torch.sum(inl, dim=-1), -1)
    best = torch.argmax(counts)

    best_pose, inliers, num = refine_relative_pose(
        pose_01.row(best), take_row(inl, best), f0, f1, thresh, valid)
    return RelativePoseResult(best_pose, inliers, num, num >= min_inliers)


essential_ransac_5pt.calls = 0
