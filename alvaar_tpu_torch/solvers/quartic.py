"""Closed-form batched real roots of cubics and quartics (port of
alvaar_tpu/solvers/quartic.py): Cardano's trigonometric method for the
resolvent cubic, Ferrari factorization, a biquadratic fallback, and two
Newton polish steps on the original quartic."""

from __future__ import annotations

import torch

_EPS = 1e-12


def solve_cubic_real_max(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d (batched)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    p_neg = torch.clamp_max(p, -_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    t_tri = m * torch.cos(torch.arccos(arg) / 3.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    u3 = -q / 2.0 + sq
    v3 = -q / 2.0 - sq
    cbrt = lambda v: torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)
    t_one = cbrt(u3) + cbrt(v3)
    return torch.where(disc > 0, t_one, t_tri) - b / 3.0


def solve_quartic_real(c4, c3, c2, c1, c0, *, newton_iters: int = 2):
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0.
    Returns (roots [..., 4], valid [..., 4]); invalid lanes hold 0."""
    c4s = torch.where(torch.abs(c4) < _EPS, _EPS, c4)
    p, q, r, s = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    p2 = p * p
    A = q - 3.0 * p2 / 8.0
    B = r - p * q / 2.0 + p2 * p / 8.0
    C = s - p * r / 4.0 + p2 * q / 16.0 - 3.0 * p2 * p2 / 256.0

    z0 = torch.clamp_min(solve_cubic_real_max(2.0 * A, A * A - 4.0 * C, -B * B), 0.0)
    w = torch.sqrt(z0)
    biquad = z0 < 1e-10
    w_safe = torch.where(biquad, 1.0, w)
    half = 0.5 * (A + z0)
    e0 = half - B / (2.0 * w_safe)
    e1 = half + B / (2.0 * w_safe)

    def quad_roots(bq, cq):
        disc = bq * bq - 4.0 * cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        return (-bq + sq) / 2.0, (-bq - sq) / 2.0, disc >= 0

    r0a, r0b, ok0 = quad_roots(w, e0)
    r1a, r1b, ok1 = quad_roots(-w, e1)

    dbq = A * A - 4.0 * C
    sbq = torch.sqrt(torch.clamp_min(dbq, 0.0))
    y2a = (-A + sbq) / 2.0
    y2b = (-A - sbq) / 2.0
    bq_ok = dbq >= 0
    b0a = torch.sqrt(torch.clamp_min(y2a, 0.0))
    b1a = torch.sqrt(torch.clamp_min(y2b, 0.0))

    roots_f = torch.stack([r0a, r0b, r1a, r1b], dim=-1)
    valid_f = torch.stack([ok0, ok0, ok1, ok1], dim=-1)
    roots_b = torch.stack([b0a, -b0a, b1a, -b1a], dim=-1)
    va, vb = bq_ok & (y2a >= 0), bq_ok & (y2b >= 0)
    valid_b = torch.stack([va, va, vb, vb], dim=-1)

    y = torch.where(biquad[..., None], roots_b, roots_f)
    valid = torch.where(biquad[..., None], valid_b, valid_f)
    x = y - (p / 4.0)[..., None]

    k4, k3, k2, k1, k0 = (c[..., None] for c in (c4, c3, c2, c1, c0))
    for _ in range(newton_iters):
        f = (((k4 * x + k3) * x + k2) * x + k1) * x + k0
        df = ((4.0 * k4 * x + 3.0 * k3) * x + 2.0 * k2) * x + k1
        df = torch.where(torch.abs(df) < _EPS, _EPS, df)
        x = x - f / df
    return torch.where(valid, x, 0.0), valid
