"""Local bundle adjustment: masked Levenberg-Marquardt with Schur
elimination over virtual landmarks.

Port of alvaar_tpu/solvers/ba.py.  The window's observations stay the
fixed-shape [W, K] keyframe tables; by the stable-slot invariant a
landmark's observations sit in one column k while it is tracked, so
landmark parameters are re-indexed as virtual landmarks (g, k) = (first
observing row, column) and every segment reduction is an einsum over W.
A landmark that the local-map matching re-found in another column
(``worldmap/matching.py``) has one virtual landmark per column; the
write-back keeps the last of their depths (the highest flat [w, k]),
which is what the JAX package's scatter gives on the CPU.  Inverse depths
are 1-parameter blocks, so the Schur complement
S = H_cc − H_clᵀ D⁻¹ H_cl is dense [6W, 6W] and solved by Cholesky
(``torch.linalg.cholesky_ex``, the JAX package leaves it to XLA too).
Per-observation Jacobians are forward-mode autodiff of the 13-parameter
residual at the zero retraction (``torch.func.jacfwd`` under ``vmap``).
Everything runs in float32 with TF32 off (the caller, ``AlvaAR``, turns
it off; the JAX package forces the same f32 "island").
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.solvers.pnp import CHI2_THRESH_2DOF
from alvaar_tpu_torch.worldmap.state import masked_scatter_set

# torch's forward-mode AD keeps one dual level for the whole process
# (torch.autograd.forward_ad), so ``jacfwd`` runs in one thread at a time:
# the shards of a sharded multi-stream step linearise in turns
_FORWARD_AD_LOCK = threading.Lock()


@dataclasses.dataclass
class BAProblem:
    """Fixed-shape local-BA inputs (the window slice of the map state)."""
    poses: SE3                 # [W] T_cw keyframe poses
    kf_valid: torch.Tensor     # [W] bool
    constant: torch.Tensor     # [W] bool — gauge-fixed poses
    anchor_kf: torch.Tensor    # [L] int — ring slot of each anchor
    anchor_mxy: torch.Tensor   # [L, 2] normalized anchor-frame coords
    invdepth: torch.Tensor     # [L]
    lm_valid: torch.Tensor     # [L] bool
    obs_lm: torch.Tensor       # [W, K] int landmark ids
    obs_px: torch.Tensor       # [W, K, 2] undistorted observations
    obs_valid: torch.Tensor    # [W, K] bool


@dataclasses.dataclass
class BAResult:
    poses: SE3
    invdepth: torch.Tensor
    obs_inlier: torch.Tensor   # [W, K]
    cost: torch.Tensor
    num_obs: torch.Tensor


@dataclasses.dataclass
class _VirtualProblem:
    poses: SE3
    kf_valid: torch.Tensor
    constant: torch.Tensor
    valid: torch.Tensor        # [W, K] usable observations
    px: torch.Tensor           # [W, K, 2]
    E: torch.Tensor            # [W(g), W(w), K] f32 membership
    is_rep: torch.Tensor       # [W, K] live virtual landmark
    lam_v: torch.Tensor        # [W, K]
    mxy: torch.Tensor          # [W, K, 2]
    A1hot: torch.Tensor        # [W, K, W] one-hot anchor slot
    a_const: torch.Tensor      # [W, K]
    a_valid: torch.Tensor      # [W, K]


def _build_virtual(prob: BAProblem) -> _VirtualProblem:
    W, K = prob.obs_lm.shape
    dev = prob.obs_lm.device
    dt = prob.obs_px.dtype
    lm = prob.obs_lm
    valid = prob.obs_valid & prob.lm_valid[lm] & prob.kf_valid[:, None]
    a_slot = prob.anchor_kf[lm]
    mxy = prob.anchor_mxy[lm]
    lam_obs = prob.invdepth[lm]

    member = (lm[:, None, :] == lm[None, :, :]) & valid[:, None, :] & valid[None, :, :]
    g_iota = torch.arange(W, device=dev)[:, None, None].expand(W, W, K)
    first = torch.min(torch.where(member, g_iota, W), dim=0).values     # [w, k]
    is_rep = valid & (first == torch.arange(W, device=dev)[:, None])
    E = (member & (first[None, :, :] == g_iota)).to(dt)
    lam_v = torch.where(is_rep, lam_obs, 1.0)

    a_idx = a_slot.clamp(0, W - 1)
    A1hot = (a_idx[:, :, None] == torch.arange(W, device=dev)[None, None, :]).to(dt)
    a_const = prob.constant[a_idx]
    a_valid = prob.kf_valid[a_idx] & (a_slot >= 0)
    return _VirtualProblem(
        poses=prob.poses, kf_valid=prob.kf_valid, constant=prob.constant,
        valid=valid & a_valid, px=prob.obs_px, E=E, is_rep=is_rep, lam_v=lam_v,
        mxy=mxy, A1hot=A1hot, a_const=a_const, a_valid=a_valid)


def _obs_residual(params13, q_o, t_o, q_a, t_a, mxy, lam, px, fx, fy, cx, cy):
    """Reprojection residual of one observation at a 13-dim retraction
    [ξ_observer(6), ξ_anchor(6), δλ(1)].  Returns (r [2], z)."""
    xi_o, xi_a, dl = params13[:6], params13[6:12], params13[12]
    T_o = SE3.exp(xi_o).compose(SE3(q_o, t_o))
    T_a = SE3.exp(xi_a).compose(SE3(q_a, t_a))
    lam_new = lam + dl
    # full_like: under jacfwd a Python scalar against a 0-d tensor promotes
    # to float64
    lam_safe = torch.where(torch.abs(lam_new) < 1e-6, torch.full_like(lam_new, 1e-6), lam_new)
    X_a = torch.cat([mxy, torch.ones_like(mxy[:1])]) / lam_safe
    X_c = T_o.apply(T_a.inverse().apply(X_a))
    z = X_c[2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * X_c[0] / z_safe + cx
    v = fy * X_c[1] / z_safe + cy
    return torch.stack([u - px[0], v - px[1]]), z


def _per_obs_inputs(vp: _VirtualProblem, poses: SE3, lam_v):
    W, K = vp.valid.shape
    q_o = poses.q[:, None, :].expand(W, K, 4)
    t_o = poses.t[:, None, :].expand(W, K, 3)
    q_a = torch.einsum("wkv,vq->wkq", vp.A1hot, poses.q)
    t_a = torch.einsum("wkv,vq->wkq", vp.A1hot, poses.t)
    lam = torch.einsum("gwk,gk->wk", vp.E, lam_v)
    return q_o, t_o, q_a, t_a, torch.where(vp.valid, lam, 1.0)


def _residuals_jacobians(vp: _VirtualProblem, poses: SE3, lam_v, cam: Camera):
    """Residuals [W, K, 2], Jacobians [W, K, 2, 13], depths [W, K]."""
    W, K = vp.valid.shape
    q_o, t_o, q_a, t_a, lam = _per_obs_inputs(vp, poses, lam_v)
    zero13 = torch.zeros(13, dtype=vp.px.dtype, device=vp.px.device)
    # intrinsics as float32 tensors: under jacfwd a Python float times a
    # 0-d tensor would promote to float64
    intr = tuple(zero13.new_tensor(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))

    def one(q_o, t_o, q_a, t_a, mxy, lam, px):
        args = (q_o, t_o, q_a, t_a, mxy, lam, px) + intr
        r, z = _obs_residual(zero13, *args)
        J = torch.func.jacfwd(lambda p: _obs_residual(p, *args)[0])(zero13)
        return r, J, z

    flat = lambda x: x.reshape((W * K,) + x.shape[2:])
    with _FORWARD_AD_LOCK:
        r, J, z = torch.func.vmap(one)(flat(q_o), flat(t_o), flat(q_a), flat(t_a),
                                       flat(vp.mxy), flat(lam), flat(vp.px))
    return r.reshape(W, K, 2), J.reshape(W, K, 2, 13), z.reshape(W, K)


def _rot_soa(qw, qx, qy, qz, vx, vy, vz):
    """quat_rotate on component planes: v + 2 q×(q×v + w v)."""
    cx = qy * vz - qz * vy + qw * vx
    cy = qz * vx - qx * vz + qw * vy
    cz = qx * vy - qy * vx + qw * vz
    return (vx + 2.0 * (qy * cz - qz * cy),
            vy + 2.0 * (qz * cx - qx * cz),
            vz + 2.0 * (qx * cy - qy * cx))


def _residuals_fast(vp: _VirtualProblem, poses: SE3, lam_v, cam: Camera):
    """Jacobian-free residual/depth pass on [W, K] component planes."""
    lam = torch.where(vp.valid, torch.einsum("gwk,gk->wk", vp.E, lam_v), 1.0)
    lam_safe = torch.where(torch.abs(lam) < 1e-6, 1e-6, lam)
    Xax = vp.mxy[..., 0] / lam_safe
    Xay = vp.mxy[..., 1] / lam_safe
    Xaz = 1.0 / lam_safe
    q_a = torch.einsum("wkv,vq->wkq", vp.A1hot, poses.q)
    t_a = torch.einsum("wkv,vq->wkq", vp.A1hot, poses.t)
    Xwx, Xwy, Xwz = _rot_soa(q_a[..., 0], -q_a[..., 1], -q_a[..., 2],
                             -q_a[..., 3], Xax - t_a[..., 0],
                             Xay - t_a[..., 1], Xaz - t_a[..., 2])
    q = poses.q[:, None, :]
    Xcx, Xcy, Xcz = _rot_soa(q[..., 0], q[..., 1], q[..., 2], q[..., 3],
                             Xwx, Xwy, Xwz)
    Xcx = Xcx + poses.t[:, None, 0]
    Xcy = Xcy + poses.t[:, None, 1]
    z = Xcz + poses.t[:, None, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * Xcx / z_safe + cam.cx
    v = cam.fy * Xcy / z_safe + cam.cy
    return torch.stack([u - vp.px[..., 0], v - vp.px[..., 1]], dim=-1), z


def _huber_w(r2, delta):
    rn = torch.sqrt(r2.clamp_min(1e-12))
    return torch.where(rn <= delta, 1.0, delta / rn)


def _huber_rho(r2, delta):
    rn = torch.sqrt(r2.clamp_min(1e-12))
    return torch.where(rn <= delta, r2, 2 * delta * rn - delta * delta)


@dataclasses.dataclass
class _Linearization:
    H_cc: torch.Tensor   # [6W, 6W]
    g_c: torch.Tensor    # [6W]
    u: torch.Tensor      # [W, K, 6]
    va: torch.Tensor     # [W(g), K, 6]
    D: torch.Tensor      # [W(g), K]
    g_l: torch.Tensor    # [W(g), K]
    cost: torch.Tensor


def _linearize(vp: _VirtualProblem, poses: SE3, lam_v, cam: Camera,
               huber_delta) -> _Linearization:
    """Blockwise normal-equation build (the full camera-row Jacobian is
    never materialized)."""
    W, K = vp.valid.shape
    C = 6 * W
    r, J, _ = _residuals_jacobians(vp, poses, lam_v, cam)
    r2 = torch.sum(r * r, dim=-1)
    w = torch.where(vp.valid, _huber_w(r2, huber_delta), 0.0)
    cost = torch.sum(torch.where(vp.valid, _huber_rho(r2, huber_delta), 0.0))

    J_o = torch.where(vp.constant[:, None, None, None], 0.0, J[..., :6])
    J_a = torch.where(vp.a_const[:, :, None, None], 0.0, J[..., 6:12])
    J_l = J[..., 12]
    wJ_o = J_o * w[:, :, None, None]
    wJ_a = J_a * w[:, :, None, None]
    A = vp.A1hot
    eyeW = torch.eye(W, dtype=J.dtype, device=J.device)

    Hoo = torch.einsum("wkri,wkrj->wij", wJ_o, J_o)
    Hoa = torch.einsum("wkri,wkrj,wka->waij", wJ_o, J_a, A)
    Haa = torch.einsum("wkri,wkrj,wka->aij", wJ_a, J_a, A)
    Hblk = (eyeW[:, :, None, None] * (Hoo + Haa)[:, None]
            + Hoa + Hoa.permute(1, 0, 3, 2))
    H_cc = Hblk.permute(0, 2, 1, 3).reshape(C, C)
    g_c = (torch.einsum("wkri,wkr->wi", wJ_o, r)
           + torch.einsum("wkri,wkr,wka->ai", wJ_a, r, A)).reshape(C)

    wJl = J_l * w[:, :, None]
    u = torch.einsum("wkr,wkri->wki", wJl, J_o)
    v = torch.einsum("wkr,wkri->wki", wJl, J_a)
    D = torch.einsum("gwk,wk->gk", vp.E, w * torch.sum(J_l * J_l, -1))
    g_l = torch.einsum("gwk,wk->gk", vp.E, torch.sum(wJl * r, -1))
    va = torch.einsum("gwk,wki->gki", vp.E, v)
    return _Linearization(H_cc, g_c, u, va, D, g_l, cost)


def _solve_lm(vp: _VirtualProblem, lin: _Linearization, lam_lm):
    """Damped Schur solve.  Returns (delta_pose [W, 6], delta_lam_v [W, K])."""
    W, K = vp.valid.shape
    C = 6 * W
    eyeW = torch.eye(W, dtype=lin.H_cc.dtype, device=lin.H_cc.device)
    Av = vp.A1hot
    u, va, D, g_l = lin.u, lin.va, lin.D, lin.g_l

    H_cc = lin.H_cc + torch.diag(lam_lm * torch.diagonal(lin.H_cc).clamp_min(1e-8))
    lm_active = vp.is_rep & (D > 1e-12)
    invD = torch.where(lm_active, 1.0 / torch.where(lm_active, D * (1.0 + lam_lm), 1.0), 0.0)

    Ed = vp.E * invD[:, None, :]
    G = torch.einsum("gxk,gyk->xyk", Ed, vp.E)
    T_uu = torch.einsum("xyk,xki,ykj->xyij", G, u, u)
    F = torch.einsum("gxk,gky,gkj->xkyj", Ed, Av, va)
    T_uv = torch.einsum("xkyj,xki->xyij", F, u)
    T_vv = torch.einsum("gkx,gk,gki,gkj->xij", Av, invD, va, va)
    M = T_uu + T_uv + T_uv.permute(1, 0, 3, 2) + eyeW[:, :, None, None] * T_vv[:, None]
    S = H_cc - M.permute(0, 2, 1, 3).reshape(C, C)

    gld = g_l * invD
    hts = (torch.einsum("gxk,gk,xki->xi", vp.E, gld, u)
           + torch.einsum("gkx,gk,gki->xi", Av, gld, va))
    g_s = lin.g_c - hts.reshape(C)

    free6 = (vp.kf_valid & ~vp.constant).repeat_interleave(6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 1e-9, 1.0))
    g_s = torch.where(free6, g_s, 0.0)

    # SPD by construction; an indefinite system gives a zero step, which
    # the LM loop then rejects (the JAX package's isfinite guard)
    chol, info = torch.linalg.cholesky_ex(0.5 * (S + S.T))
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    y = torch.linalg.solve_triangular(chol, g_s[:, None], upper=False)
    delta_c = -torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]
    delta_c = torch.where(ok & torch.isfinite(delta_c), delta_c, 0.0)
    dC = torch.where(free6, delta_c, 0.0).reshape(W, 6)

    hdc = (torch.einsum("gxk,xki,xi->gk", vp.E, u, dC)
           + torch.einsum("gki,gkx,xi->gk", va, Av, dC))
    delta_l = torch.where(lm_active, -(g_l + hdc) * invD, 0.0)
    return dC, delta_l


def _lm_phase(vp: _VirtualProblem, cam: Camera, delta_huber, n_iters: int,
              poses: SE3, lam_v):
    """Branch-free accept/reject LM: linearize + solve, then one
    Jacobian-free residual pass for the trial cost."""
    def cost_only(poses, lam_v):
        r, _ = _residuals_fast(vp, poses, lam_v, cam)
        r2 = torch.sum(r * r, dim=-1)
        return torch.sum(torch.where(vp.valid, _huber_rho(r2, delta_huber), 0.0))

    cost = cost_only(poses, lam_v)
    lam_lm = torch.tensor(1e-4, dtype=lam_v.dtype, device=lam_v.device)
    for _ in range(n_iters):
        lin = _linearize(vp, poses, lam_v, cam, delta_huber)
        dc, dl = _solve_lm(vp, lin, lam_lm)
        new_poses = SE3.exp(dc).compose(poses).normalize()
        new_lam_v = lam_v + dl
        new_cost = cost_only(new_poses, new_lam_v)
        accept = new_cost < cost
        poses = SE3.where(accept, new_poses, poses)
        lam_v = torch.where(accept, new_lam_v, lam_v)
        cost = torch.where(accept, new_cost, cost)
        lam_lm = torch.where(accept, lam_lm * 0.33, lam_lm * 10.0).clamp(1e-8, 1e8)
    return poses, lam_v, cost


def local_ba(prob: BAProblem, cam: Camera, *, iters: int = 5,
             refine_iters: int = 2,
             huber_delta: float = CHI2_THRESH_2DOF ** 0.5,
             chi2_thresh: float = CHI2_THRESH_2DOF) -> BAResult:
    """Huber LM solve, chi²/depth outlier pruning, short L2 re-solve on the
    inliers."""
    vp =_build_virtual(prob)
    poses1, lam_v1, _ = _lm_phase(vp, cam, huber_delta, iters, prob.poses, vp.lam_v)

    r, z = _residuals_fast(vp, poses1, lam_v1, cam)
    r2 = torch.sum(r * r, dim=-1)
    lam_obs1 = torch.einsum("gwk,gk->wk", vp.E, lam_v1)
    keep = vp.valid & (r2 <= chi2_thresh) & (z > 0) & (lam_obs1 > 1e-6)

    # L2 re-solve on the inliers (Huber with a huge delta is L2)
    vp2 = dataclasses.replace(vp, valid=keep)
    poses2, lam_v2, cost = _lm_phase(vp2, cam, 1e9, refine_iters, poses1, lam_v1)

    r, z = _residuals_fast(vp2, poses2, lam_v2, cam)
    r2 = torch.sum(r * r, dim=-1)
    lam_obs2 = torch.einsum("gwk,gk->wk", vp.E, lam_v2)
    inlier = vp.valid & (r2 <= chi2_thresh) & (z > 0) & (lam_obs2 > 1e-6)

    # a merged landmark's virtual landmarks collide here: the last one wins
    invdepth = masked_scatter_set(prob.invdepth, prob.obs_lm.reshape(-1),
                                  lam_v2.reshape(-1), vp.is_rep.reshape(-1))
    return BAResult(poses=poses2.normalize(), invdepth=invdepth,
                    obs_inlier=inlier, cost=cost, num_obs=torch.sum(inlier))
