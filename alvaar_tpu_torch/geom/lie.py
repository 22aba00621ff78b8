"""SO(3)/SE(3) on quaternions — batched torch functions.

Port of alvaar_tpu/geom/lie.py.  Quaternions are ``[..., 4]`` (w, x, y, z),
tangent vectors ``[..., 6]`` (rho, phi) as in Sophus, and ``SE3`` is a
small dataclass ``(q, t)`` with ``apply(x) = R x + t``.  The small-angle
Taylor guards are kept exactly as in the JAX package (``torch.where`` on
safe denominators), so values agree near zero rotation.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-8


# --------------------------------------------------------------------------
# Quaternions
# --------------------------------------------------------------------------

def quat_identity(batch_shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_mul(a, b):
    """Hamilton product a ⊗ b, batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv + w * v)
    return v + 2.0 * uuv


def quat_to_matrix(q):
    """Unit quaternion [..., 4] → rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] → unit quaternion [..., 4] with w ≥ 0
    (Shepperd's method: all four candidates, pick the largest diagonal
    combination)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    vals = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                        1 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(vals, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)          # [..., 4, 4]
    gidx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, gidx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# --------------------------------------------------------------------------
# SO(3)
# --------------------------------------------------------------------------

def so3_hat(w):
    """[..., 3] → skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(phi):
    """Axis-angle [..., 3] → unit quaternion [..., 4] (Taylor-safe)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def so3_log(q):
    """Unit quaternion [..., 4] → axis-angle [..., 3] (Taylor-safe)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = q[..., :1].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-8
    vn = torch.sqrt(torch.where(small, 1.0, vn2))
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small,
                    2.0 / w.clamp_min(_EPS)
                    * (1.0 - vn2 / (3.0 * (w * w).clamp_min(_EPS))),
                    theta / vn)
    return k * v


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _so3_left_jacobian(phi):
    """V(phi) [..., 3, 3] with exp_se3([rho, phi]).t = V @ rho."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    K = so3_hat(phi)
    KK = K @ K
    a = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(theta)) / theta2_safe)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return _eye3(phi) + a * K + b * KK


def _so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    K = so3_hat(phi)
    KK = K @ K
    half = 0.5 * theta
    sin_half = torch.sin(half)
    sin_half = torch.where(torch.abs(sin_half) < _EPS, _EPS, sin_half)
    cot = torch.cos(half) / sin_half
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * cot) / theta2_safe)
    return _eye3(phi) - 0.5 * K + c * KK


# --------------------------------------------------------------------------
# SE(3)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SE3:
    """Rigid transform (unit quaternion, translation), batched over the
    leading dims of both fields.  ``apply``: x ↦ R x + t."""

    q: torch.Tensor  # [..., 4] (w, x, y, z)
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        return SE3(quat_identity(batch_shape, dtype, device),
                   torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                               device=device))

    @staticmethod
    def from_matrix(T) -> "SE3":
        return SE3(matrix_to_quat(T[..., :3, :3]), T[..., :3, 3])

    @staticmethod
    def exp(xi) -> "SE3":
        """Tangent [..., 6] (rho, phi) → SE3."""
        rho, phi = xi[..., :3], xi[..., 3:]
        q = so3_exp(phi)
        V = _so3_left_jacobian(phi)
        return SE3(q, (V @ rho[..., None])[..., 0])

    def log(self):
        phi = so3_log(self.q)
        Vinv = _so3_left_jacobian_inv(phi)
        rho = (Vinv @ self.t[..., None])[..., 0]
        return torch.cat([rho, phi], dim=-1)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other (apply other first)."""
        return SE3(quat_normalize(quat_mul(self.q, other.q)),
                   quat_rotate(self.q, other.t) + self.t)

    def inverse(self) -> "SE3":
        qi = quat_conj(self.q)
        return SE3(qi, -quat_rotate(qi, self.t))

    def apply(self, x):
        return quat_rotate(self.q, x) + self.t

    def rotate(self, x):
        return quat_rotate(self.q, x)

    def matrix(self):
        """[..., 4, 4] homogeneous matrix."""
        batch = self.q.shape[:-1]
        T = torch.zeros(batch + (4, 4), dtype=self.q.dtype, device=self.q.device)
        T[..., :3, :3] = quat_to_matrix(self.q)
        T[..., :3, 3] = self.t
        T[..., 3, 3] = 1.0
        return T

    def retract(self, xi) -> "SE3":
        """Left-multiplicative update ``Exp(xi) ∘ self``."""
        return SE3.exp(xi).compose(self)

    def normalize(self) -> "SE3":
        return SE3(quat_normalize(self.q), self.t)

    # -- tensor plumbing (the JAX package does these with jax.tree.map) --
    def __getitem__(self, idx) -> "SE3":
        return SE3(self.q[idx], self.t[idx])

    def unsqueeze(self, dim: int) -> "SE3":
        return SE3(self.q.unsqueeze(dim), self.t.unsqueeze(dim))

    def clone(self) -> "SE3":
        return SE3(self.q.clone(), self.t.clone())

    @staticmethod
    def where(cond, a: "SE3", b: "SE3") -> "SE3":
        """Per-element select: ``cond`` broadcasts against the batch dims."""
        c = torch.as_tensor(cond, device=a.q.device)[..., None]
        return SE3(torch.where(c, a.q, b.q), torch.where(c, a.t, b.t))
