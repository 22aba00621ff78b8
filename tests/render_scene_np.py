"""Numpy-only twin of tests/render_scene.py.

Renders the same two-plane textured world and the same ground-truth
trajectory without importing JAX, so the PyTorch port's tests and
``chip_smoke.py`` can use it on a machine that has no JAX.  The trajectory
builds its rotations by Rodrigues' formula in float64 and rounds them to
float32, in place of the JAX package's ``so3_exp``; the two agree to
float32 rounding (tests/test_torch_scene.py)."""

import numpy as np


def make_texture(rng, size=1024, octaves=5):
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        s = 2 ** (o + 2)
        small = rng.normal(size=(size // s + 2, size // s + 2)).astype(np.float32)
        idx = np.linspace(0, small.shape[0] - 1.001, size)
        i0 = idx.astype(int)
        f = idx - i0
        rows = small[i0] * (1 - f)[:, None] + small[i0 + 1] * f[:, None]
        tex += (rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]) * (2.0 ** o)
    tex -= tex.min()
    tex *= 220.0 / tex.max()
    return tex + 20.0


class TwoPlaneScene:
    """Near plane z=5 on world x < 0, far plane z=8 elsewhere, each with
    its own band-limited texture; ``render(T_wc)`` ray-casts one frame."""

    def __init__(self, rng, width=320, height=240, fov=60.0,
                 z_near=5.0, z_far=8.0, tex_scale=60.0):
        self.w, self.h = width, height
        self.z_near, self.z_far = z_near, z_far
        self.tex_scale = tex_scale
        self.tex_a = make_texture(rng)
        self.tex_b = make_texture(rng)
        f = (min(width, height) / 2.0) / np.tan(np.deg2rad(fov) / 2.0)
        self.fx = self.fy = f
        self.cx, self.cy = width / 2.0, height / 2.0
        self.fov = fov

    def _sample(self, tex, u, v):
        n = tex.shape[0]
        u = np.mod(u * self.tex_scale, n - 1.001)
        v = np.mod(v * self.tex_scale, n - 1.001)
        u0, v0 = u.astype(int), v.astype(int)
        fu, fv = u - u0, v - v0
        return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u0 + 1] * (1 - fv) * fu
                + tex[v0 + 1, u0] * fv * (1 - fu) + tex[v0 + 1, u0 + 1] * fv * fu)

    def render(self, T_wc: np.ndarray) -> np.ndarray:
        """Render the scene from camera-to-world pose T_wc (4x4)."""
        yy, xx = np.mgrid[0:self.h, 0:self.w]
        d_cam = np.stack([(xx - self.cx) / self.fx,
                          (yy - self.cy) / self.fy,
                          np.ones_like(xx, np.float32)], axis=-1)
        R, t = T_wc[:3, :3], T_wc[:3, 3]
        d_w = d_cam @ R.T
        o_w = t
        img = np.full((self.h, self.w), 50.0, np.float32)
        dz = d_w[..., 2]
        dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        t_near = (self.z_near - o_w[2]) / dz
        p_near = o_w + d_w * t_near[..., None]
        use_near = (t_near > 0.1) & (p_near[..., 0] < 0)
        t_far = (self.z_far - o_w[2]) / dz
        p_far = o_w + d_w * t_far[..., None]
        use_far = (t_far > 0.1) & ~use_near
        img = np.where(use_near,
                       self._sample(self.tex_a, p_near[..., 0], p_near[..., 1]), img)
        img = np.where(use_far,
                       self._sample(self.tex_b, p_far[..., 0], p_far[..., 1]), img)
        return img


def _rodrigues(phi: np.ndarray) -> np.ndarray:
    """Axis-angle [n, 3] → rotation matrices [n, 3, 3], float64."""
    theta = np.linalg.norm(phi, axis=-1)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = phi / safe[:, None]
    K = np.zeros((len(phi), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return np.eye(3)[None] + s * K + (1.0 - c) * (K @ K)


def trajectory(n_frames, step=0.02, rot_step=0.002):
    """Sideways-dominant trajectory; returns [n, 4, 4] float32 T_wc poses."""
    i = np.arange(n_frames, dtype=np.float64)
    z = np.zeros(n_frames, np.float64)
    phis = np.stack([z, rot_step * i, z], axis=-1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    T[:, :3, :3] = _rodrigues(phis.astype(np.float64)).astype(np.float32)
    T[:, :3, 3] = np.stack(
        [step * i, 0.3 * step * i, 0.05 * step * i], axis=-1).astype(np.float32)
    return T


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error after similarity (sim3) alignment."""
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    e, g = est_t - mu_e, gt_t - mu_g
    cov = g.T @ e / len(e)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var_e = (e * e).sum() / len(e)
    s = np.trace(np.diag(S) @ D) / max(var_e, 1e-12)
    aligned = s * e @ R.T + mu_g
    return float(np.sqrt(((aligned - gt_t) ** 2).sum(axis=1).mean()))
