"""Port parity: geometry (lie, camera, triangulation) and image ops against
the JAX package on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.geom import camera as jcam
from alvaar_tpu.geom import lie as jlie
from alvaar_tpu.geom import triangulation as jtri
from alvaar_tpu.ops import image as jimg
from alvaar_tpu_torch.geom import camera as tcam
from alvaar_tpu_torch.geom import lie as tlie
from alvaar_tpu_torch.geom import triangulation as ttri
from alvaar_tpu_torch.ops import image as timg
from tests.test_image_ops import smooth_noise

GEOM_ATOL = 1e-5   # float32 geometry: a few ulp of O(1) values
IMG_ATOL = 1e-4    # 0..255 images: a few ulp of values up to ~1e3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t_out, j_out, atol):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol, rtol=0)


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rand_tangents(rng, n):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-5          # exercise the small-angle branches
    return xi


class TestLie:
    def test_quat_ops(self, rng):
        a, b = _rand_quats(rng, 16), _rand_quats(rng, 16)
        v = rng.normal(size=(16, 3)).astype(np.float32)
        _close(tlie.quat_mul(_t(a), _t(b)), jlie.quat_mul(jnp.asarray(a), jnp.asarray(b)), GEOM_ATOL)
        _close(tlie.quat_rotate(_t(a), _t(v)), jlie.quat_rotate(jnp.asarray(a), jnp.asarray(v)), GEOM_ATOL)
        _close(tlie.quat_to_matrix(_t(a)), jlie.quat_to_matrix(jnp.asarray(a)), GEOM_ATOL)
        R = np.asarray(jlie.quat_to_matrix(jnp.asarray(a)))
        _close(tlie.matrix_to_quat(_t(R)), jlie.matrix_to_quat(jnp.asarray(R)), GEOM_ATOL)

    def test_so3_exp_log(self, rng):
        phi = _rand_tangents(rng, 32)[:, 3:]
        _close(tlie.so3_exp(_t(phi)), jlie.so3_exp(jnp.asarray(phi)), GEOM_ATOL)
        q = _rand_quats(rng, 32)
        q[:4] = [1.0, 1e-5, -2e-5, 1e-6]
        _close(tlie.so3_log(_t(q)), jlie.so3_log(jnp.asarray(q)), GEOM_ATOL)

    def test_se3_group_ops(self, rng):
        xi_a, xi_b = _rand_tangents(rng, 24), _rand_tangents(rng, 24)
        x = rng.normal(size=(24, 3)).astype(np.float32)
        ja, jb = jlie.SE3.exp(jnp.asarray(xi_a)), jlie.SE3.exp(jnp.asarray(xi_b))
        ta, tb = tlie.SE3.exp(_t(xi_a)), tlie.SE3.exp(_t(xi_b))
        _close(ta.q, ja.q, GEOM_ATOL)
        _close(ta.t, ja.t, GEOM_ATOL)
        _close(ta.log(), ja.log(), GEOM_ATOL)
        c_t, c_j = ta.compose(tb), ja.compose(jb)
        _close(c_t.q, c_j.q, GEOM_ATOL)
        _close(c_t.t, c_j.t, GEOM_ATOL)
        _close(ta.inverse().t, ja.inverse().t, GEOM_ATOL)
        _close(ta.apply(_t(x)), ja.apply(jnp.asarray(x)), GEOM_ATOL)
        _close(ta.matrix(), ja.matrix(), GEOM_ATOL)
        _close(ta.retract(_t(xi_b)).t, ja.retract(jnp.asarray(xi_b)).t, GEOM_ATOL)


DIST = dict(k1=-0.12, k2=0.03, p1=1e-3, p2=-2e-3)


class TestCamera:
    @pytest.mark.parametrize("dist", [False, True], ids=["pinhole", "radtan"])
    def test_projection_chain(self, rng, dist):
        jc = jcam.Camera.from_fov(320, 240, 60.0)
        tc = tcam.Camera.from_fov(320, 240, 60.0)
        assert (tc.fx, tc.fy, tc.cx, tc.cy) == pytest.approx(
            (float(jc.fx), float(jc.fy), float(jc.cx), float(jc.cy)), rel=1e-7)
        if dist:
            jc = jcam.Camera.create(jc.fx, jc.fy, jc.cx, jc.cy, **DIST)
            tc = tcam.Camera.create(tc.fx, tc.fy, tc.cx, tc.cy, **DIST)
        X = rng.uniform([-2, -2, 2], [2, 2, 8], (64, 3)).astype(np.float32)
        jX = jnp.asarray(X)
        _close(tc.project(_t(X)), jc.project(jX), 1e-3)          # pixels
        pd = np.asarray(jc.project_dist(jX))
        _close(tc.project_dist(_t(X)), pd, 1e-3)
        _close(tc.undistort(_t(pd)), jc.undistort(jnp.asarray(pd)), 1e-3)
        _close(tc.bearing(_t(pd)), jc.bearing(jnp.asarray(pd)), GEOM_ATOL)
        np.testing.assert_array_equal(
            tc.in_roi(_t(pd), 320, 240, border=20).numpy(),
            np.asarray(jc.in_roi(jnp.asarray(pd), 320, 240, border=20)))


def test_triangulation(rng):
    xi = _rand_tangents(rng, 1)[0] * 0.2
    f0 = rng.normal(size=(40, 3)).astype(np.float32) * [0.3, 0.3, 0.0] + [0, 0, 1]
    f0 = (f0 / np.linalg.norm(f0, axis=-1, keepdims=True)).astype(np.float32)
    f1 = rng.normal(size=(40, 3)).astype(np.float32) * [0.3, 0.3, 0.0] + [0, 0, 1]
    f1 = (f1 / np.linalg.norm(f1, axis=-1, keepdims=True)).astype(np.float32)
    jp, tp = jlie.SE3.exp(jnp.asarray(xi)), tlie.SE3.exp(_t(xi))
    jx, jd0, jd1 = jtri.triangulation_depths(jp, jnp.asarray(f0), jnp.asarray(f1))
    tx, td0, td1 = ttri.triangulation_depths(tp, _t(f0), _t(f1))
    scale = float(np.abs(np.asarray(jx)).max())
    for a, b in ((tx, jx), (td0, jd0), (td1, jd1)):
        _close(a, b, GEOM_ATOL * max(scale, 1.0))


class TestImage:
    def test_rgba_to_gray(self, rng):
        frame = rng.integers(0, 256, (24, 32, 4)).astype(np.uint8)
        _close(timg.rgba_to_gray(torch.from_numpy(frame)),
               jimg.rgba_to_gray(jnp.asarray(frame)), IMG_ATOL)

    @pytest.mark.parametrize("shape", [(120, 160), (61, 83)])
    def test_pyramid_and_stencils(self, rng, shape):
        img = smooth_noise(rng, *shape)
        jp = jimg.build_pyramid(jnp.asarray(img), 3)
        tp = timg.build_pyramid(_t(img), 3)
        for a, b in zip(tp, jp):
            assert tuple(a.shape) == b.shape
            _close(a, b, IMG_ATOL)
        _close(timg.gaussian_blur3(_t(img)), jimg.gaussian_blur3(jnp.asarray(img)), IMG_ATOL)
        for a, b in zip(timg.sobel_gradients(_t(img)), jimg.sobel_gradients(jnp.asarray(img))):
            _close(a, b, IMG_ATOL)

    def test_bilinear_sample(self, rng):
        img = smooth_noise(rng, 40, 50)
        xy = rng.uniform(-3, 55, (200, 2)).astype(np.float32)
        _close(timg.bilinear_sample(_t(img), _t(xy)),
               jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)), IMG_ATOL)

    @pytest.mark.parametrize("size,lo", [(12, 5), (25, 12), (36, 17), (3, 1)])
    def test_gather_patches_equals_extract_patches_pl(self, rng, size, lo):
        img = smooth_noise(rng, 90, 110)
        n = 37
        base = np.stack([rng.integers(lo, 110 - size + lo + 1, n),
                         rng.integers(lo, 90 - size + lo + 1, n)], 1).astype(np.int32)
        j = np.asarray(jimg.extract_patches_pl(jnp.asarray(img), jnp.asarray(base), size, lo))
        t = timg.gather_patches(_t(img), torch.from_numpy(base).long(), size, lo)
        np.testing.assert_array_equal(t.numpy(), np.transpose(j, (2, 0, 1)))
