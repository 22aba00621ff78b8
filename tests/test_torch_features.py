"""Port parity of the keyframe features against the JAX package: grid
Shi-Tomasi detection, ORB descriptors (bit for bit) and Hamming
distances (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.ops import detect as jdet
from alvaar_tpu.ops import hamming as jham
from alvaar_tpu.ops import orb as jorb
from alvaar_tpu_torch.ops import detect as tdet
from alvaar_tpu_torch.ops import hamming as tham
from alvaar_tpu_torch.ops import orb as torb
from tests.render_scene_np import TwoPlaneScene, trajectory
from tests.test_image_ops import smooth_noise


def _t(a):
    return torch.from_numpy(np.array(a))


def _frame(seed=42, w=320, h=240):
    scene = TwoPlaneScene(np.random.default_rng(seed), w, h, fov=60.0)
    return scene.render(trajectory(3, step=0.04)[1]).astype(np.float32)


def _u32(desc_t):
    return desc_t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_existing", [0, 40])
def test_detect_grid_equal(rng, n_existing):
    img = _frame()
    ex = rng.uniform([10, 10], [310, 230], (max(n_existing, 1), 2)).astype(np.float32)
    exv = np.arange(len(ex)) < n_existing
    args = dict(cell=24, border=20, quality=0.001)
    j = jdet.detect_grid(jnp.asarray(img), jnp.asarray(ex), jnp.asarray(exv), **args)
    t = tdet.detect_grid(_t(img), _t(ex), _t(exv), **args)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_allclose(t.xy.numpy()[jv], np.asarray(j.xy)[jv], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score), rtol=1e-4, atol=1e-9)
    assert float(t.new_quality) == pytest.approx(float(j.new_quality), rel=1e-6)
    assert jv.sum() > 50


def test_shi_tomasi_response(rng):
    img = smooth_noise(rng, 96, 128)
    j = np.asarray(jdet.shi_tomasi_response(jnp.asarray(img)))
    t = tdet.shi_tomasi_response(_t(img)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("blur", [True, False])
def test_describe_equal_bits(rng, blur):
    img = _frame(seed=5)
    xy = rng.uniform([5, 5], [315, 235], (96, 2)).astype(np.float32)
    valid = rng.random(96) < 0.9
    jd, ja = jorb.describe(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid), blur=blur)
    td, ta = torb.describe(_t(img), _t(xy), _t(valid), blur=blur)
    # the moments are 961-term sums taken in another order: angles agree
    # to ~1e-5 rad, far inside the 2π/30 steering bins
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_array_equal(_u32(td), np.asarray(jd))


def test_ic_angle(rng):
    img = smooth_noise(rng, 100, 120)
    xy = rng.uniform([0, 0], [120, 100], (40, 2)).astype(np.float32)
    np.testing.assert_allclose(torb.ic_angle(_t(img), _t(xy)).numpy(),
                               np.asarray(jorb.ic_angle(jnp.asarray(img), jnp.asarray(xy))),
                               atol=1e-4)


def _descs(rng, *shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def test_hamming_matrix_and_rowwise(rng):
    a, b = _descs(rng, 33, 8), _descs(rng, 21, 8)
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    j = np.asarray(jham.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tham.hamming_matrix(ta, tb).numpy(), j)
    np.testing.assert_array_equal(
        tham.hamming_matrix(ta, tb).numpy(),
        np.asarray(jham.hamming_matrix_matmul(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tham.hamming_rowwise(ta, ta.flip(0)).numpy(),
        np.asarray(jham.hamming_rowwise(jnp.asarray(a), jnp.asarray(a[::-1]))))


def test_hamming_min_crossbag(rng):
    ga, gb = _descs(rng, 17, 6, 8), _descs(rng, 13, 6, 8)
    fa, fb = rng.random((17, 6)) < 0.7, rng.random((13, 6)) < 0.7
    fa[0] = False                       # an empty bag
    j = np.asarray(jham.hamming_min_crossbag(jnp.asarray(ga), jnp.asarray(fa),
                                             jnp.asarray(gb), jnp.asarray(fb)))
    t = tham.hamming_min_crossbag(_t(ga.view(np.int32)), _t(fa),
                                  _t(gb.view(np.int32)), _t(fb))
    np.testing.assert_array_equal(t.numpy(), j)


def test_best_two(rng):
    d = rng.integers(0, 40, (12, 30)).astype(np.float32)      # many ties
    cols = rng.random(30) < 0.8
    jb, js, ji = jham.best_two(jnp.asarray(d), jnp.asarray(cols))
    tb, ts, ti = tham.best_two(_t(d), _t(cols))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
