"""Port parity of the KLT level pass (the module that holds the CUDA
kernel): ``lk_level_plain`` against the JAX package's ``_lk_level`` on its
XLA path and on its Pallas kernel in interpret mode, the CPU dispatch of
the ``lk_level`` wrapper, and ``fb_klt_track`` as a whole.  The CUDA
kernel itself is compared with ``lk_level_plain`` on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.ops import klt as jklt
from alvaar_tpu.ops.image import bilinear_sample, build_pyramid as jpyr
from alvaar_tpu.ops.pallas import lk_kernel
from alvaar_tpu_torch.ops import klt as tklt
from alvaar_tpu_torch.ops import lk_level as tlk
from alvaar_tpu_torch.ops.image import build_pyramid as tpyr
from tests.test_image_ops import smooth_noise

# the bars of tests/test_pallas_klt.py
XY_ATOL, ERR_ATOL = 1e-4, 1e-4

# (search_r, iters): the default, and every pair the main path uses
CASES = [(8, 20), (4, 16), (8, 16), (2, 12)]


def _pair(rng, h=120, w=160, shift=(1.3, -0.8)):
    """tests/test_pallas_klt.py:14-20: a smooth image and its sub-pixel
    shift, and 32 points inside."""
    img0 = smooth_noise(rng, h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    xy = np.stack([xx + shift[0], yy + shift[1]], -1).astype(np.float32)
    img1 = np.asarray(bilinear_sample(jnp.asarray(img0), jnp.asarray(xy.reshape(-1, 2)))
                      ).reshape(h, w)
    pts = rng.uniform([20, 20], [w - 20, h - 20], (32, 2)).astype(np.float32)
    return img0, img1, pts


def _inputs(rng, search_r):
    img0, img1, pts = _pair(rng)
    # guesses off by up to the volume radius, some invalid slots
    guess = (pts + rng.uniform(-0.6, 0.6, pts.shape) * (search_r - 1)).astype(np.float32)
    valid = np.ones(32, bool)
    valid[::9] = False
    return img0, img1, pts, guess, valid


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_level(t_out, j_out):
    xy_t, ok_t, err_t = (a.numpy() for a in t_out)
    xy_j, ok_j, err_j = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(xy_t, xy_j, atol=XY_ATOL, rtol=0)
    np.testing.assert_allclose(err_t, err_j, atol=ERR_ATOL, rtol=0)
    assert ok_t.sum() > 0


@pytest.mark.parametrize("search_r,iters", CASES)
def test_plain_matches_jax_xla(rng, search_r, iters):
    img0, img1, pts, guess, valid = _inputs(rng, search_r)
    j = jklt._lk_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                       jnp.asarray(guess), jnp.asarray(valid), win=9, iters=iters,
                       eps=0.01, search_r=search_r, use_pallas=False)
    t = tlk.lk_level_plain(*_torch(img0, img1, pts, guess, valid), win=9,
                           iters=iters, eps=0.01, search_r=search_r)
    _assert_level(t, j)


@pytest.mark.parametrize("search_r,iters", CASES)
def test_plain_matches_pallas_interpret(rng, monkeypatch, search_r, iters):
    orig = lk_kernel.lk_level_pallas

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(lk_kernel, "lk_level_pallas", interp)
    img0, img1, pts, guess, valid = _inputs(rng, search_r)
    j = jklt._lk_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                       jnp.asarray(guess), jnp.asarray(valid), win=9, iters=iters,
                       eps=0.01, search_r=search_r, use_pallas=True)
    t = tlk.lk_level_plain(*_torch(img0, img1, pts, guess, valid), win=9,
                           iters=iters, eps=0.01, search_r=search_r)
    _assert_level(t, j)


def test_wrapper_runs_plain_on_cpu(rng):
    img0, img1, pts, guess, valid = _torch(*_inputs(rng, 4))
    before = tlk.lk_level.launches
    a = tlk.lk_level(img0, img1, pts, guess, valid, win=9, iters=16, eps=0.01, search_r=4)
    b = tlk.lk_level_plain(img0, img1, pts, guess, valid, win=9, iters=16, eps=0.01,
                           search_r=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tlk.lk_level.launches == before      # no kernel launch on the CPU


def test_wrapper_refuses_other_devices(rng):
    img0, img1, pts, guess, valid = (t.to("meta") for t in _torch(*_inputs(rng, 4)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlk.lk_level(img0, img1, pts, guess, valid, win=9, iters=16, eps=0.01)


@pytest.mark.parametrize("levels,search_r", [(1, 4), (3, 8)])
def test_fb_klt_track_matches_jax(rng, levels, search_r):
    img0, img1, pts = _pair(rng, 240, 320, shift=(2.6, -1.7))
    valid = np.ones(len(pts), bool)
    valid[5] = False
    # the content moves by -shift; the prior is off the truth by ~0.5 px
    prior = (pts + np.float32([-2.2, 1.4])).astype(np.float32)
    args = dict(levels=levels, win=9, iters=16, eps=0.01, err_max=30.0,
                fb_dist=0.5, search_r=search_r)
    j = jklt.fb_klt_track(jpyr(jnp.asarray(img0), 3), jpyr(jnp.asarray(img1), 3),
                          jnp.asarray(pts), jnp.asarray(prior), jnp.asarray(valid),
                          use_pallas=False, **args)
    t0, t1, tp, tq, tv = _torch(img0, img1, pts, prior, valid)
    t = tklt.fb_klt_track(tpyr(t0, 3), tpyr(t1, 3), tp, tq, tv, **args)
    _assert_level((t.xy, t.status, t.err), (j.xy, j.status, j.err))
