"""Port parity of the KLT (the modules that hold the CUDA kernel):
``lk_level_plain`` against the JAX package's ``_lk_level`` on its XLA path
and on its Pallas kernel in interpret mode, the CPU dispatch of the
``lk_level``, ``klt_pyramidal`` and ``fb_klt_track`` wrappers, the
schedules the wrappers hand to the kernel against the plain composition's
level calls, the wrappers' refusals, and ``klt_pyramidal`` and
``fb_klt_track`` as a whole.  The CUDA kernel itself is compared with
the plain composition on the card by chip_smoke.py."""

import math

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


# stage 1, hd_serving's stage 2 (2 levels from base level 1), stage 2
@pytest.mark.parametrize("levels,search_r", [(1, 4), (2, 8), (3, 8)])
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


@pytest.mark.parametrize("levels,search_r", [(1, 4), (3, 8)])
def test_klt_pyramidal_matches_jax(rng, levels, search_r):
    img0, img1, pts = _pair(rng, 240, 320, shift=(2.6, -1.7))
    valid = np.ones(len(pts), bool)
    valid[3] = False
    prior = (pts + np.float32([-2.2, 1.4])).astype(np.float32)
    args = dict(levels=levels, win=9, iters=16, eps=0.01, err_max=30.0, search_r=search_r)
    j = jklt.klt_pyramidal(jpyr(jnp.asarray(img0), 3), jpyr(jnp.asarray(img1), 3),
                           jnp.asarray(pts), jnp.asarray(prior), jnp.asarray(valid),
                           use_pallas=False, **args)
    t0, t1, tp, tq, tv = _torch(img0, img1, pts, prior, valid)
    t = tklt.klt_pyramidal(tpyr(t0, 3), tpyr(t1, 3), tp, tq, tv, **args)
    _assert_level((t.xy, t.status, t.err), (j.xy, j.status, j.err))


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_schedule_matches_klt_pyramidal(levels):
    """The passes the kernel runs are the level calls of the plain
    composition: level (from the image shape), radius, iterations and
    direction (the backward pass reads the current frame as its template)."""
    h, w = 96, 128
    mark = lambda frame: [torch.full((h >> l, w >> l), float(frame)) for l in range(levels)]
    pyr_prev, pyr_cur = mark(0), mark(1)
    pts = torch.full((4, 2), 40.0)
    valid = torch.ones(4, dtype=torch.bool)
    for search_r in range(2, 13):
        for iters in (12, 16, 30):
            calls = []

            def record(img_prev, img_cur, pts_prev, guess, valid, *, win, iters, eps,
                       search_r):
                calls.append((int(round(math.log2(w / img_cur.shape[1]))), search_r, iters,
                              bool(img_prev[0, 0] == 1)))
                return guess, valid, torch.zeros(len(valid))

            tklt.fb_klt_track(pyr_prev, pyr_cur, pts, pts, valid, levels=levels, win=9,
                              iters=iters, search_r=search_r, level_fn=record)
            assert tlk.klt_schedule(levels, search_r, iters) == calls
            calls.clear()
            tklt.klt_pyramidal(pyr_prev, pyr_cur, pts, pts, valid, levels=levels, win=9,
                               iters=iters, search_r=search_r, level_fn=record)
            assert tlk.klt_schedule(levels, search_r, iters, backward=False) == calls


def test_fb_klt_track_runs_plain_on_cpu(rng):
    img0, img1, pts = _pair(rng, 240, 320, shift=(2.6, -1.7))
    t0, t1, tp, tv = _torch(img0, img1, pts, np.ones(len(pts), bool))
    pyr0, pyr1 = tpyr(t0, 3), tpyr(t1, 3)
    before = tklt.fb_klt_track.launches
    a = tklt.fb_klt_track(pyr0, pyr1, tp, tp, tv, levels=3, win=9, iters=16)
    b = tklt.fb_klt_track(pyr0, pyr1, tp, tp, tv, levels=3, win=9, iters=16,
                          level_fn=tlk.lk_level_plain)
    for x, y in ((a.xy, b.xy), (a.status, b.status), (a.err, b.err)):
        assert torch.equal(x, y)
    assert tklt.fb_klt_track.launches == before  # no kernel launch on the CPU


def test_klt_pyramidal_runs_plain_on_cpu(rng):
    img0, img1, pts = _pair(rng, 240, 320, shift=(2.6, -1.7))
    t0, t1, tp, tv = _torch(img0, img1, pts, np.ones(len(pts), bool))
    pyr0, pyr1 = tpyr(t0, 3), tpyr(t1, 3)
    before = tklt.klt_pyramidal.launches
    a = tklt.klt_pyramidal(pyr0, pyr1, tp, tp, tv, levels=3, win=9, iters=16)
    b = tklt.klt_pyramidal(pyr0, pyr1, tp, tp, tv, levels=3, win=9, iters=16,
                           level_fn=tlk.lk_level_plain)
    for x, y in ((a.xy, b.xy), (a.status, b.status), (a.err, b.err)):
        assert torch.equal(x, y)
    assert int(a.status.sum()) > 20
    assert tklt.klt_pyramidal.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("case", ["meta", "meta_forward", "levels", "noncontiguous",
                                  "radius", "window"])
def test_fused_wrapper_refuses(rng, case):
    """What the kernel does not take is refused before any launch."""
    img0, img1, pts = _pair(rng, 240, 320)
    t0, t1, tp, tv = _torch(img0, img1, pts, np.ones(len(pts), bool))
    if case.startswith("meta"):
        m = lambda ts: [t.to("meta") for t in ts]
        fn = tklt.fb_klt_track if case == "meta" else tklt.klt_pyramidal
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(m(tpyr(t0, 3)), m(tpyr(t1, 3)), tp.to("meta"), tp.to("meta"), tv.to("meta"),
               levels=3)
        return
    pyr0, pyr1 = list(tpyr(t0, 5)), list(tpyr(t1, 5))
    levels, search_r, win = 3, 8, 9
    match = {"levels": "levels", "noncontiguous": "contiguous", "radius": "radii",
             "window": "win"}[case]
    if case == "levels":
        levels = tlk.LEVELS_MAX + 1
    elif case == "noncontiguous":
        pyr1[1] = pyr1[1].t().contiguous().t()
    elif case == "radius":
        search_r = tlk.R_MAX + 1
    else:
        win = tlk.WIN_MAX + 2
    with pytest.raises(ValueError, match=match):
        tlk.check_track_args(pyr0, pyr1, tp, tp, tv,
                             tlk.klt_schedule(levels, search_r, 16), win)
    pyr1[1] = pyr1[1].contiguous()
    tlk.check_track_args(pyr0, pyr1, tp, tp, tv, tlk.klt_schedule(3, 8, 16), 9)
