"""The numpy-only scene twin renders the same frames and poses as the
JAX-backed tests/render_scene.py."""

import numpy as np
import pytest

from tests import render_scene, render_scene_np


@pytest.mark.parametrize("n,step", [(40, 0.04), (165, 0.04)])
def test_trajectory_matches(n, step):
    np.testing.assert_allclose(render_scene_np.trajectory(n, step=step),
                               render_scene.trajectory(n, step=step), atol=1e-6)


def test_golden_ground_truth():
    from alvaar_tpu.utils.parity import GOLDEN_DIR
    import os
    g = np.load(os.path.join(GOLDEN_DIR, "ref_synthetic_640.npz"))
    n = int(g["n_frames"])
    np.testing.assert_allclose(render_scene_np.trajectory(n + 45, step=0.04)[:n],
                               g["gt"], atol=1e-6)


@pytest.mark.parametrize("seed,tex_scale", [(42, 60.0), (7, 120.0)])
def test_frames_match(seed, tex_scale):
    a = render_scene.TwoPlaneScene(np.random.default_rng(seed), 160, 120,
                                   fov=60.0, tex_scale=tex_scale)
    b = render_scene_np.TwoPlaneScene(np.random.default_rng(seed), 160, 120,
                                      fov=60.0, tex_scale=tex_scale)
    gt_j = render_scene.trajectory(12, step=0.04)
    gt_n = render_scene_np.trajectory(12, step=0.04)
    for i in (0, 5, 11):
        np.testing.assert_allclose(b.render(gt_n[i]), a.render(gt_j[i]), atol=1e-4)


def test_ate_rmse_matches():
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(30, 3))
    est = 2.0 * gt + rng.normal(scale=0.01, size=(30, 3))
    assert render_scene_np.ate_rmse(est, gt) == pytest.approx(
        render_scene.ate_rmse(est, gt), rel=1e-12)
