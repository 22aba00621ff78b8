"""The port's host utilities (alvaar_tpu_torch/utils: parity, stats, view)
against the JAX package's modules on the same numpy inputs, on the CPU.

* Parity: ``sim3_align_ate``, ``rpe_rmse``, ``windowed_parity`` and
  ``ate_vs_reference`` on seeded trajectories and on the reference runs
  of tests/golden/ref_synthetic_640.npz (rtol 1e-12).
* Stats: stage timers, their window and summary; ``count`` adds up
  exactly from many threads.
* View: ``draw_points`` and ``project_axes`` equal to JAX's;
  ``render_map`` where matplotlib is installed.
"""

import sys
import threading
import time

import numpy as np
import pytest

from alvaar_tpu.utils import parity as jpar
from alvaar_tpu.utils import stats as jstats
from alvaar_tpu.utils import view as jview
from alvaar_tpu_torch.utils import parity as tpar
from alvaar_tpu_torch.utils import stats as tstats
from alvaar_tpu_torch.utils import view as tview
from tests.render_scene_np import ate_rmse

GOLDEN = "ref_synthetic_640.npz"


def _close(a, b):
    """Two parity results equal to rtol 1e-12 (dicts, tuples, floats)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, (bool, np.bool_, int, np.integer)) or a is None:
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def _perturbed(poses, rng, noise):
    """T_wc poses with the translations scaled, rotated, shifted and
    jittered (sim3 alignment undoes all but the jitter)."""
    out = np.array(poses, np.float64)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    out[:, :3, 3] = 2.5 * out[:, :3, 3] @ R.T + np.array([1.0, -2.0, 0.5]) \
        + rng.normal(scale=noise, size=(len(out), 3))
    return out


def test_golden_dir_and_loader():
    assert tpar.GOLDEN_DIR == jpar.GOLDEN_DIR
    a, b = tpar.load_golden(GOLDEN), jpar.load_golden(GOLDEN)
    assert set(a.files) == set(b.files)
    np.testing.assert_array_equal(a["poses"], b["poses"])
    assert tpar.load_golden("absent.npz") is None


@pytest.mark.parametrize("seed", range(3))
def test_sim3_ate_and_rpe_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt = np.load(f"{tpar.GOLDEN_DIR}/{GOLDEN}")["gt"][:60]
    est = _perturbed(gt, rng, noise=0.01 * (seed + 1))
    a = tpar.sim3_align_ate(est[:, :3, 3], gt[:, :3, 3])
    _close(a, jpar.sim3_align_ate(est[:, :3, 3], gt[:, :3, 3]))
    assert a == ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    for delta in (1, 5):
        _close(tpar.rpe_rmse(est, gt, delta=delta), jpar.rpe_rmse(est, gt, delta=delta))
    _close(tpar.rpe_rmse(est, gt, scale=0.4), jpar.rpe_rmse(est, gt, scale=0.4))
    nan = tpar.rpe_rmse(est[:1], gt[:1])
    assert np.isnan(nan["trans_rmse"]) and set(nan) == set(jpar.rpe_rmse(est[:1], gt[:1]))


@pytest.mark.parametrize("run,noise", [(0, 0.0), (3, 0.002), (7, 0.05)])
def test_ate_vs_reference_matches_jax(run, noise):
    g = tpar.load_golden(GOLDEN)
    status = np.array(g["status"][run])
    status[::11] = 3                                     # a few untracked frames
    poses = _perturbed(g["poses"][run], np.random.default_rng(run), noise)
    a = tpar.ate_vs_reference(status, poses, GOLDEN)
    _close(a, jpar.ate_vs_reference(status, poses, GOLDEN))
    assert a["n_ref_runs"] == 10 and a["overlap"] >= 10
    if noise == 0.0:
        assert a["ate_pct"] < 1e-6 and a["parity_pass"]
    w = tpar.windowed_parity(status, poses, GOLDEN, window=40)
    _close(w, jpar.windowed_parity(status, poses, GOLDEN, window=40))
    assert tpar.ate_vs_reference(status, poses, "absent.npz") is None
    assert tpar.ate_vs_reference(np.zeros_like(status), poses, GOLDEN) is None


def test_stats_timers():
    s = tstats.Stats(window=3)
    for _ in range(5):
        with s.timeit("ring"):
            pass
        s.start("step")
        time.sleep(0.001)
        dt = s.stop("step")
    assert dt >= 1.0 and s.stages["step"].last_ms == dt
    assert len(s.stages["ring"].samples) == 3 and s.stages["step"].avg_ms >= 1.0
    assert list(s.stages) == ["ring", "step"]
    assert s.summary().startswith("ring: ") and " | step: " in s.summary()
    j = jstats.Stats(window=3)
    j.add("ring")
    assert type(j.stages["ring"]).__name__ == type(s.stages["ring"]).__name__
    assert tstats.StageTimer().avg_ms == tstats.StageTimer().last_ms == 0.0


def test_count_is_exact_across_threads():
    def fn():
        pass
    fn.calls = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [tstats.count(fn, "calls") for _ in range(2000)])
              for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fn.calls == 16 * 2000


def test_view_overlays_match_jax(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    pts = np.array([[10, 10], [60, 40], [0, 47], [99, 99], [-3, 5], [63, 0]])
    for radius in (1, 2, 4):
        np.testing.assert_array_equal(tview.draw_points(img, pts, radius=radius, value=7.0),
                                      jview.draw_points(img, pts, radius=radius, value=7.0))
    for T in (np.eye(4), np.load(f"{tpar.GOLDEN_DIR}/{GOLDEN}")["gt"][40]):
        np.testing.assert_array_equal(tview.project_axes(T, 500.0, 480.0, 320.0, 240.0, 0.3),
                                      jview.project_axes(T, 500.0, 480.0, 320.0, 240.0, 0.3))


def test_render_map_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    out = tview.render_map(rng.normal(size=(50, 3)), rng.uniform(0, 255, 50),
                           trajectory=[np.eye(4), np.eye(4)], path=str(tmp_path / "m.png"))
    assert (tmp_path / "m.png").stat().st_size > 1000 and out.endswith("m.png")
