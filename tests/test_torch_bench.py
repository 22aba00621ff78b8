"""The port's bench (alvaar_tpu_torch/bench.py) on the CPU, at small sizes.

* The metric names it can emit equal bench.py's, read from bench.py's
  text (bench.py imports the JAX package, so it is not imported here).
* ``main`` runs once end to end: B = 2 streams of 14 frames at 320x240
  (tests/test_torch_slice.py's cut, with a 6 px bootstrap parallax so
  every stream tracks 10 frames), a 320x180 ``hd_serving`` cut, BA at a
  4-keyframe window and 128 landmarks, 16-entry loop databases, one timed
  call per latency stage.  Every stage function is recorded as ``main``
  calls it: each returns finite numbers, and the reps of every end-to-end
  stage, each from a fresh state, give bit-equal statuses and poses.
  Stdout holds exactly two bare-JSON lines, equal, the last line one of
  them; every stderr ``aux`` line is JSON with metric, value and unit.
* The loop stage's own check fails a run that does not track; a stage
  that raises makes ``main`` exit 1 after the headline; ``main`` raises
  without CUDA; the video stage skips without the video, and its scoring
  runs on a recorded reference run.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from alvaar_tpu_torch import bench
from alvaar_tpu_torch.config import SlamConfig, hd_serving
from alvaar_tpu_torch.geom.camera import Camera

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 2, 14
CUT = dict(window_size=10, max_landmarks=512, ransac_iters=50, ba_iters=4,
           init_parallax_px=6.0, use_five_point=False, use_homography_init=False)
SMALL = bench.Workloads(
    cfg=SlamConfig(width=320, height=240, cell_size=24, **CUT),
    hd_cfg=dataclasses.replace(hd_serving(320, 180), **CUT), hd_streams=2, hd_frames=4,
    ba_cfg=SlamConfig(width=320, height=240, cell_size=24, window_size=4, max_landmarks=128),
    loop_capacity=16, loop_kps=64)
FEW_CALLS = dict(WARMUP_STEPS=2, TIMED_CALLS=1, TIMED_ROUNDS=1, BA_CALLS=1, BA_ROUNDS=1)
E2E_STAGES = ("bench_multistream", "bench_multistream_loop", "bench_single",
              "bench_1080p_streams")
# each stage's numbers among its return values (rep outputs and staged frames left out)
STAGE_NUMBERS = {
    "bench_multistream": lambda r: r[:4],
    "bench_multistream_loop": lambda r: r[:2] + tuple(r[2]),
    "bench_single": lambda r: r[:4],
    "bench_ba_10k": lambda r: r,
    "bench_1080p_streams": lambda r: r[:1],
    "bench_plane_720p": lambda r: r[:2],
    "bench_loop_closure": lambda r: r[:1],
}
_METRIC = re.compile(r'aux\(\s*"([a-z0-9_]+)"|"metric":\s*"([a-z0-9_]+)"')


def _metric_names(path):
    with open(path) as fh:
        return {a or b for a, b in _METRIC.findall(fh.read())}


def _bare_json(line):
    try:
        return isinstance(json.loads(line), dict)
    except ValueError:
        return False


def _run_main(argv, home, patches=()):
    """``main`` on the CPU at the small sizes, with bench.py's timing cut to
    one call; returns (exit status, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        for k, v in list(FEW_CALLS.items()) + list(patches):
            mp.setattr(bench, k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(argv, workloads=SMALL, device="cpu")
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """One end-to-end ``main`` with every stage function's return value
    recorded."""
    calls = {}

    def spy(name):
        fn = getattr(bench, name)

        def call(*a, **kw):
            calls[name] = fn(*a, **kw)
            return calls[name]
        return name, call

    rc, out, err = _run_main(["--streams", str(B), "--frames", str(N)],
                             tmp_path_factory.mktemp("home"),
                             [spy(name) for name in STAGE_NUMBERS])
    return rc, out, err, calls


def test_metric_names_equal_bench_py():
    ours = _metric_names(bench.__file__)
    theirs = _metric_names(os.path.join(ROOT, "bench.py"))
    assert "multistream_fps_per_chip_640x480" in theirs and len(theirs) > 10
    assert ours == theirs, (ours ^ theirs)


@pytest.mark.parametrize("name", sorted(STAGE_NUMBERS))
def test_stage_returns_finite_numbers(small_run, name):
    rc, _, err, calls = small_run
    assert rc == 0, err[-3000:]
    numbers = STAGE_NUMBERS[name](calls[name])
    assert numbers and all(math.isfinite(float(x)) for x in numbers), (name, numbers)
    if name == "bench_multistream_loop":
        assert calls[name][1] >= N // 3 and min(calls[name][2]) >= 2
    if name == "bench_plane_720p":
        assert calls[name][2] is True
    if name == "bench_loop_closure":
        assert calls[name][1] is True


@pytest.mark.parametrize("name", E2E_STAGES)
def test_reps_from_fresh_states_are_bit_equal(small_run, name):
    reps = small_run[3][name][-1]
    assert len(reps) >= 2
    for statuses, poses in reps:
        assert np.isfinite(poses).all()
        assert statuses.tobytes() == reps[0][0].tobytes()
        assert poses.tobytes() == reps[0][1].tobytes()
    if name != "bench_1080p_streams":      # 4 frames there: no stream bootstraps
        # the streams did track: the reps compare real trajectories
        assert (reps[0][0] == 1).any()


def test_main_output_contract(small_run):
    rc, out, err, _ = small_run
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    heads = [ln for ln in lines if _bare_json(ln)]
    assert len(heads) == 2 and heads[0] == heads[1] and lines[-1] == heads[1]
    head = json.loads(heads[1])
    assert head["metric"] == "multistream_fps_per_chip_640x480" and head["unit"] == "frames/sec"
    assert math.isfinite(head["value"]) and head["value"] > 0
    assert head["vs_baseline"] == round(head["value"] / 500.0, 4)
    errs = err.splitlines()
    assert not any(_bare_json(ln) for ln in errs)
    seen = set()
    for ln in errs:
        if ln.startswith("aux "):
            rec = json.loads(ln[4:])
            assert {"metric", "value", "unit"} <= set(rec), ln
            seen.add(rec["metric"])
    # every metric but the video stages' (no video in the repository) and
    # ate_vs_reference_synthetic: the reference runs first track at frame
    # 18, after these 14 frames, so it has no score to print
    assert seen == {m for m in _metric_names(bench.__file__)
                    if "video" not in m and m not in ("multistream_fps_per_chip_640x480",
                                                      "ate_vs_reference_synthetic")}
    assert "FAIL" not in err


def test_loop_stage_fails_a_run_that_does_not_track(monkeypatch):
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    cfg = SMALL.cfg
    blank = torch.full((3, B, cfg.height, cfg.width), 50.0)
    with pytest.raises(AssertionError, match="tracks only"):
        bench.bench_multistream_loop(cfg, Camera.from_fov(cfg.width, cfg.height, 60.0), blank,
                                     torch.ones(3, B), 3, capacity=4, device="cpu")


def test_a_failed_stage_makes_main_exit_nonzero(tmp_path):
    frames = torch.zeros(N, B, 1, 1)

    def boom(*a, **kw):
        raise RuntimeError("forced failure")

    fakes = [
        ("bench_multistream", lambda *a, **kw: (10.0, 0.01, N, N, frames, torch.ones(N, B), [])),
        ("bench_multistream_loop", boom),
        ("bench_single", lambda *a, **kw: (5.0, 0.01, N, 0.01, [])),
        ("bench_ba_10k", lambda *a, **kw: (1.0, 1.0)),
        ("bench_1080p_streams", lambda *a, **kw: (5.0, [])),
        ("bench_real_video", lambda *a, **kw: None),
        ("bench_plane_720p", lambda *a, **kw: (1.0, 1.0, True)),
        ("bench_loop_closure", lambda *a, **kw: (1.0, True)),
    ]
    rc, out, err = _run_main(["--streams", str(B), "--frames", str(N)], tmp_path, fakes)
    assert rc == 1
    assert "FAIL multistream_loop: RuntimeError: forced failure" in err
    lines = out.strip().splitlines()
    assert [ln for ln in lines if _bare_json(ln)] == [lines[-1], lines[-1]]
    # the stages after the failed one still ran
    assert '"metric": "loop_query_latency_256kf"' in err


def test_video_stage_skips_without_the_video(tmp_path):
    assert bench.bench_real_video(path=str(tmp_path / "video.mp4"), device="cpu") is None


def test_video_is_read_only_from_the_repository():
    assert os.path.commonpath([bench.REFERENCE_VIDEO, ROOT]) == ROOT


def test_reps_that_differ_fail_the_stage():
    """The fresh-state rule is a check: reps whose poses differ raise."""
    poses = iter([torch.zeros(3), torch.zeros(3), torch.zeros(3), torch.ones(3)])
    run = lambda state: (state, (torch.ones(3), next(poses)))
    wall, outs, _ = bench._timed_reps(lambda: None, run, 2, "cpu")
    assert len(outs) == 2 and wall >= 0
    with pytest.raises(AssertionError, match="differ"):
        bench._timed_reps(lambda: None, run, 2, "cpu")


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_video_parity_metrics_on_a_reference_run(capsys):
    """The video stage's scoring, on one of the recorded reference runs
    of tests/golden/ref_video.npz in place of the port's (the video is not
    in the repository): its aux lines, and parity with the reference."""
    g = np.load(os.path.join(ROOT, "tests", "golden", "ref_video.npz"))
    par = bench.ate_vs_reference_video(g["poses"][3], g["status"][3])
    assert par["parity_pass"] and par["ate_pct"] < par["ref_noise_pct"]
    recs = [json.loads(ln[4:]) for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("aux ")]
    assert [r["metric"] for r in recs] == ["ate_vs_reference_video_noise_floor",
                                           "rpe_vs_reference_video_rot",
                                           "video_parity_windows"]
    assert all(math.isfinite(r["value"]) for r in recs)
