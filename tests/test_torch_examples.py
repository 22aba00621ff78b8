"""The JAX package's five examples on the port
(alvaar_tpu_torch/examples/), on the CPU at cut sizes.

Each example's ``main`` runs with the JAX script's arguments and prints
its lines; the sizes are cut through ``main``'s keyword arguments:
320x240 frames under the port tests' 320x240 configuration (24 px cells,
a 10-keyframe window, 512 landmarks, 50 hypotheses, 4 BA iterations,
``init_parallax_px`` 12) instead of 640x480 under ``SlamConfig()``,
whose 40 px cells leave 48 keypoints at 320x240, under
``min_init_keypoints``, so every frame would reset.
"""

import dataclasses
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from alvaar_tpu_torch import SlamConfig
from alvaar_tpu_torch.examples import (ROOT, demo, imu_demo, live_client, preproc_sandbox,
                                       video_demo)
from tests.test_torch_bootstrap import CFG_ARGS

# one intra-op thread: the suite runs in several worker processes
torch.set_num_threads(1)

W, H = 320, 240
CFG = SlamConfig(**dict(CFG_ARGS, init_parallax_px=12.0))
CUT = dict(device="cpu", width=W, height=H, config=CFG)
N_FRAMES = 24


def _statuses(lines, pattern):
    return [int(m.group(1)) for m in map(re.compile(pattern).search, lines) if m]


def test_demo(capsys):
    assert demo.main([str(N_FRAMES)], **CUT) == 0
    lines = capsys.readouterr().out.splitlines()
    st = _statuses(lines, r"^frame +\d+: status (\d)")
    assert len(st) == N_FRAMES and st[0] == 3
    assert st.count(1) >= 5, st
    pos = [ln for ln in lines if "status 1" in ln]
    assert all(re.search(r"pos \[[-+]\d+\.\d{3} [-+]\d+\.\d{3} [-+]\d+\.\d{3}\]  \d+ pts$", ln)
               for ln in pos), pos
    assert lines[-1].startswith("timing: video: ") and "| slam: " in lines[-1]


def _jax_rot_to_quat_wxyz():
    """examples/imu_demo.py's ``rot_to_quat_wxyz`` (the JAX
    ``matrix_to_quat``), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_imu_demo", os.path.join(ROOT, "examples", "imu_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod.rot_to_quat_wxyz


def test_rot_to_quat_matches_the_jax_example():
    from tests.render_scene_np import _rodrigues
    rng = np.random.default_rng(0)
    phi = rng.normal(0, 1.5, (64, 3))
    phi[:4] = [[np.pi, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, 1e-7], [0, 0, 0]]
    Rs = _rodrigues(phi).astype(np.float32)
    jfn = _jax_rot_to_quat_wxyz()
    for R in Rs:
        q, jq = imu_demo.rot_to_quat_wxyz(R), jfn(R)
        assert q.dtype == np.float32 and q.shape == (4,)
        np.testing.assert_allclose(q, jq, atol=1e-6, rtol=0)


def test_imu_demo(capsys, tmp_path):
    out = tmp_path / "map.png"
    assert imu_demo.main(["--frames", str(N_FRAMES), "--map-out", str(out)], **CUT) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"processed {N_FRAMES} frames")
    assert lines[1].startswith("final fused pose t = [")
    m = re.match(r"fused-rotation error vs ground truth: (\d+\.\d\d) deg$", lines[2])
    assert m and float(m.group(1)) <= 0.05, lines[2]
    assert lines[3] == f"wrote {out}" and out.stat().st_size > 0


def test_live_client_serves_synthetic(capsys):
    argv = ["--serve", "--source", "synthetic", "--frames", str(N_FRAMES), "--port", "0"]
    assert live_client.main(argv, **CUT) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"serving on 127\.0\.0\.1:\d+$", lines[0])
    replies = [ln for ln in lines if re.match(r"\[ *\d+\] ", ln)]
    assert len(replies) == N_FRAMES
    m = re.match(rf"{N_FRAMES} frames in \d+\.\ds \(\d+\.\d fps wire\), (\d+) tracked$",
                 lines[-1])
    assert m and int(m.group(1)) >= 5, lines[-1]
    assert int(m.group(1)) == sum("pose t=(" in ln for ln in replies)


@pytest.mark.parametrize("extra", [[], ["--clahe", "--levels", "4", "--cell", "24"]])
def test_preproc_sandbox_cpu(capsys, extra):
    argv = ["--cpu", "--width", str(W), "--height", str(H), "--reps", "2"] + extra
    assert preproc_sandbox.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["devices: [cpu cpu]", f"frame: {W}x{H} (synthetic)"]
    names = [ln.split()[0] for ln in lines if ln.startswith("  ")]
    want = ["rgba_to_gray"] + (["clahe"] if extra else []) + [
        "gaussian_blur3", "build_pyramid(L=4)" if extra else "build_pyramid(L=3)",
        "sobel_gradients", "shi_tomasi_response",
        "detect_grid(cell=24)" if extra else "detect_grid(cell=40)", "gray+pyramid+detect"]
    assert names == want
    m = re.match(r"detections: (\d+) corners", [ln for ln in lines if ln.startswith("det")][0])
    assert int(m.group(1)) > 20
    assert lines[-1].startswith("  gray+pyramid+detect")


def test_video_demo_without_the_video_opens_nothing_outside(capsys):
    """No video in the repository: one line, exit 2, and no file opened
    outside the checkout."""
    assert os.path.dirname(video_demo.DEFAULT_VIDEO) == os.path.join(ROOT, "assets")
    opened, on = [], [True]

    def hook(event, args):
        if on[0] and event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
            opened.append(os.path.abspath(os.fsdecode(args[0])))
    sys.addaudithook(hook)
    try:
        rc = video_demo.main([])
    finally:
        on[0] = False
    lines = capsys.readouterr().out.splitlines()
    if os.path.exists(video_demo.DEFAULT_VIDEO):
        pytest.fail("assets/video.mp4 is in the repository: this test expects it absent")
    assert rc == 2
    assert lines == [f"video_demo: {video_demo.DEFAULT_VIDEO} is absent (the repository does "
                     f"not hold the reference's demo video yet); nothing to run"]
    outside = [p for p in opened if not p.startswith(ROOT + os.sep)]
    assert not outside, outside


@pytest.mark.parametrize("name", ["demo", "imu_demo", "live_client", "preproc_sandbox"])
def test_examples_run_on_cuda_unless_asked(name, monkeypatch):
    """Without CUDA every example raises unless the caller asks for the
    CPU (``device="cpu"``, or the sandbox's ``--cpu``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"demo": demo, "imu_demo": imu_demo, "live_client": live_client,
           "preproc_sandbox": preproc_sandbox}[name]
    argv = {"demo": ["2"], "imu_demo": ["--frames", "2"],
            "live_client": ["--serve", "--frames", "2", "--port", "0"],
            "preproc_sandbox": ["--width", str(W), "--height", str(H)]}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
