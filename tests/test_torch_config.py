"""The port's SlamConfig twin, its import isolation from JAX, and the
AlvaAR constructor's device and option checks."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import alvaar_tpu.config as jcfg
import alvaar_tpu_torch.config as tcfg
from alvaar_tpu_torch import AlvaAR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = {
    "default": (jcfg.SlamConfig(), tcfg.SlamConfig()),
    "FAST": (jcfg.FAST, tcfg.FAST),
    "AVERAGE": (jcfg.AVERAGE, tcfg.AVERAGE),
    "ACCURATE": (jcfg.ACCURATE, tcfg.ACCURATE),
    "hd_serving": (jcfg.hd_serving(), tcfg.hd_serving()),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_twin_field_for_field(name):
    j, t = PRESETS[name]
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.grid_cells, j.max_keypoints, j.pyr_shapes) == \
        (t.grid_cells, t.max_keypoints, t.pyr_shapes)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import alvaar_tpu_torch\n"
        "from alvaar_tpu_torch import AlvaAR, SlamConfig\n"
        "cfg = SlamConfig(width=160, height=120, cell_size=40, window_size=4,\n"
        "                 max_landmarks=64, use_five_point=False,\n"
        "                 use_homography_init=False)\n"
        "AlvaAR(160, 120, fov=60.0, config=cfg, device='cpu')\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'alvaar_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


SLICE = dict(use_five_point=False, use_homography_init=False)


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AlvaAR(160, 120, fov=60.0, config=tcfg.SlamConfig(**SLICE), device="cuda")


@pytest.mark.parametrize("flag", ["use_five_point", "use_homography_init", "use_clahe"])
def test_unported_options_raise(flag):
    """The options the first slice refused are ported: each constructs
    and runs frames (no NotImplementedError any more)."""
    cfg = tcfg.SlamConfig(**{**SLICE, flag: True})
    slam = AlvaAR(160, 120, fov=60.0, config=cfg, device="cpu")
    frame = np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(np.float32)
    for _ in range(2):
        slam.find_camera_pose(frame)
    assert slam.last_status in (2, 3)   # 12 grid cells: too few to initialize
