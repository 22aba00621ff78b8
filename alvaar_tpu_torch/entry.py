"""``entry()``: the port's per-frame step with example arguments, the
twin of the JAX package's ``__graft_entry__.entry``.

    fn, args = entry()          # on the card; entry("cpu") on a CPU host
    state, out = fn(*args)

``fn`` is ``frontend/step.slam_step`` bound to ``Camera.from_fov(640,
480, 60.0)`` and ``SlamConfig()``; the arguments are a fresh map state and
one 640x480 frame drawn from ``np.random.default_rng(0)`` (uniform 0-255,
float32), both on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.frontend.step import slam_step
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.worldmap.state import init_map_state


def entry(device="cuda"):
    """(fn, example_args): the full per-frame SLAM step at 640x480 and its
    arguments on ``device``.  Raises without CUDA unless ``device`` is the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(device='cuda'): CUDA is not available")
    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    state = init_map_state(cfg, dev)
    frame = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (cfg.height, cfg.width)).astype(np.float32)).to(dev)

    def fn(state, frame):
        return slam_step(state, frame, cam, cfg)

    return fn, (state, frame)
