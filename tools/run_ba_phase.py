#!/usr/bin/env python3
"""Run chip_smoke.py phase 2b (local BA's kernels) alone.

    python3 tools/run_ba_phase.py

Prints the environment lines of phase 1, builds the KLT kernel, renders
the 120 golden frames at 640x480, runs phase 3 (the main path, whose
golden keyframes' local-BA problems phase 2b takes; its bars held, its run
digest too) and then ``chip_smoke.phase_ba_kernels``.  Each line carries
the card's name and power limit; the last lines give the kernel rows of
the smoke's ``kernels`` line and the phases' seconds.  Exits non-zero
when a bar fails.  Needs CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("run_ba_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke
    from alvaar_tpu_torch.ops.lk_level import build_kernel
    from render_scene_np import TwoPlaneScene

    t0 = time.perf_counter()
    card = chip_smoke.phase_env()
    build_kernel()
    golden = np.load(os.path.join(ROOT, "tests", "golden", "ref_synthetic_640.npz"))
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640, height=480,
                          fov=60.0, tex_scale=120.0)
    frames = [scene.render(T).astype(np.float32) for T in golden["gt"]]
    print(f"[time] set-up {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    chip_smoke._ba_zero()
    _, _, run = chip_smoke.phase_main_path(frames, golden["gt"], card)
    chip_smoke._ba_path("main")
    print(f"[time] phase 3 {time.perf_counter() - t1:.1f} s", flush=True)
    t2 = time.perf_counter()
    rows = chip_smoke.phase_ba_kernels(run["ba_problems"], card)
    print(json.dumps({name: {k: v for k, v in row.items() if k != "shapes"}
                      for name, row in rows.items()}))
    print(f"[time] phase 2b {time.perf_counter() - t2:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
