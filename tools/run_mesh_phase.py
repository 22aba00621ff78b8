#!/usr/bin/env python3
"""Run chip_smoke.py phase 6e (the stream mesh) alone.

    python3 tools/run_mesh_phase.py

Prints the environment lines of phase 1, builds the KLT kernel, renders
golden frames 0-74 at 640x480 and calls ``chip_smoke.phase_mesh`` on every
visible card (phase 6's run is not there to compare with, so that line
says "not run").  Each phase-6e line carries the card's name and power
limit; the last lines give the KLT launches and the phase's seconds.
Exits non-zero when a bar of the phase fails.  Needs CUDA; on a machine
with four cards it gives the four-card rows.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("run_mesh_phase: CUDA is not available", file=sys.stderr)
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
    frames = [scene.render(T).astype(np.float32) for T in golden["gt"][:75]]
    print(f"[time] set-up {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    print(f"launches {chip_smoke.phase_mesh(frames, None, card)}")
    print(f"[time] phase 6e {time.perf_counter() - t1:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
