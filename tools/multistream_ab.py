#!/usr/bin/env python3
"""Time the 16-stream serving step of two checkouts on one card, in turns.

    python3 tools/multistream_ab.py OTHER_ROOT [--steps 60]

Runs the configuration of chip_smoke.py phase 6 (B = 16, 640x480,
``SlamConfig()``, 3 keyframe slots, stream b on golden frames 3b ..
3b + steps - 1, staged on the card) through ``make_multistream_step`` of
the package in OTHER_ROOT and of this checkout, in turns (other, this,
this, other), each run in a process of its own that imports only its own
checkout.  Every step is synchronised and timed on the host clock.
Prints one line per run: the median step over steps 10 on, aggregate
frames/s, steps grouped by the keyframes they report (``is_keyframe``),
the slowest step, the statuses' reset count, and the card's name and
power limit; then the medians of each checkout.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, KF_SLOTS, STAGGER = 16, 3, 3


def _run(root: str, steps: int) -> dict:
    """One timed run of the step from ``root`` (this process imports it)."""
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.parallel.multistream import (init_multistream_state,
                                                       make_multistream_step)
    from render_scene_np import TwoPlaneScene

    golden = np.load(os.path.join(root, "tests", "golden", "ref_synthetic_640.npz"))
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640, height=480,
                          fov=60.0, tex_scale=120.0)
    n = STAGGER * (B - 1) + steps
    frames = [scene.render(T).astype(np.float32) for T in golden["gt"][:n]]
    seq = np.stack([np.stack([frames[STAGGER * b + i] for b in range(B)]) for i in range(steps)])
    frames_dev = torch.as_tensor(seq, device="cuda")
    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    step = make_multistream_step(cfg, cam, kf_slots=KF_SLOTS)
    states = init_multistream_state(cfg, B, device="cuda")
    dts = torch.ones(B, device="cuda")
    ms, kfs, resets = [], [], 0
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, out = step(states, frames_dev[i], dts)
        status = out.status.cpu()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        kfs.append(int(out.is_keyframe.sum()))
        resets += int((status == 2).sum())
    return dict(ms=ms, kf=kfs, resets=resets)


def _summary(tag: str, r: dict, card: str) -> str:
    ms, kf = r["ms"][10:], r["kf"][10:]
    groups = {}
    for t, k in zip(ms, kf):
        groups.setdefault(k, []).append(t)
    fps = len(ms) * B / (sum(ms) / 1e3)
    return (f"[ab] {tag}: median {statistics.median(ms):.1f} ms per step, {fps:.1f} frames/s "
            f"({B} streams, steps 10-{len(r['ms']) - 1}); by keyframes: " + "; ".join(
                f"{k}: {len(v)} steps median {statistics.median(v):.1f} ms"
                for k, v in sorted(groups.items()))
            + f"; slowest {max(r['ms']):.1f} ms; status-2 reports {r['resets']} [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print(json.dumps(_run(args.other, args.steps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("multistream_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    other = os.path.abspath(args.other)
    medians = {"other": [], "this": []}
    for tag, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--steps",
                              str(args.steps), "--run"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
        r = json.loads(out)
        print(_summary(f"{tag} ({root})", r, card), flush=True)
        medians[tag].append(statistics.median(r["ms"][10:]))
    print(f"[ab] median step ms: other {medians['other']}, this {medians['this']} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
