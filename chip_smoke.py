#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alvaar_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit;
2. the KLT level kernel (csrc/lk_level.cu): built from the checkout, then
   run through ``fb_klt_track`` at 640x480 on golden frames 0 and 1 for
   stage 1 (1 level, R=4), stage 2 (3 levels, R=8) and the 48-slot stage-2
   compaction, once through the kernel and once through its plain torch
   twin on the same CUDA tensors; statuses must be identical, positions
   within 1e-3 px, errors within 1e-3, and more than 50 points tracked.
   Then the time of one level call (N=192, R=4, 16 iterations), kernel
   and plain, from CUDA events, and the kernel's device time alone from
   ``torch.profiler``;
3. the main path: ``AlvaAR.find_camera_pose`` over the 120-frame 640x480
   golden sequence on the card, held to the native reference's bars
   (tests/golden/ref_synthetic_640.npz): first status 1 by frame 25, no
   reset, at least 102 frames tracked, sim3-aligned ATE to ground truth at
   most 1.176 cm (the worst of the reference's 10 runs).

Then one JSON line describing each kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failed bar raises and the script
exits non-zero without that line; so does a machine without CUDA.  It
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

REF_ATE_WORST_CM = 1.176      # worst of the 10 native-reference runs
REF_ATE_MEDIAN_CM = 1.092     # their median
JAX_CPU_ATE_CM = 0.962        # the JAX package on the CPU, same slice config
REF_TRACKED = 102             # frames at status 1 in every reference run


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls, median over ``rounds``.  A call whose host side takes longer
    than its device work is timed at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_ms(fn, kernel_name: str, reps: int = 20) -> float:
    """Device time per call of the kernels whose name holds
    ``kernel_name``, from ``torch.profiler`` (nan if it recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if kernel_name in e.key)
    return us / 1e3 / reps if us > 0 else float("nan")


def phase_env():
    import torch
    card = _card()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(card)
    return card


def phase_kernel(frames, card):
    import torch
    from alvaar_tpu_torch.config import SlamConfig
    from alvaar_tpu_torch.ops import lk_level as lk
    from alvaar_tpu_torch.ops.detect import detect_grid
    from alvaar_tpu_torch.ops.image import build_pyramid
    from alvaar_tpu_torch.ops.klt import fb_klt_track

    t0 = time.time()
    lib = lk.build_kernel(verbose=True)
    print(f"[kernel] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")

    cfg = SlamConfig()
    dev = torch.device("cuda")
    f0 = torch.as_tensor(frames[0], dtype=torch.float32, device=dev)
    f1 = torch.as_tensor(frames[1], dtype=torch.float32, device=dev)
    det = detect_grid(f0, torch.zeros((0, 2), device=dev),
                      torch.zeros(0, dtype=torch.bool, device=dev),
                      cell=cfg.cell_size, border=cfg.image_border)
    pyr0 = build_pyramid(f0, cfg.pyramid_levels)
    pyr1 = build_pyramid(f1, cfg.pyramid_levels)
    args = dict(win=cfg.klt_window, iters=cfg.klt_iters, eps=cfg.klt_eps,
                err_max=cfg.klt_err_max, fb_dist=cfg.klt_fb_dist)
    n48 = cfg.klt_stage2_slots
    cases = {
        "stage1 N=192 levels=1 R=4": (det.xy, det.valid, 1, 4),
        "stage2 N=192 levels=3 R=8": (det.xy, det.valid, 3, 8),
        "stage2 N=48 levels=3 R=8": (det.xy[:n48].contiguous(), det.valid[:n48], 3, 8),
    }
    max_err = 0.0
    for name, (pts, valid, levels, R) in cases.items():
        run = lambda level_fn: fb_klt_track(pyr0, pyr1, pts, pts, valid, levels=levels,
                                            search_r=R, level_fn=level_fn, **args)
        rk, rp = run(lk.lk_level), run(lk.lk_level_plain)
        torch.cuda.synchronize()
        sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
        both = sk & sp
        dxy = float((rk.xy - rp.xy).abs().cpu().numpy()[both].max()) if both.any() else 0.0
        derr = float((rk.err - rp.err).abs().cpu().numpy()[both].max()) if both.any() else 0.0
        print(f"[kernel] {name}: tracked kernel {int(sk.sum())} plain {int(sp.sum())} "
              f"of {int(valid.sum())}, status mismatches {int((sk != sp).sum())}, "
              f"max|dxy| {dxy:.3e} px, max|derr| {derr:.3e}")
        _check((sk == sp).all(), f"{name}: kernel and plain statuses differ")
        _check(dxy < 1e-3, f"{name}: |dxy| {dxy} >= 1e-3 px")
        _check(derr < 1e-3, f"{name}: |derr| {derr} >= 1e-3")
        _check(int(sk.sum()) > (50 if len(sk) > n48 else 20),
               f"{name}: only {int(sk.sum())} tracked")
        max_err = max(max_err, dxy, derr)

    # one level call at the main path's stage-1 shape
    guess = det.xy + torch.tensor([1.5, 0.5], device=dev)
    call = lambda fn: fn(pyr0[0], pyr1[0], det.xy, guess, det.valid, win=cfg.klt_window,
                         iters=cfg.klt_iters, eps=cfg.klt_eps, search_r=4)
    ms_plain_a = _time_ms(lambda: call(lk.lk_level_plain))
    ms_kernel_a = _time_ms(lambda: call(lk.lk_level))
    ms_kernel_b = _time_ms(lambda: call(lk.lk_level))
    ms_plain_b = _time_ms(lambda: call(lk.lk_level_plain))
    ms_kernel = statistics.median([ms_kernel_a, ms_kernel_b])
    ms_plain = statistics.median([ms_plain_a, ms_plain_b])
    ms_device = _device_ms(lambda: call(lk.lk_level), "lk_level_kernel")
    print(f"[kernel] lk_level N={det.xy.shape[0]} R=4 iters={cfg.klt_iters}: "
          f"kernel {ms_kernel:.4f} ms ({ms_kernel_a:.4f}, {ms_kernel_b:.4f}), plain "
          f"{ms_plain:.4f} ms ({ms_plain_a:.4f}, {ms_plain_b:.4f}) per call, CUDA events "
          f"around back-to-back calls; kernel device time {ms_device:.4f} ms per call "
          f"(torch.profiler) [{card}]")
    return max_err, ms_kernel, ms_plain


def phase_main_path(frames, gt, card):
    import numpy as np
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from render_scene_np import ate_rmse

    cfg = SlamConfig(use_five_point=False, use_homography_init=False)
    slam = AlvaAR(640, 480, fov=60.0, config=cfg, device="cuda")
    lk_level.launches = 0
    host_bool.syncs = 0
    statuses, poses, frame_ms, launches, syncs, keyframes = [], [], [], [], [], []
    for i, frame in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, s0 = lk_level.launches, host_bool.syncs
        T = slam.find_camera_pose(frame)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(lk_level.launches - l0)
        syncs.append(host_bool.syncs - s0 + 1)     # + the packed readback
        statuses.append(slam.last_status)
        keyframes.append(slam.last_is_keyframe)
        poses.append(T)
    total_launches = lk_level.launches

    for name, t in slam.state.tensors():
        _check(t.is_cuda, f"MapState.{name} is on {t.device}")
    tracked = [i for i, s in enumerate(statuses) if s == 1]
    _check(all(launches[i] > 0 for i in tracked),
           "a frame at status 1 launched no LK kernel")
    first = tracked[0] if tracked else None
    est = np.stack([poses[i][:3, 3] for i in tracked]) if tracked else None
    ate_cm = 100.0 * ate_rmse(est, gt[tracked][:, :3, 3]) if len(tracked) > 2 else float("inf")
    steady = frame_ms[20:]
    ms = statistics.median(steady)
    print(f"[main] statuses {''.join(str(s) for s in statuses)}")
    print(f"[main] first status 1 at frame {first}, {len(tracked)}/{len(frames)} at status 1, "
          f"{statuses.count(2)} resets, LK launches {total_launches} "
          f"({statistics.median(launches)} per frame)")
    print(f"[main] ATE to ground truth {ate_cm:.4f} cm (bar {REF_ATE_WORST_CM} cm = worst "
          f"reference run; reference median {REF_ATE_MEDIAN_CM} cm; JAX package on the "
          f"CPU {JAX_CPU_ATE_CM} cm)")
    print(f"[main] frames 20-119: median {ms:.3f} ms/frame ({1e3 / ms:.1f} fps), "
          f"mean {statistics.mean(steady):.3f} ms, max {max(steady):.3f} ms, "
          f"host syncs per frame median {statistics.median(syncs[20:])} max "
          f"{max(syncs[20:])}; first frame {frame_ms[0]:.1f} ms, slowest frame "
          f"{max(frame_ms):.1f} ms (frame {frame_ms.index(max(frame_ms))}) [{card}]")
    kf_ms = [m for m, k in zip(frame_ms[20:], keyframes[20:]) if k]
    track_ms = [m for m, k in zip(frame_ms[20:], keyframes[20:]) if not k]
    print(f"[main] frames 20-119 by kind: {len(track_ms)} tracking frames median "
          f"{statistics.median(track_ms):.3f} ms, {len(kf_ms)} keyframes median "
          f"{statistics.median(kf_ms) if kf_ms else float('nan'):.3f} ms [{card}]")
    _check(first is not None and first <= 25, f"first status 1 at frame {first}")
    _check(2 not in statuses, "a reset (status 2) happened")
    _check(len(tracked) >= REF_TRACKED, f"only {len(tracked)} frames at status 1")
    _check(ate_cm <= REF_ATE_WORST_CM, f"ATE {ate_cm:.4f} cm > {REF_ATE_WORST_CM} cm")
    return total_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "alvaar_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from render_scene_np import TwoPlaneScene, trajectory

    card = phase_env()
    golden = np.load(os.path.join(ROOT, "tests", "golden", "ref_synthetic_640.npz"))
    n = int(golden["n_frames"])
    gt = golden["gt"]
    _check(np.abs(trajectory(n + 45, step=0.04)[:n] - gt).max() < 1e-6,
           "numpy trajectory differs from the golden ground truth")
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640,
                          height=480, fov=60.0, tex_scale=120.0)
    frames = [scene.render(gt[i]).astype(np.float32) for i in range(n)]

    max_err, ms_kernel, ms_plain = phase_kernel(frames, card)
    launches = phase_main_path(frames, gt, card)

    print(json.dumps({"kernels": [{
        "name": "lk_level", "route": "cuda",
        "source": "alvaar_tpu_torch/csrc/lk_level.cu",
        "replaces": "alvaar_tpu/ops/pallas/lk_kernel.py:173",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_kernel, "plain_ms": ms_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
