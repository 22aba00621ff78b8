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
3. the main path under the default config (5-point and homography
   bootstrap): ``AlvaAR.find_camera_pose`` over the 120-frame 640x480
   golden sequence on the card, held to the native reference's bars
   (tests/golden/ref_synthetic_640.npz): first status 1 by frame 25, no
   reset, at least 102 frames tracked, sim3-aligned ATE to ground truth at
   most 1.176 cm (the worst of the reference's 10 runs); the 5-point and
   the homography RANSAC must each have run.  Then the bootstrap solvers'
   and CLAHE's times at their main-path shapes;
3b. the 8-point bootstrap (``use_five_point=False``,
   ``use_homography_init=False``) over the first 40 golden frames: first
   status 1 by frame 25, no reset, at least 25 frames tracked;
4. the facade on the phase-3 map: ``get_map_points``; ``save_map`` then
   ``load_map`` into fresh instances (leaves equal bit for bit), which
   track golden frames 120-139 at status 1; ``find_plane``;
   ``find_plane_ransac`` on a 2048-point tabletop cloud (normal within 5°
   of +z, timed); ``find_camera_pose_with_imu`` (the mirrored quaternion's
   rotation to 1e-6); ``find_camera_pose_async`` with
   ``PendingResult.drain`` against the synchronous path from the same
   checkpoint (statuses equal, poses within 1e-4);
5. loop closure: (a) a full 256-keyframe x 192-descriptor database,
   ``detect_loop`` finding the revisited entry, ``relocalize_topk``, their
   times and peak device memory; (b) the 89-frame 320x240 out-and-back of
   tests/test_loop_e2e.py with loop closure on: a loop detected in the
   return half, a correction applied, more than 40 frames tracked.

Every path is driven with the counters set to 0 just before it and read
just after.  Then one JSON line describing each kernel, and as the last line
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
import tempfile
import time

import numpy as np

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


def _drive(slam, frames, tag):
    """``find_camera_pose`` over ``frames``, synchronised around each
    frame.  Returns per-frame lists: statuses, poses, ms, K1 launches,
    host syncs, keyframe flags, and the bootstrap's kept model (None, or
    True where the homography won)."""
    import torch
    from alvaar_tpu_torch.frontend.step import _try_essential
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.homography import homography_ransac
    from alvaar_tpu_torch.worldmap.keyframe import host_bool

    run = {k: [] for k in ("status", "pose", "ms", "launches", "syncs", "kf", "use_h")}
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, s0, h0 = lk_level.launches, host_bool.syncs, homography_ransac.calls
        T = slam.find_camera_pose(frame)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["launches"].append(lk_level.launches - l0)
        run["syncs"].append(host_bool.syncs - s0 + 1)     # + the packed readback
        run["status"].append(slam.last_status)
        run["kf"].append(slam.last_is_keyframe)
        run["pose"].append(T)
        run["use_h"].append(bool(_try_essential.last_use_h)
                            if homography_ransac.calls > h0 else None)
    st = run["status"]
    tracked = [i for i, x in enumerate(st) if x == 1]
    _check(all(run["launches"][i] > 0 for i in tracked),
           f"[{tag}] a frame at status 1 launched no LK kernel")
    print(f"[{tag}] statuses {''.join(str(x) for x in st)}")
    print(f"[{tag}] first status 1 at frame {tracked[0] if tracked else None}, "
          f"{len(tracked)}/{len(st)} at status 1, {st.count(2)} resets, LK launches "
          f"{sum(run['launches'])} ({statistics.median(run['launches'])} per frame)")
    return run


def _check_bars(run, tag, by_frame, min_tracked):
    st = run["status"]
    tracked = [i for i, x in enumerate(st) if x == 1]
    first = tracked[0] if tracked else None
    _check(first is not None and first <= by_frame, f"[{tag}] first status 1 at frame {first}")
    _check(2 not in st, f"[{tag}] a reset (status 2) happened")
    _check(len(tracked) >= min_tracked, f"[{tag}] only {len(tracked)} frames at status 1")
    return tracked


def phase_main_path(frames, gt, card):
    """Phase 3: the default config over the golden sequence."""
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.fivept import essential_ransac_5pt
    from alvaar_tpu_torch.solvers.homography import homography_ransac
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from render_scene_np import ate_rmse

    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=SlamConfig(), device="cuda")
    lk_level.launches = essential_ransac_5pt.calls = homography_ransac.calls = 0
    host_bool.syncs = 0
    run = _drive(slam, frames, "main")
    launches, n5, nh = lk_level.launches, essential_ransac_5pt.calls, homography_ransac.calls
    choices = [c for c in run["use_h"] if c is not None]

    for name, t in slam.state.tensors():
        _check(t.is_cuda, f"MapState.{name} is on {t.device}")
    tracked = [i for i, x in enumerate(run["status"]) if x == 1]
    est = np.stack([run["pose"][i][:3, 3] for i in tracked]) if tracked else None
    ate_cm = 100.0 * ate_rmse(est, gt[tracked][:, :3, 3]) if len(tracked) > 2 else float("inf")
    steady, syncs, kfs = run["ms"][20:], run["syncs"][20:], run["kf"][20:]
    ms = statistics.median(steady)
    print(f"[main] bootstrap: essential_ransac_5pt {n5} calls, homography_ransac {nh} calls; "
          f"model kept per attempt {['H' if c else 'E' for c in choices]}")
    print(f"[main] ATE to ground truth {ate_cm:.4f} cm (bar {REF_ATE_WORST_CM} cm = worst "
          f"reference run; reference median {REF_ATE_MEDIAN_CM} cm; JAX package on the "
          f"CPU {JAX_CPU_ATE_CM} cm with the 8-point bootstrap)")
    print(f"[main] frames 20-119: median {ms:.3f} ms/frame ({1e3 / ms:.1f} fps), "
          f"mean {statistics.mean(steady):.3f} ms, max {max(steady):.3f} ms, "
          f"host syncs per frame median {statistics.median(syncs)} max {max(syncs)}; "
          f"first frame {run['ms'][0]:.1f} ms, slowest frame {max(run['ms']):.1f} ms "
          f"(frame {run['ms'].index(max(run['ms']))}) [{card}]")
    kf_ms = [m for m, k in zip(steady, kfs) if k]
    track_ms = [m for m, k in zip(steady, kfs) if not k]
    print(f"[main] frames 20-119 by kind: {len(track_ms)} tracking frames median "
          f"{statistics.median(track_ms):.3f} ms, {len(kf_ms)} keyframes median "
          f"{statistics.median(kf_ms) if kf_ms else float('nan'):.3f} ms [{card}]")
    _check_bars(run, "main", 25, REF_TRACKED)
    _check(ate_cm <= REF_ATE_WORST_CM, f"ATE {ate_cm:.4f} cm > {REF_ATE_WORST_CM} cm")
    _check(n5 > 0, "the 5-point RANSAC never ran on the card")
    _check(nh > 0, "the homography RANSAC never ran on the card")

    # the bootstrap solvers and CLAHE alone, at their main-path shapes
    from alvaar_tpu_torch.ops.image import clahe
    from alvaar_tpu_torch.solvers.essential import essential_ransac
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    f0 = torch.nn.functional.normalize(torch.randn(192, 3, device=dev, generator=gen) * 0.3
                                       + torch.tensor([0.0, 0.0, 1.0], device=dev), dim=-1)
    f1 = torch.nn.functional.normalize(f0 + 0.01 * torch.randn(192, 3, device=dev, generator=gen),
                                       dim=-1)
    valid = torch.ones(192, dtype=torch.bool, device=dev)
    args = dict(focal=slam.camera.focal, iters=100)
    gray = torch.as_tensor(frames[0], device=dev)
    times = {
        "essential_ransac_5pt": _time_ms(lambda: essential_ransac_5pt(gen, f0, f1, valid, **args), reps=5),
        "homography_ransac": _time_ms(lambda: homography_ransac(gen, f0, f1, valid, **args), reps=5),
        "essential_ransac (8-point)": _time_ms(lambda: essential_ransac(gen, f0, f1, valid, **args), reps=5),
        "clahe 640x480": _time_ms(lambda: clahe(gray)),
    }
    print("[main] alone, CUDA events around back-to-back calls: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()) + f" (N=192, 100 hypotheses) [{card}]")
    return slam, launches


def phase_eight_point(frames, card):
    """Phase 3b: the first slice's 8-point bootstrap, at a cut depth."""
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.fivept import essential_ransac_5pt

    cfg = SlamConfig(use_five_point=False, use_homography_init=False)
    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=cfg, device="cuda")
    lk_level.launches = essential_ransac_5pt.calls = 0
    run = _drive(slam, frames[:40], "8pt")
    _check(lk_level.launches > 0, "[8pt] no LK launch")
    _check(essential_ransac_5pt.calls == 0, "[8pt] the 5-point solver ran")
    _check_bars(run, "8pt", 25, 25)
    print(f"[8pt] frames 20-39 median {statistics.median(run['ms'][20:]):.3f} ms/frame [{card}]")


def phase_facade(slam, more_frames, card, tmp):
    """Phase 4: the rest of the facade on the phase-3 map."""
    import torch
    from alvaar_tpu_torch import AlvaAR
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.plane import find_plane_ransac
    from alvaar_tpu_torch.system import PendingResult
    from alvaar_tpu_torch.worldmap.state import map_state_to_numpy

    pts, colors = slam.get_map_points()
    print(f"[facade] get_map_points: {pts.shape[0]} points, colours {colors.dtype}")
    _check(pts.shape[0] > 100 and np.isfinite(pts).all(), "get_map_points: too few or non-finite")
    _check(colors.dtype == np.uint8 and colors.shape[0] == pts.shape[0], "get_map_points colours")

    path = os.path.join(tmp, "golden_map.npz")
    slam.save_map(path)
    ref = map_state_to_numpy(slam.state)

    def loaded():
        inst = AlvaAR(slam.config.width, slam.config.height, camera=slam.camera,
                      config=slam.config, device="cuda")
        inst.load_map(path)
        return inst

    sync = loaded()
    back = map_state_to_numpy(sync.state)
    _check(set(back) == set(ref), "load_map: different leaves")
    for k in ref:
        _check(back[k].dtype == ref[k].dtype and np.array_equal(back[k], ref[k]),
               f"load_map: leaf {k} differs")
    print(f"[facade] save_map -> load_map: {len(ref)} arrays equal bit for bit "
          f"({os.path.getsize(path) / 2**20:.2f} MiB on disk)")
    lk_level.launches = 0
    sync_st, sync_T = [], []
    for f in more_frames:
        sync_T.append(sync.find_camera_pose(f))
        sync_st.append(sync.last_status)
    print(f"[facade] resumed after load_map on golden frames 120-{119 + len(more_frames)}: "
          f"statuses {''.join(map(str, sync_st))}, LK launches {lk_level.launches}")
    _check(sync_st[:10] == [1] * 10, "tracking did not resume at status 1 after load_map")

    # async + drain against the synchronous path, from the same checkpoint
    lk_level.launches = 0
    inst = loaded()
    pending = [inst.find_camera_pose_async(f) for f in more_frames]
    PendingResult.drain(pending)
    _check(lk_level.launches > 0, "async path launched no LK kernel")
    _check([r.status for r in pending] == sync_st, "async statuses differ from the sync path")
    dmax = max((float(np.abs(r.pose - T).max()) for r, T in zip(pending, sync_T)
                if T is not None), default=0.0)
    print(f"[facade] find_camera_pose_async + drain over {len(more_frames)} frames: statuses "
          f"equal to the sync path, max |pose diff| {dmax:.3e}")
    _check(dmax <= 1e-4, f"async poses differ from the sync path by {dmax}")

    # IMU: rotation from the mirrored, inverted quaternion
    lk_level.launches = 0
    inst = loaded()
    rng = np.random.default_rng(7)
    worst = 0.0
    for f in more_frames[:10]:
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        T = inst.find_camera_pose_with_imu(f, q)
        w, x, y, z = q[0], q[1], -q[2], -q[3]            # conj of (w, -x, y, z)
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        worst = max(worst, float(np.abs(T[:3, :3] - R).max()))
    print(f"[facade] find_camera_pose_with_imu over 10 frames: max |R - R(q)| {worst:.2e}, "
          f"accumulated translation {np.round(T[:3, 3], 4).tolist()}, LK launches {lk_level.launches}")
    _check(worst <= 1e-6, f"IMU rotation off by {worst}")
    _check(lk_level.launches > 0, "IMU path launched no LK kernel")

    T_plane = slam.find_plane()
    print(f"[facade] find_plane on the golden map: "
          f"{'None' if T_plane is None else np.round(T_plane, 4).tolist()}")

    # find_plane_ransac on the bench's tabletop cloud
    rng = np.random.default_rng(5)
    n = 2048
    cloud = np.empty((n, 3), np.float32)
    flat = rng.random(n) < 0.7
    cloud[:, 0] = rng.uniform(-2, 2, n)
    cloud[:, 1] = rng.uniform(-1.5, 1.5, n)
    cloud[:, 2] = np.where(flat, 3.0 + rng.normal(0, 0.005, n), rng.uniform(1.0, 2.8, n))
    dev = torch.device("cuda")
    p, v, c = (torch.as_tensor(cloud, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
               torch.zeros(3, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    res = find_plane_ransac(gen, p, v, c, iters=250)
    angle = float(np.degrees(np.arccos(min(1.0, abs(float(res.normal[2]))))))
    ms = _time_ms(lambda: find_plane_ransac(gen, p, v, c, iters=250))
    print(f"[facade] find_plane_ransac 2048 points, 250 iterations: success {bool(res.success)}, "
          f"normal {angle:.3f} deg off +z, {ms:.3f} ms per call (CUDA events around back-to-back "
          f"calls) [{card}]")
    _check(bool(res.success) and angle <= 5.0, "find_plane_ransac missed the tabletop")


def phase_loop_closure(card):
    """Phase 5: loop closure at full database size, then end to end."""
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.geom.lie import SE3
    from alvaar_tpu_torch.loopclosure import detector as det
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from render_scene_np import TwoPlaneScene, trajectory

    # (a) bench.py's shape: 256 keyframes x 192 descriptors, seed 3
    dev = torch.device("cuda")
    cap, kps = 256, 192
    rng = np.random.default_rng(3)
    descs = torch.as_tensor(rng.integers(0, 2 ** 32, (cap, kps, 8), dtype=np.uint32).view(np.int32),
                            device=dev)
    pts = torch.as_tensor(rng.normal(0, 2, (cap, kps, 3)).astype(np.float32), device=dev)
    ones = torch.ones(kps, dtype=torch.bool, device=dev)
    ident = SE3.identity(device=dev)
    db = det.db_init(cap, kps, dev)
    for i in range(cap):
        db = det.db_add(db, descs[i], pts[i], ones, ones, i, ident)
    q, qid = descs[10], cap + 100
    _, res = det.detect_loop(db, q, ones, qid)
    print(f"[loop] detect_loop on a {cap}x{kps} database (descriptors of entry 10): found "
          f"{bool(res.found)}, entry {int(res.entry)}, kf {int(res.match_kf_id)}, "
          f"score {float(res.score):.4f}")
    _check(bool(res.found) and int(res.entry) == 10, "detect_loop missed entry 10")

    def query_and_add():
        db2, _ = det.detect_loop(db, q, ones, qid)
        return det.db_add(db2, q, pts[10], ones, ones, qid, ident)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms_query = _time_ms(query_and_add)
    peak_query = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    bearings = torch.nn.functional.normalize(torch.randn(kps, 3, device=dev), dim=-1)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reloc = det.relocalize_topk(db, q, bearings, ones, gen, focal=500.0)
    torch.cuda.synchronize()
    peak_reloc = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ms_reloc = _time_ms(lambda: det.relocalize_topk(db, q, bearings, ones, gen, focal=500.0),
                        reps=5)
    print(f"[loop] detect_loop + db_add {ms_query:.3f} ms per round, peak device memory "
          f"{peak_query:.1f} MiB above the database; relocalize_topk (top 8, 100 iterations) "
          f"{ms_reloc:.3f} ms, success {bool(reloc.success)}, peak {peak_reloc:.1f} MiB; "
          f"CUDA events around back-to-back calls [{card}]")

    # (b) the out-and-back of tests/test_loop_e2e.py
    cfg = SlamConfig(width=320, height=240, cell_size=24, window_size=10, max_landmarks=512,
                     ransac_iters=50, ba_iters=4, init_parallax_px=12.0, kf_parallax_px=6.0)
    fwd = trajectory(45, step=0.04)
    gt = np.concatenate([fwd, fwd[::-1][1:]], axis=0)
    scene = TwoPlaneScene(np.random.default_rng(11), width=320, height=240, fov=60.0)
    slam = AlvaAR(320, 240, fov=60.0, config=cfg, device="cuda", enable_loop_closure=True,
                  loop_delay=4)
    lk_level.launches = 0
    loops, statuses = [], []
    t0 = time.perf_counter()
    for i in range(len(gt)):
        slam.find_camera_pose(scene.render(gt[i]).astype(np.float32))
        statuses.append(slam.last_status)
        if slam.last_loop is not None:
            loops.append((i, int(slam.last_loop.match_kf_id), slam.last_loop_correction is not None))
    wall = time.perf_counter() - t0
    print(f"[loop] out-and-back 320x240, {len(gt)} frames: statuses {''.join(map(str, statuses))}")
    print(f"[loop] {statuses.count(1)} at status 1, loops (frame, matched kf, corrected) {loops}, "
          f"LK launches {lk_level.launches}, {wall:.1f} s [{card}]")
    _check(lk_level.launches > 0, "[loop] no LK launch")
    _check(statuses.count(1) > 40, "[loop] tracking broke")
    _check(any(i >= len(gt) // 2 for i, _, _ in loops), "[loop] no loop in the return half")
    _check(any(c for _, _, c in loops), "[loop] no correction applied")


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
    slam, launches = phase_main_path(frames, gt, card)
    phase_eight_point(frames, card)
    gt_more = trajectory(n + 45, step=0.04)[n:n + 20]
    more = [scene.render(T).astype(np.float32) for T in gt_more]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        phase_facade(slam, more, card, tmp)
    phase_loop_closure(card)

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
