#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alvaar_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. environment: Python, torch and CUDA versions, the card's name and
   power limit;
2. the KLT kernel (csrc/klt_track.cu), built from the checkout: one launch
   per ``fb_klt_track`` call, against the plain composition (ops/klt.py
   over ``lk_level_plain``) on the same CUDA tensors, on golden frames 0
   and 1 at 640x480: stage 1 (N=192, 1 level, R=4), stage 2 (N=192, 3
   levels, R=8), N=48, and N=3072 (the 192 detected points at 16 sub-pixel
   offsets).  Statuses identical, positions and errors within 1e-5, more
   than 50 points tracked (20 at N=48); whether they are bit-equal is
   printed.  At each shape: ms per call from CUDA events around
   back-to-back calls (kernel and plain), device time per call from
   ``torch.profiler``, and the bound (the bytes and float32 operations this
   run's points need, over the H100's rates).  With
   build/lk_level_6b890e1.cu present (the per-level kernel of commit
   6b890e1, written there by ``git show``), the per-level design's device
   time at the same shapes.  The stream-batched calls: one launch over 16
   streams x 192 points (stream b: golden frames 3b -> 3b+1, the points
   detected on frame 3b; stage 2's schedule), and one over 48 x 192 (frames
   b -> b+1), each against the per-stream plain composition and as many
   single-stream launches, its device time beside theirs, and the bound
   summed over the streams.  Then ``klt_pyramidal``
   (the kernel's forward-only schedule) against its plain composition, and
   ``lk_level`` (the one-pass schedule) against ``lk_level_plain``;
3. the main path under the default config (5-point and homography
   bootstrap): ``AlvaAR.find_camera_pose`` over the 120-frame 640x480
   golden sequence on the card, held to the native reference's bars
   (tests/golden/ref_synthetic_640.npz): first status 1 by frame 25, no
   reset, at least 102 frames tracked, sim3-aligned ATE to ground truth at
   most 1.176 cm (the worst of the reference's 10 runs); the 5-point and
   the homography RANSAC must each have run; every frame at status 1
   launched the KLT kernel exactly twice through ``fb_klt_track`` and
   none through ``klt_pyramidal`` or ``lk_level``; at most 6 host syncs per
   frame at the median.  Then the bootstrap solvers' and CLAHE's times at
   their main-path shapes.  The run is also scored by the port's own
   ``utils/parity.py``: ``sim3_align_ate`` equal to the ATE above to 1e-9
   cm, and ``ate_vs_reference`` against the reference runs (the JAX
   bench's ``ate_vs_reference_synthetic``);
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
   return half, a correction applied, more than 40 frames tracked;
6a. the sub-batch probe: the keyframe phase on S = 1, 2, 3 and 8
   keyframe-requesting rows of the single stream's 640x480 golden run (a
   steady keyframe with local BA, the first keyframe, the bootstrap pair's
   second, later keyframes, repeated), one batched pass
   (``keyframe_phase_batched``) against the composition of rows
   (``keyframe_phase`` per row, then ``write_rows``), timed in turns
   (rows, batched, batched, rows) and held to tests/test_torch_subbatch.py's
   bars; at S = 3 both under ``torch.profiler`` (kernels launched, device
   time, host stream syncs); the ops, if any, that fell back to a per-row
   loop under ``vmap``;
6. multi-stream serving (parallel/multistream.py): 16 streams at 640x480
   under the default config with 3 keyframe slots, stream b on golden
   frames 3b .. 3b+59, staged on the card: every stream tracks and keeps
   at least 2 keyframes (streams whose first keyframe the election defers
   reset on the next frame and report status 2, as in the JAX package);
   the ATE of stream 0 and of every stream that never reset at most 1.5x
   that of the B = 1, one-slot run of its frames through the same step
   from the same fresh row, which never resets; exactly 2 KLT
   launches per step after the first, 3 election reads per step, and at
   most 4 host syncs in a step (the election reads and the output read:
   every gated phase runs once on the stack of its elected rows), at
   B = 16 and B = 1.  Printed: aggregate frames/s over steps 10-59, the
   step split into the track phase and the rest, step ms grouped by
   keyframes served (with the keyframe pass's own ms), host syncs, peak
   device memory;
6d. 48 streams at 640x480, 8 keyframe slots (the JAX bench's
   max(3, ceil(B / 6))), stream b on golden frames b .. b+39 staged on the
   card (cut from 60 frames to keep the smoke's time): every stream
   tracks with at least 2 keyframes, at most 8 keyframes and 4 host syncs
   per step, 2 KLT launches per step, stream 0's ATE at most 1.5x its
   B = 1 run of phase 6 over the same frames; aggregate frames/s, step ms
   by keyframes served, the track / gated split, peak device memory;
6b. loop closure inside the keyframe sub-batch: 4 streams, 2 slots, on
   phase 5b's out-and-back: every stream tracks, every database holds at
   least 2 entries, some stream registered a loop;
6c. the TCP server (serving/server.py): 4 streams at 640x480 on the card,
   4 client threads sending 30 uint8 frames each: every client reaches
   status 1, reply frame ids match, and a fifth client is served on a
   recycled slot; the round trip's median is printed;
6e. the stream mesh (``shard_states``, ``make_multistream_step(devices=)``):
   8 streams at 640x480, ``SlamConfig()``, 2 keyframe slots per device,
   stream b on golden frames 3b .. 3b+23 staged on card 0, over (a) two
   shards on card 0 and (b) one shard per visible card (a one-shard mesh
   on a one-card machine): each shard's statuses and keyframes equal to
   ``multistream_step_local`` on its block alone (same fresh rows and
   generators, same per-device slots), poses within q 1e-5 and t 1e-4, 2
   KLT launches and at most 4 host syncs per shard per step, every stream
   at status 1; aggregate frames/s over steps 8-23 for (a), (b) and the
   unsharded B = 8 step with 4 slots, and the number of cards;
7. host ingest: golden frames 0-69 quantised to uint8, pushed by a
   producer thread through the port's ``FrameRing`` (``push_gray``,
   capacity 8, under a semaphore, as ``io/capture.VideoCapture`` does;
   the ring's library is built from native/frame_ring.cpp with g++ into
   build/), consumed by ``find_camera_pose`` on the card (frames 0-59)
   and ``find_camera_pose_with_imu`` fed from an ``ImuCapture`` (frames
   60-69): statuses and poses bit-equal to the same frames fed directly,
   2 KLT launches per status-1 frame, ``push_rgba`` within 1e-3 of
   ``ops/image.rgba_to_gray`` on the card, the IMU rotation to 1e-6;
   ``Stats`` times the ring wait and the step.  The video decoder
   (``io/video.py``, ``io/capture.py``) and the V4L2 camera
   (``io/camera.py``) do not run here: the repository has no video file
   and the machine has no camera (the CPU tests cover them);
8. BASELINE configuration 5, ``hd_serving()`` at 1920x1080 (96 px cells,
   20 x 12 = 240 keypoints, the bottom row of cells padded; KLT on pyramid
   levels 1-2, detection at 1920x1080, ORB on level 1) through
   ``make_multistream_step``, on the JAX bench's 1080p scene (seed 7,
   ``tex_scale`` 120, fov 60, ``trajectory(M, step=0.04)``).  The frames
   are rendered on the card by a float64 torch twin of
   ``TwoPlaneScene.render`` (``_CardScene``), held to the numpy renderer
   on the first and last frame to 1e-6, and staged once as [M, H, W];
   each step gathers its [B, H, W] from that stack.  K1 first: one
   stage-2 launch from level 1 over 8 x 240 and over 64 x 240 points
   (stream b: frames b*s -> b*s+1, s the run's stagger), against the
   per-stream plain composition (bit for bit at B = 8) and B single-stream
   launches, with its bound.  Then B = 8 with 2 keyframe slots, stream b on
   frames 3b .. 3b+59, and B = 64 with 11 slots, stream b on frames b ..
   b+47: every stream ends at status 1 with at least 2 keyframes in its
   window; stream 0 and every stream that never reset (at B = 64 the first
   four of them) keep their ATE at most 1.5x that of their own B = 1 run
   from the same fresh row; 2 KLT launches per step after the first, at
   most 4 host syncs and ``kf_slots`` keyframes per step.  Printed:
   aggregate frames/s over steps 10 on, step ms by keyframes served, the
   track / gated split, peak device memory, the start-up resets;
9. BASELINE configuration 4, ``SlamConfig(max_landmarks=10240)``: (a)
   ``local_ba`` alone on the JAX bench's problem (W = 30, K = 192,
   observations 60% valid, the first two poses constant, seed 0), device ms
   per call by CUDA events, kernels and stream syncs per call under
   ``torch.profiler``, peak device memory; poses, inverse depths and cost
   finite, the constant poses' translations unchanged bit for bit and
   their quaternions to 2.4e-7 (the solver renormalises them); (b) the
   phase-3 golden sequence through ``AlvaAR.find_camera_pose`` at that
   pool, held to phase 3's bars, with the live landmarks and the pool's
   high-water mark per frame, the trajectory's difference from phase 3's,
   and its keyframe and tracking frames' ms in turns with a run at the
   default pool (10240, 4096, 10240 landmarks) and beside phase 3's;
10. the port's bench (alvaar_tpu_torch/bench.py): first
   ``masked_scatter_set`` on the card against a serial loop at local BA's
   write-back size, 3 rows under ``vmap`` and one alone, with about 11
   writes per written index: every colliding write keeps the last one
   (a merged landmark's depth is written once per column it holds);
   (a) its ``bench_multistream_loop`` on phase 6's 16 staged streams (640x480,
   ``SlamConfig()``, 3 keyframe slots, databases of 256 entries, the
   default loop delay), one timed rep after the bench's warm-up: the
   bench's own bars (median tracked >= N // 3, finite poses), every
   stream's database at least 2 entries, 2 KLT launches per step after
   the first and at most 4 host syncs per step; printed: aggregate
   frames/s, median step ms, the tracked median, database entries per
   stream, launches and syncs per step, peak device memory; (b) the
   command ``python -m alvaar_tpu_torch.bench --frames 12 --skip-aux`` in
   a fresh interpreter: exit code 0, exactly two bare-JSON stdout lines,
   equal, the last line one of them, metric
   ``multistream_fps_per_chip_640x480`` with a finite value (the bench
   fails a stage whose reps' statuses or poses are not bit-equal).

Every path is driven with the counters set to 0 just before it and read
just after; the kernel line's ``launches`` sums the paths' launches.  Each
group of phases prints its seconds on a ``[time]`` line.  Then
one JSON line describing each kernel, and as the last line
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
import warnings

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


def _device_ms(fn, kernel_name: str, launches_per_call: int = 1, reps: int = 20,
               attempts: int = 3):
    """Device time per call of the kernels whose name holds
    ``kernel_name``, from ``torch.profiler``: their mean time per launch
    times ``launches_per_call``, and the launches it recorded per call.
    The profiler may drop an event or two, and late in a long process it
    has recorded none in a session: such a session is run again, up to
    ``attempts`` in all (nan, 0 if none recorded any)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel_name in e.key]
        us, count = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
        if us > 0 and count > 0:
            return us / 1e3 / count * launches_per_call, count / reps
    return float("nan"), 0.0


def phase_env():
    import torch
    card = _card()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(card)
    return card


H100_BYTES_PER_S = 3.35e12     # HBM3, the H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores, same sheet


def _mark(mask, base, size: int, off: int) -> None:
    """Mark in ``mask`` [H, W] the size x size patches whose corners are
    ``base - off`` (base [M, 2] int64 as x, y)."""
    import torch
    a = torch.arange(size, device=mask.device)
    ys = (base[:, 1] - off)[:, None] + a
    xs = (base[:, 0] - off)[:, None] + a
    mask.view(-1)[(ys[:, :, None] * mask.shape[1] + xs[:, None, :]).reshape(-1)] = True


def _klt_bound(passes, schedule, win: int):
    """The least time one ``fb_klt_track`` call could take on the card for
    this run's data.  ``passes`` are the level calls of the plain
    composition on the same inputs (images, template points, guesses and
    valid masks as it ran them), ``schedule`` their (level, R, iters,
    backward).  What each point needs: a forward pass at a coarser level
    only if the point is valid; the forward pass at level 0 always (its
    error is returned); the backward pass only if the forward status holds.
    Within a needed pass the template (blend, gradients, five sums), then
    the volumes (4 (2R+1)^2 win^2 operations) and the search patch only if
    the point can iterate (valid for the pass and trackable), and the
    window error where the search patch is needed.  Bytes: every pixel of
    every level that a needed patch covers, read once (the union over
    points and passes: the backward pass reads what level 0's forward pass
    read, from the other image), the points in and the results out once.
    Gauss-Newton steps are left out: their number depends on when each
    point freezes, and they are at most 45 operations a step, under 3% of
    a pass's volumes.  Returns (bytes, flops, bound_ms, bound_by)."""
    import torch
    from alvaar_tpu_torch.ops.lk_level import template_terms
    r, nw, blend = win // 2, win * win, win + 2
    n = passes[0][2].shape[0]
    masks, flops = {}, 0
    mask_of = lambda img: masks.setdefault(
        img.data_ptr(), torch.zeros(img.shape, dtype=torch.bool, device=img.device))
    n_forward = sum(1 for ps in schedule if not ps[3])
    for i, ((img_prev, img_cur, tpts, guess, valid, R), (_, _, _, bwd)) in enumerate(
            zip(passes, schedule)):
        h, w = img_cur.shape
        cr, margin = 2 * R + 1, R + r + 1
        level0 = i == n_forward - 1
        every = torch.ones_like(valid)
        trackable = template_terms(img_prev, tpts, win)[-1]
        need_tpl = every if level0 else valid
        need_vol = valid & trackable
        need_search = every if level0 else need_vol
        base_t = torch.floor(tpts).to(torch.int64)
        base_t = torch.stack([base_t[:, 0].clamp(r + 2, w - r - 4),
                              base_t[:, 1].clamp(r + 2, h - r - 4)], dim=1)
        base_j = torch.floor(guess + 0.5).to(torch.int64)
        base_j = torch.stack([base_j[:, 0].clamp(margin, w - margin - 1),
                              base_j[:, 1].clamp(margin, h - margin - 1)], dim=1)
        _mark(mask_of(img_prev), base_t[need_tpl], win + 3, r + 1)
        _mark(mask_of(img_cur), base_j[need_search], 2 * R + win, margin - 1)
        flops += (int(need_tpl.sum()) * (11 * blend * blend + 14 * nw + 20)
                  + int(need_vol.sum()) * 4 * cr * cr * nw + int(need_search.sum()) * 24 * nw)
    nbytes = 4 * sum(int(m.sum()) for m in masks.values()) + n * (8 + 8 + 1 + 8 + 1 + 4)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOP_PER_S
    return nbytes, flops, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _level_kernel_fn(src):
    """The per-level kernel of the one-launch-per-level design
    (``lk_level_launch`` in csrc/lk_level.cu of commit 6b890e1), built from
    ``src``, as a ``level_fn`` for ``fb_klt_track``."""
    import ctypes
    from pathlib import Path
    import torch
    from alvaar_tpu_torch.ops import lk_level as lk
    lib = ctypes.CDLL(str(lk.build_kernel(src=Path(src))))
    fn = lib.lk_level_launch
    fn.restype = ctypes.c_int
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, I, I, P, P, P, I, I, I, I, F, F, P, P, P, P]

    def level(img_prev, img_cur, pts_prev, guess, valid, *, win, iters, eps, search_r):
        (h, w), n, dev = img_cur.shape, pts_prev.shape[0], img_cur.device
        xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
        ok = torch.empty((n,), dtype=torch.bool, device=dev)
        err = torch.empty((n,), dtype=torch.float32, device=dev)
        rc = fn(img_prev.data_ptr(), img_cur.data_ptr(), h, w, pts_prev.data_ptr(),
                guess.data_ptr(), valid.data_ptr(), n, win, search_r, iters, float(eps * eps),
                float(lk.MIN_EIG), xy.data_ptr(), ok.data_ptr(), err.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check(rc == 0, f"per-level kernel launch failed: cudaError_t {rc}")
        return xy, ok, err

    level.lib = lib          # keep the library loaded
    return level


def phase_kernel(frames, card):
    """Phase 2: the fused KLT kernel against its plain composition, its
    one-pass use (lk_level), its times, bounds, and the per-level design."""
    import torch
    from alvaar_tpu_torch.config import SlamConfig
    from alvaar_tpu_torch.ops import lk_level as lk
    from alvaar_tpu_torch.ops.detect import detect_grid
    from alvaar_tpu_torch.ops.image import build_pyramid
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal

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
    win = cfg.klt_window
    args = dict(win=win, iters=cfg.klt_iters, eps=cfg.klt_eps,
                err_max=cfg.klt_err_max, fb_dist=cfg.klt_fb_dist)
    n48 = cfg.klt_stage2_slots
    sub = torch.stack(torch.meshgrid(torch.arange(4.0), torch.arange(4.0), indexing="xy"),
                      -1).reshape(16, 1, 2).to(dev) / 4.0
    wide = (det.xy[None] + sub).reshape(-1, 2).contiguous()          # 3072 points
    cases = {
        "stage1 N=192 levels=1 R=4": (det.xy, det.valid, 1, 4),
        "stage2 N=192 levels=3 R=8": (det.xy, det.valid, 3, 8),
        "stage2 N=48 levels=3 R=8": (det.xy[:n48].contiguous(), det.valid[:n48], 3, 8),
        "stage2 N=3072 levels=3 R=8": (wide, det.valid.repeat(16), 3, 8),
    }
    old_src = os.path.join(ROOT, "build", "lk_level_6b890e1.cu")
    old = _level_kernel_fn(old_src) if os.path.exists(old_src) else None
    if old is None:
        print(f"[kernel] per-level design: not measured ({os.path.relpath(old_src, ROOT)} "
              f"absent; `git show 6b890e1:alvaar_tpu_torch/csrc/lk_level.cu` writes it)")

    max_err, shapes = 0.0, []
    for name, (pts, valid, levels, R) in cases.items():
        run = lambda level_fn=None: fb_klt_track(pyr0, pyr1, pts, pts, valid, levels=levels,
                                                 search_r=R, level_fn=level_fn, **args)
        passes = []       # the plain composition's level calls, for the bound

        def record(img_prev, img_cur, pts_prev, guess, valid_p, **kw):
            passes.append((img_prev, img_cur, pts_prev, guess, valid_p, kw["search_r"]))
            return lk.lk_level_plain(img_prev, img_cur, pts_prev, guess, valid_p, **kw)

        rk, rp = run(), run(record)
        torch.cuda.synchronize()
        sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
        dxy = float((rk.xy - rp.xy).abs().max())
        derr = float((rk.err - rp.err).abs().max())
        bit_equal = (torch.equal(rk.xy, rp.xy) and torch.equal(rk.err, rp.err)
                     and torch.equal(rk.status, rp.status))
        print(f"[kernel] {name}: tracked kernel {int(sk.sum())} plain {int(sp.sum())} "
              f"of {int(valid.sum())}, status mismatches {int((sk != sp).sum())}, "
              f"max|dxy| {dxy:.3e} px, max|derr| {derr:.3e}, bit-equal {bit_equal}")
        _check((sk == sp).all(), f"{name}: kernel and plain statuses differ")
        _check(dxy <= 1e-5, f"{name}: |dxy| {dxy} > 1e-5 px")
        _check(derr <= 1e-5, f"{name}: |derr| {derr} > 1e-5")
        _check(int(sk.sum()) > (50 if len(sk) > n48 else 20),
               f"{name}: only {int(sk.sum())} tracked")
        max_err = max(max_err, dxy, derr)

        schedule = lk.klt_schedule(levels, R, cfg.klt_iters)
        nbytes, flops, bound_ms, bound_by = _klt_bound(passes, schedule, win)
        reps = 5 if len(pts) > 192 else 20
        ms_plain_a = _time_ms(lambda: run(lk.lk_level_plain), reps=reps, rounds=3)
        ms_a = _time_ms(run)
        ms_b = _time_ms(run)
        ms_plain_b = _time_ms(lambda: run(lk.lk_level_plain), reps=reps, rounds=3)
        dev_a, n_a = _device_ms(run, "klt_track_kernel")
        row = dict(shape=name, n=len(pts), bytes=nbytes, flops=flops, bound_ms=bound_ms,
                   bound_by=bound_by, ms=statistics.median([ms_a, ms_b]),
                   plain_ms=statistics.median([ms_plain_a, ms_plain_b]),
                   launches_per_call=n_a, bit_equal=bit_equal, max_abs_err=max(dxy, derr))
        line = (f"[kernel] {name}: fused {row['ms']:.4f} ms per call ({ms_a:.4f}, {ms_b:.4f}; "
                f"CUDA events around back-to-back calls), plain composition "
                f"{row['plain_ms']:.4f} ms ({ms_plain_a:.4f}, {ms_plain_b:.4f})")
        if old is not None:
            ro = run(old)
            _check(torch.equal(ro.status, rp.status), f"{name}: per-level design's statuses differ")
            old_a, old_n = _device_ms(lambda: run(old), "lk_level_kernel", len(schedule))
            old_b, _ = _device_ms(lambda: run(old), "lk_level_kernel", len(schedule))
            dev_b, _ = _device_ms(run, "klt_track_kernel")
            row["device_ms"] = statistics.median([dev_a, dev_b])
            row["old_device_ms"] = statistics.median([old_a, old_b])
            row["old_launches_per_call"] = old_n
            row["old_ms"] = _time_ms(lambda: run(old))
            line += (f"; device time fused {row['device_ms']:.5f} ms ({dev_a:.5f}, {dev_b:.5f}) "
                     f"in {n_a} launch, per-level design {row['old_device_ms']:.5f} ms "
                     f"({old_a:.5f}, {old_b:.5f}) in {old_n} launches, "
                     f"{row['old_ms']:.4f} ms per call by events")
        else:
            row["device_ms"] = dev_a
            line += f"; device time fused {dev_a:.5f} ms in {n_a} launch"
        print(line + f" (torch.profiler); bound {bound_ms * 1e3:.4f} us by {bound_by} "
              f"({nbytes / 1e3:.1f} KB, {flops / 1e6:.2f} MFLOP) [{card}]")
        _check(0 < n_a <= 1, f"{name}: {n_a} kernel launches per fb_klt_track call")
        shapes.append(row)

    for b, stagger in ((BATCH_STREAMS, 3), (WIDE_STREAMS, 1)):
        f_prev = torch.as_tensor(np.stack([frames[stagger * i] for i in range(b)]), device=dev)
        f_cur = torch.as_tensor(np.stack([frames[stagger * i + 1] for i in range(b)]), device=dev)
        shapes.append(_batched_shape(f_prev, f_cur, cfg, card))
        max_err = max(max_err, shapes[-1]["max_abs_err"])

    # klt_pyramidal: the same kernel with the forward passes only
    klt_pyramidal.launches = 0
    fwd = lambda level_fn=None: klt_pyramidal(
        pyr0, pyr1, det.xy, det.xy, det.valid, levels=3, win=win, iters=cfg.klt_iters,
        eps=cfg.klt_eps, err_max=cfg.klt_err_max, search_r=8, level_fn=level_fn)
    a, b = fwd(), fwd(lk.lk_level_plain)
    _check(klt_pyramidal.launches == 1, "klt_pyramidal did not launch the kernel once")
    dxy, derr = float((a.xy - b.xy).abs().max()), float((a.err - b.err).abs().max())
    equal = torch.equal(a.xy, b.xy) and torch.equal(a.err, b.err) and torch.equal(a.status, b.status)
    print(f"[kernel] klt_pyramidal (forward only, N=192, 3 levels, R=8): tracked "
          f"{int(a.status.sum())}, bit-equal to the plain composition {equal}, "
          f"max|dxy| {dxy:.3e} px, max|derr| {derr:.3e}")
    _check(torch.equal(a.status, b.status), "klt_pyramidal: kernel and plain statuses differ")
    _check(max(dxy, derr) <= 1e-5, f"klt_pyramidal: |dxy| {dxy}, |derr| {derr} > 1e-5")
    _check(int(a.status.sum()) > 50, "klt_pyramidal: too few tracked")
    max_err = max(max_err, dxy, derr)

    # lk_level: the same kernel with a one-pass schedule, no gates
    guess = det.xy + torch.tensor([1.5, 0.5], device=dev)
    call = lambda fn: fn(pyr0[0], pyr1[0], det.xy, guess, det.valid, win=win,
                         iters=cfg.klt_iters, eps=cfg.klt_eps, search_r=4)
    lk.lk_level.launches = 0
    a, b = call(lk.lk_level), call(lk.lk_level_plain)
    _check(lk.lk_level.launches == 1, "lk_level did not launch the kernel")
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"[kernel] lk_level (one pass, N=192, R=4): bit-equal to lk_level_plain {equal}, "
          f"max|dxy| {float((a[0] - b[0]).abs().max()):.3e}")
    _check(torch.equal(a[1], b[1]), "lk_level: kernel and plain statuses differ")
    _check(float((a[0] - b[0]).abs().max()) <= 1e-5, "lk_level: |dxy| > 1e-5")
    return max_err, shapes


BATCH_STREAMS = 16         # the multi-stream path's width (phase 6)
WIDE_STREAMS = 48          # phase 6d's width


def _batched_shape(f_prev, f_cur, cfg, card, bit_equal_bar=False):
    """A stream-batched stage-2 call (phases 2 and 8): one ``fb_klt_track``
    launch over B streams x K points, stream b tracked from ``f_prev[b]``
    to ``f_cur[b]`` ([B, H, W] on the card) as the step tracks them: the
    points detected on ``f_prev[b]`` at ``cfg``'s cell, scaled to pyramid
    level ``cfg.track_base_level``, on the levels from there down (stage
    2's schedule, R = 8).  Held to the per-stream plain composition (bit
    for bit with ``bit_equal_bar``); its device time beside B single-stream
    calls in the same process, and the bound summed over the streams'
    points."""
    import torch
    from alvaar_tpu_torch.ops import lk_level as lk
    from alvaar_tpu_torch.ops.detect import detect_grid
    from alvaar_tpu_torch.ops.image import build_pyramid
    from alvaar_tpu_torch.ops.klt import fb_klt_track

    dev, B, (h, w) = f_prev.device, f_prev.shape[0], f_prev.shape[1:]
    base, R = cfg.track_base_level, 8
    levels = max(1, cfg.pyramid_levels - base)
    args = dict(win=cfg.klt_window, iters=cfg.klt_iters, eps=cfg.klt_eps,
                err_max=cfg.klt_err_max, fb_dist=cfg.klt_fb_dist)
    dets = [detect_grid(f, torch.zeros((0, 2), device=dev),
                        torch.zeros(0, dtype=torch.bool, device=dev),
                        cell=cfg.cell_size, border=cfg.image_border) for f in f_prev]
    pts = (torch.cat([d.xy for d in dets]) / float(2 ** base)).contiguous()
    valid = torch.cat([d.valid for d in dets]).contiguous()
    pyr_p = build_pyramid(f_prev, cfg.pyramid_levels)[base:]
    pyr_c = build_pyramid(f_cur, cfg.pyramid_levels)[base:]
    _check(all(lv.is_contiguous() for lv in pyr_p + pyr_c), "stacked levels not contiguous")
    k = pts.shape[0] // B
    run = lambda level_fn=None: fb_klt_track(pyr_p, pyr_c, pts, pts, valid, levels=levels,
                                             search_r=R, level_fn=level_fn, **args)
    singles = [([lv[b] for lv in pyr_p], [lv[b] for lv in pyr_c], slice(b * k, (b + 1) * k))
               for b in range(B)]
    run_singles = lambda: [fb_klt_track(p, c, pts[s], pts[s], valid[s], levels=levels,
                                        search_r=R, **args) for p, c, s in singles]
    passes = [[] for _ in range(B)]       # the plain composition's level calls per stream
    counter = iter(range(10 ** 9))

    def record(img_prev, img_cur, pts_prev, guess, valid_p, **kw):
        passes[next(counter) // len(schedule)].append(
            (img_prev, img_cur, pts_prev, guess, valid_p, kw["search_r"]))
        return lk.lk_level_plain(img_prev, img_cur, pts_prev, guess, valid_p, **kw)

    schedule = lk.klt_schedule(levels, R, cfg.klt_iters)
    fb_klt_track.launches = 0
    rk = run()
    _check(fb_klt_track.launches == 1, "the batched call did not launch the kernel once")
    rp = run(record)
    torch.cuda.synchronize()
    where = "" if base == 0 else f"{w}x{h} from level {base} "
    name = f"stage2 {where}B={B}x{k} levels={levels} R={R} (stream-batched)"
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    dxy = float((rk.xy - rp.xy).abs().max())
    derr = float((rk.err - rp.err).abs().max())
    bit_equal = (torch.equal(rk.xy, rp.xy) and torch.equal(rk.err, rp.err)
                 and torch.equal(rk.status, rp.status))
    print(f"[kernel] {name}: tracked kernel {int(sk.sum())} plain {int(sp.sum())} of "
          f"{int(valid.sum())}, status mismatches {int((sk != sp).sum())}, max|dxy| {dxy:.3e} px, "
          f"max|derr| {derr:.3e}, bit-equal to the per-stream plain composition {bit_equal}")
    _check((sk == sp).all(), f"{name}: kernel and plain statuses differ")
    _check(max(dxy, derr) <= 1e-5, f"{name}: |dxy| {dxy}, |derr| {derr} > 1e-5")
    _check(bit_equal or not bit_equal_bar, f"{name}: not bit-equal to the plain composition")
    _check(int(sk.sum()) > 50 * B, f"{name}: only {int(sk.sum())} tracked")
    ones = [fb_klt_track(p, c, pts[s], pts[s], valid[s], levels=levels, search_r=R, **args)
            for p, c, s in singles]
    _check(all(torch.equal(o.xy, rk.xy[s]) and torch.equal(o.status, rk.status[s])
               for o, (_, _, s) in zip(ones, singles)),
           f"{name}: the batched launch differs from the single-stream launches")

    totals = [_klt_bound(ps, schedule, cfg.klt_window) for ps in passes]
    nbytes, flops = sum(t[0] for t in totals), sum(t[1] for t in totals)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOP_PER_S
    bound_ms, bound_by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    dev_a, n_a = _device_ms(run, "klt_track_kernel")
    dev_1, n_1 = _device_ms(run_singles, "klt_track_kernel", launches_per_call=B)
    dev_b, _ = _device_ms(run, "klt_track_kernel")
    ms = _time_ms(run)
    ms_singles = _time_ms(run_singles, reps=5)
    # the plain composition runs stream by stream (seconds per call at
    # 9216 points): timed twice up to 48 streams, once beyond
    wide = B * k > WIDE_STREAMS * 192
    plain_ms = _time_ms(lambda: run(lk.lk_level_plain), reps=1, rounds=1 if wide else 2,
                        warmup=0 if wide else 1)
    row = dict(shape=name, n=len(pts), bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by=bound_by, ms=ms, plain_ms=plain_ms, launches_per_call=n_a,
               device_ms=statistics.median([dev_a, dev_b]), singles_device_ms=dev_1,
               singles_ms=ms_singles, bit_equal=bit_equal, max_abs_err=max(dxy, derr))
    print(f"[kernel] {name}: device time {row['device_ms']:.5f} ms per call ({dev_a:.5f}, "
          f"{dev_b:.5f}) in {n_a} launch, {B} single-stream calls {dev_1:.5f} ms in {n_1:.0f} "
          f"launches (torch.profiler); by events {ms:.4f} ms per call, {B} single-stream calls "
          f"{ms_singles:.4f} ms, per-stream plain composition {plain_ms:.1f} ms; bound "
          f"{bound_ms * 1e3:.4f} us by {bound_by} ({nbytes / 1e3:.1f} KB, {flops / 1e6:.2f} "
          f"MFLOP) [{card}]")
    _check(0 < n_a <= 1, f"{name}: {n_a} kernel launches per call")
    return row


def _drive(slam, frames, tag, after=None):
    """``find_camera_pose`` over ``frames``, synchronised around each
    frame, then ``after(slam)`` outside the timed and counted part.
    Returns per-frame lists: statuses, poses, ms, KLT kernel launches, host
    syncs, keyframe flags, and the bootstrap's kept model (None, or True
    where the homography won).  Every frame at status 1
    must have launched the fused KLT kernel exactly twice (stage 1 and the
    full-width stage 2), and no frame launched it through ``klt_pyramidal``
    or the one-pass ``lk_level``."""
    import torch
    from alvaar_tpu_torch.frontend.step import _try_essential
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.homography import homography_ransac
    from alvaar_tpu_torch.worldmap.keyframe import host_bool

    run = {k: [] for k in ("status", "pose", "ms", "launches", "syncs", "kf", "use_h")}
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, s0, h0 = fb_klt_track.launches, host_bool.syncs, homography_ransac.calls
        p0 = lk_level.launches + klt_pyramidal.launches
        T = slam.find_camera_pose(frame)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["launches"].append(fb_klt_track.launches - l0)
        _check(lk_level.launches + klt_pyramidal.launches == p0,
               f"[{tag}] a KLT launch outside fb_klt_track on the main path")
        run["syncs"].append(host_bool.syncs - s0 + 1)     # + the packed readback
        run["status"].append(slam.last_status)
        run["kf"].append(slam.last_is_keyframe)
        run["pose"].append(T)
        run["use_h"].append(bool(_try_essential.last_use_h)
                            if homography_ransac.calls > h0 else None)
        if after is not None:
            after(slam)
    st = run["status"]
    tracked = [i for i, x in enumerate(st) if x == 1]
    _check(all(run["launches"][i] == 2 for i in tracked),
           f"[{tag}] a frame at status 1 did not launch the KLT kernel exactly twice")
    print(f"[{tag}] statuses {''.join(str(x) for x in st)}")
    print(f"[{tag}] first status 1 at frame {tracked[0] if tracked else None}, "
          f"{len(tracked)}/{len(st)} at status 1, {st.count(2)} resets, KLT launches "
          f"{sum(run['launches'])} ({statistics.median(run['launches'])} per frame; "
          f"{statistics.median([run['launches'][i] for i in tracked]) if tracked else 0} per "
          f"tracking frame), host syncs per frame median {statistics.median(run['syncs'])}")
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
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.fivept import essential_ransac_5pt
    from alvaar_tpu_torch.solvers.homography import homography_ransac
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from render_scene_np import ate_rmse

    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=SlamConfig(), device="cuda")
    fb_klt_track.launches = klt_pyramidal.launches = lk_level.launches = 0
    essential_ransac_5pt.calls = homography_ransac.calls = host_bool.syncs = 0
    run = _drive(slam, frames, "main")
    launches, n5, nh = fb_klt_track.launches, essential_ransac_5pt.calls, homography_ransac.calls
    _check(lk_level.launches == 0 and klt_pyramidal.launches == 0,
           "the main path launched the kernel outside fb_klt_track")
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
    # the port's own parity module (utils/parity.py) on the same run
    from alvaar_tpu_torch.utils.parity import ate_vs_reference, sim3_align_ate
    ate_parity = (100.0 * sim3_align_ate(est, gt[tracked][:, :3, 3]) if len(tracked) > 2
                  else float("inf"))
    poses = np.stack([T if T is not None else np.eye(4) for T in run["pose"]])
    par = ate_vs_reference(np.array(run["status"]), poses, "ref_synthetic_640.npz")
    _check(par is not None, "ate_vs_reference found no overlap with the reference runs")
    print(f"[main] utils/parity: sim3_align_ate {ate_parity:.10f} cm (|diff| to the ATE above "
          f"{abs(ate_parity - ate_cm):.3e} cm); ate_vs_reference_synthetic {par['ate_pct']:.4f}% "
          f"of the span (reference runs' pairwise median {par['ref_noise_median_pct']:.4f}%, max "
          f"{par['ref_noise_pct']:.4f}%; overlap {par['overlap']} frames, parity pass "
          f"{par['parity_pass']}; RPE {par['rpe_trans']:.5f} / {par['rpe_rot_deg']:.4f} deg)")
    _check(abs(ate_parity - ate_cm) <= 1e-9,
           f"utils/parity's ATE {ate_parity} cm differs from {ate_cm} cm")
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
    _check(statistics.median(run["syncs"]) <= 6,
           f"host syncs per frame median {statistics.median(run['syncs'])} > 6")
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
    return slam, launches, run


def phase_eight_point(frames, card):
    """Phase 3b: the first slice's 8-point bootstrap, at a cut depth."""
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.solvers.fivept import essential_ransac_5pt

    cfg = SlamConfig(use_five_point=False, use_homography_init=False)
    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=cfg, device="cuda")
    fb_klt_track.launches = essential_ransac_5pt.calls = 0
    run = _drive(slam, frames[:40], "8pt")
    _check(fb_klt_track.launches > 0, "[8pt] no KLT launch")
    _check(essential_ransac_5pt.calls == 0, "[8pt] the 5-point solver ran")
    _check_bars(run, "8pt", 25, 25)
    print(f"[8pt] frames 20-39 median {statistics.median(run['ms'][20:]):.3f} ms/frame [{card}]")
    return fb_klt_track.launches


def phase_facade(slam, more_frames, card, tmp):
    """Phase 4: the rest of the facade on the phase-3 map."""
    import torch
    from alvaar_tpu_torch import AlvaAR
    from alvaar_tpu_torch.ops.klt import fb_klt_track
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
    fb_klt_track.launches = 0
    sync_st, sync_T = [], []
    for f in more_frames:
        sync_T.append(sync.find_camera_pose(f))
        sync_st.append(sync.last_status)
    print(f"[facade] resumed after load_map on golden frames 120-{119 + len(more_frames)}: "
          f"statuses {''.join(map(str, sync_st))}, KLT launches {fb_klt_track.launches}")
    launches = fb_klt_track.launches
    _check(sync_st[:10] == [1] * 10, "tracking did not resume at status 1 after load_map")

    # async + drain against the synchronous path, from the same checkpoint
    fb_klt_track.launches = 0
    inst = loaded()
    pending = [inst.find_camera_pose_async(f) for f in more_frames]
    PendingResult.drain(pending)
    _check(fb_klt_track.launches > 0, "async path launched no KLT kernel")
    launches += fb_klt_track.launches
    _check([r.status for r in pending] == sync_st, "async statuses differ from the sync path")
    dmax = max((float(np.abs(r.pose - T).max()) for r, T in zip(pending, sync_T)
                if T is not None), default=0.0)
    print(f"[facade] find_camera_pose_async + drain over {len(more_frames)} frames: statuses "
          f"equal to the sync path, max |pose diff| {dmax:.3e}")
    _check(dmax <= 1e-4, f"async poses differ from the sync path by {dmax}")

    # IMU: rotation from the mirrored, inverted quaternion
    fb_klt_track.launches = 0
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
          f"accumulated translation {np.round(T[:3, 3], 4).tolist()}, KLT launches {fb_klt_track.launches}")
    _check(worst <= 1e-6, f"IMU rotation off by {worst}")
    _check(fb_klt_track.launches > 0, "IMU path launched no KLT kernel")
    launches += fb_klt_track.launches

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
    return launches


def phase_loop_closure(card):
    """Phase 5: loop closure at full database size, then end to end."""
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.geom.lie import SE3
    from alvaar_tpu_torch.loopclosure import detector as det
    from alvaar_tpu_torch.ops.klt import fb_klt_track
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
    fb_klt_track.launches = 0
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
          f"KLT launches {fb_klt_track.launches}, {wall:.1f} s [{card}]")
    _check(fb_klt_track.launches > 0, "[loop] no KLT launch")
    _check(statuses.count(1) > 40, "[loop] tracking broke")
    _check(any(i >= len(gt) // 2 for i, _, _ in loops), "[loop] no loop in the return half")
    _check(any(c for _, _, c in loops), "[loop] no correction applied")
    return fb_klt_track.launches


MS_FRAMES = 60             # frames per stream in phase 6
WIDE_FRAMES = 40           # in phase 6d (cut from 60 to keep the smoke near 6 minutes)
MS_KF_SLOTS = 3            # max(3, ceil(16 / 6)), the JAX bench's rule
WIDE_KF_SLOTS = 8          # max(3, ceil(48 / 6)), phase 6d
MS_GATE_SYNCS = 3          # election reads per batched step, whatever B
# all host syncs of a batched step: the election reads and the caller's
# output read, whatever B and kf_slots (no gated phase reads the host)
MS_MAX_SYNCS = 1 + MS_GATE_SYNCS
PROBE_SIZES = (1, 2, 3, 8)     # phase 6a's sub-batch sizes
POSE_Q_TOL, POSE_T_TOL, LM_POS_TOL = 1e-5, 1e-4, 1e-3   # tests/test_torch_subbatch.py's bars
LM_VALID_SLACK = 2


def _wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` synchronised calls."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _q_diff(p, r) -> float:
    """Largest |p - r| over quaternions [..., 4], up to sign."""
    import torch
    sign = torch.sign(torch.sum(p * r, dim=-1, keepdim=True))
    return float((p * sign - r).abs().max())


def _row_diffs(a, b):
    """Two single-stream states at the sub-batch tests' bars: landmarks
    whose ``lm_valid`` differs, integer and bool entries that differ
    outside them, and the largest float differences (pose and keyframe
    poses, q up to sign; ``lm_pos`` on landmarks 3D in both)."""
    import torch
    odd = a.lm_valid != b.lm_valid
    odd_ids = torch.nonzero(odd)[:, 0]
    L = odd.shape[0]
    mismatch = 0
    for (name, x), (_, y) in zip(a.tensors(), b.tensors()):
        if x.dtype.is_floating_point:
            continue
        if x.dim() and x.shape[0] == L:
            x, y = x[~odd], y[~odd]
        elif name in ("kp_lm", "kf_obs_lm"):
            x = torch.where(torch.isin(x, odd_ids), -1, x)
            y = torch.where(torch.isin(y, odd_ids), -1, y)
        mismatch += int((x != y).sum())

    both3d = a.lm_valid & a.lm_is3d & b.lm_valid & b.lm_is3d
    return dict(lm_valid=int(odd.sum()), ints=mismatch,
                q=max(_q_diff(a.pose.q, b.pose.q), _q_diff(a.kf_pose.q, b.kf_pose.q)),
                t=max(float((a.pose.t - b.pose.t).abs().max()),
                      float((a.kf_pose.t - b.kf_pose.t).abs().max())),
                lm_pos=float((a.lm_pos[both3d] - b.lm_pos[both3d]).abs().max())
                if bool(both3d.any()) else 0.0, n3d=int(both3d.sum()))


def _profile_counts(fn):
    """One call under ``torch.profiler``: device kernels launched, their
    summed device ms, host stream synchronisations, and the call's wall
    ms (the profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_us = syncs = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            device_us += e.self_device_time_total
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += e.count
    return kernels, device_us / 1e3, syncs, wall


def phase_subbatch_probe(frames, card):
    """Phase 6a: the keyframe phase on S keyframe-requesting rows at
    640x480, one batched pass (``keyframe_phase_batched``) against the
    composition of rows (``keyframe_phase`` on each row, then
    ``write_rows``), at S = 1, 2, 3 and 8 in turns (rows, batched,
    batched, rows); results held to the CPU tests' bars.  Rows are the
    single stream's track-phase states on golden frames that asked for a
    keyframe: a steady-state keyframe (local BA) first, then the first
    keyframe, the bootstrap pair's second and later ones, repeated to 8."""
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.frontend.step import (keyframe_phase, keyframe_phase_batched,
                                                track_phase)
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from alvaar_tpu_torch.worldmap.state import stack_states, state_row, write_rows

    cfg = SlamConfig()
    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=cfg, device="cuda")
    cam = slam.camera
    fb_klt_track.launches = 0
    kf_frames, before = [], []
    for i, f in enumerate(frames):
        before.append(slam.state)          # the step never writes into its input
        slam.find_camera_pose(f)
        if slam.last_is_keyframe:
            kf_frames.append(i)
        if slam.last_status == 1 and len(kf_frames) >= 5:
            break
    launches = fb_klt_track.launches
    _check(len(kf_frames) >= 5, f"[probe] keyframes at frames {kf_frames}")

    def tracked(i):
        st, fl = track_phase(before[i], torch.as_tensor(frames[i], device="cuda"), cam, cfg)
        _check(bool(fl.kf_req), f"[probe] frame {i} asked for no keyframe")
        return st

    first, pair, later = kf_frames[0], kf_frames[1], kf_frames[2:]
    pool = [tracked(i) for i in [later[-1], first, pair] + later[:-1]]
    pool = (pool * 3)[:max(PROBE_SIZES)]
    print(f"[probe] rows from golden frames: steady keyframe {later[-1]} (next_kf_id "
          f"{int(pool[0].next_kf_id)}), first keyframe {first}, bootstrap pair {pair}, later "
          f"{later[:-1]}; repeated to {max(PROBE_SIZES)}")

    def rows_fn(rows):
        stack = stack_states(rows)
        return lambda: write_rows(stack, list(range(len(rows))),
                                  stack_states(keyframe_phase(r, cam, cfg) for r in rows))

    def batched_fn(rows):
        stack = stack_states(rows)
        return lambda: keyframe_phase_batched(stack, cam, cfg)

    rows_fn(pool[:1])()                      # warm-up: the row path's first BA
    # torch runs an op without a batching rule row by row under vmap (and
    # warns, once enabled): list any such op of the keyframe phase
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        batched_fn(pool[:3])()
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = sorted({str(c.message).split(" for ")[-1].split(".")[0] for c in caught
                        if "batching rule" in str(c.message)})
    print(f"[probe] ops that fell back to a per-row loop under vmap: {fallbacks or 'none'}")
    out, worst = {}, dict(lm_valid=0, ints=0, q=0.0, t=0.0, lm_pos=0.0)
    for S in PROBE_SIZES:
        rows = pool[:S]
        r_fn, b_fn = rows_fn(rows), batched_fn(rows)
        s0 = host_bool.syncs
        got = b_fn()
        _check(host_bool.syncs == s0, "[probe] a host read in the batched pass")
        ref = r_fn()
        for j in range(S):
            d = _row_diffs(state_row(got, j), state_row(ref, j))
            worst = {k: max(worst[k], d[k]) for k in worst}
        ms_r1, ms_b1, ms_b2, ms_r2 = (_wall_ms(r_fn, 1), _wall_ms(b_fn, 1), _wall_ms(b_fn, 1),
                                      _wall_ms(r_fn, 1))
        out[S] = dict(rows=statistics.mean([ms_r1, ms_r2]), batched=statistics.mean([ms_b1, ms_b2]),
                      spread=(ms_r1, ms_r2, ms_b1, ms_b2))
    print("[probe] keyframe phase ms (host clock, synchronised; rows, batched, batched, rows in "
          "turns): " + "; ".join(
              f"S={S}: rows {o['rows']:.1f} batched {o['batched']:.1f} ("
              + ", ".join(f"{x:.1f}" for x in o["spread"]) + ")" for S, o in out.items())
          + f" [{card}]")
    b1, r1 = out[1]["batched"], out[1]["rows"]
    print(f"[probe] batched(S)/batched(1) " + ", ".join(
        f"{out[S]['batched'] / b1:.3f}" for S in PROBE_SIZES) + "; rows(S)/rows(1) " + ", ".join(
        f"{out[S]['rows'] / r1:.3f}" for S in PROBE_SIZES) + f"; batched(1)/rows(1) {b1 / r1:.3f}")
    print(f"[probe] batched against rows, largest over all S: lm_valid differs on {worst['lm_valid']} "
          f"landmarks, {worst['ints']} int/bool entries differ outside them, pose q {worst['q']:.3e}, "
          f"pose t {worst['t']:.3e}, lm_pos {worst['lm_pos']:.3e} (bars {LM_VALID_SLACK}, 0, "
          f"{POSE_Q_TOL}, {POSE_T_TOL}, {LM_POS_TOL})")
    prof = {}
    for tag, fn in (("rows", rows_fn(pool[:3])), ("batched", batched_fn(pool[:3]))):
        prof[tag] = _profile_counts(fn)
    print("[probe] S=3 under torch.profiler: " + "; ".join(
        f"{tag} {k} kernels, {dev:.1f} ms device time in {wall:.1f} ms (busy {dev / wall:.3f}), "
        f"{syncs} host stream syncs" for tag, (k, dev, syncs, wall) in prof.items()) + f" [{card}]")
    _check(worst["lm_valid"] <= LM_VALID_SLACK and worst["ints"] == 0,
           "[probe] batched and row integer fields differ")
    _check(worst["q"] <= POSE_Q_TOL and worst["t"] <= POSE_T_TOL and worst["lm_pos"] <= LM_POS_TOL,
           "[probe] batched and row poses or landmarks differ beyond the bars")
    return launches


class _Staged:
    """Frames [N, B, H, W] held as a stack of the unique frames [M, H, W]
    on the card and each stream's frame index per step, ``at`` [N, B]:
    step i's [B, H, W] is gathered when it is asked for (``frames[i]``)."""

    def __init__(self, stack, at):
        self.stack, self.at = stack, at

    @property
    def shape(self):
        return tuple(self.at.shape) + tuple(self.stack.shape[1:])

    def __getitem__(self, i):
        return self.stack.index_select(0, self.at[i])

    def column(self, k):
        """Stream k alone, [N, 1, H, W]."""
        return _Staged(self.stack, self.at[:, k:k + 1])


def _multistream_run(frames_dev, cfg, cam, kf_slots, tag, card, row=None, of=BATCH_STREAMS):
    """The batched step over staged frames [N, B, H, W] on the card (a
    tensor or a ``_Staged``), each step synchronised and timed, its track
    phase and its keyframe pass timed apart (the rows each pass served
    recorded).  With ``row`` (B = 1), the stream starts from row ``row``
    of a fresh ``of``-stream state, its generator included.  Returns
    per-step lists and the final states."""
    import torch
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.parallel import multistream as ms
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from alvaar_tpu_torch.worldmap.state import stack_states, state_row

    n, b = frames_dev.shape[:2]
    step = ms.make_multistream_step(cfg, cam, kf_slots=kf_slots)
    if row is None:
        states = ms.init_multistream_state(cfg, b, device="cuda")
    else:
        states = stack_states([state_row(
            ms.init_multistream_state(cfg, of, device="cuda"), row)])
    track_ms, kf_passes = [], []
    batched, kf_batched = ms.track_phase_batched, ms.keyframe_phase_batched

    def timed(fn, log, rows=False):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms_ = (time.perf_counter() - t0) * 1e3
            log.append((ms_, ms.num_streams(a[0])) if rows else ms_)
            return out
        return call

    run = {k: [] for k in ("ms", "launches", "gate_syncs", "syncs", "kf", "served", "kf_ms",
                           "status", "pose")}
    dts = torch.ones(b, device="cuda")
    fb_klt_track.launches = klt_pyramidal.launches = lk_level.launches = 0
    ms.multistream_step_local.syncs = host_bool.syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms.track_phase_batched = timed(batched, track_ms)
    ms.keyframe_phase_batched = timed(kf_batched, kf_passes, rows=True)
    try:
        for i in range(n):
            frames_i = frames_dev[i]
            l0, g0, h0 = fb_klt_track.launches, ms.multistream_step_local.syncs, host_bool.syncs
            p0 = len(kf_passes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, out = step(states, frames_i, dts)
            status = out.status.cpu()                    # the caller's output read
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["launches"].append(fb_klt_track.launches - l0)
            run["gate_syncs"].append(ms.multistream_step_local.syncs - g0)
            run["syncs"].append(host_bool.syncs - h0 + 1)
            run["kf"].append(int(out.is_keyframe.sum()))
            run["served"].append(sum(r for _, r in kf_passes[p0:]))
            run["kf_ms"].append(sum(t for t, _ in kf_passes[p0:]))
            _check(len(kf_passes) - p0 <= 1, f"[{tag}] more than one keyframe pass in a step")
            run["status"].append(status.numpy())
            run["pose"].append(out.pose_wc.cpu().numpy())
    finally:
        ms.track_phase_batched, ms.keyframe_phase_batched = batched, kf_batched
    run["track_ms"] = track_ms
    run["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    run["other_launches"] = lk_level.launches + klt_pyramidal.launches
    run["status"], run["pose"] = np.stack(run["status"]), np.stack(run["pose"])
    st = run["status"]
    print(f"[{tag}] B={b} kf_slots={kf_slots}, {n} steps: statuses per stream "
          + " ".join("".join(map(str, st[:, k])) for k in range(b)))
    return states, run


def _ate_cm(r, k, offset, gt):
    """Stream k's sim3-aligned ATE (cm) over its frames at status 1, and
    their count; golden frame ``offset + i`` at step i."""
    from render_scene_np import ate_rmse
    col = min(k, r["status"].shape[1] - 1)
    idx = np.where(r["status"][:, col] == 1)[0]
    if len(idx) < 3:
        return float("inf"), len(idx)
    return 100.0 * ate_rmse(r["pose"][idx, col, :3, 3], gt[offset + idx][:, :3, 3]), len(idx)


def _by_served(run, tag, card, kf_slots):
    """Step ms over steps 10 on, grouped by keyframes served in the step,
    with the gated keyframe pass's own ms.  Returns {served: median ms}."""
    groups = {}
    for t, k, kt in list(zip(run["ms"], run["served"], run["kf_ms"]))[10:]:
        groups.setdefault(k, []).append((t, kt))
    med = {k: statistics.median(t for t, _ in v) for k, v in sorted(groups.items())}
    print(f"[{tag}] steps 10-{len(run['ms']) - 1} by keyframes served (of {kf_slots} slots): "
          + "; ".join(f"{k}: {len(v)} steps, median {med[k]:.1f} ms (keyframe pass "
                      f"{statistics.median(x for _, x in v):.1f} ms), max {max(t for t, _ in v):.1f} ms"
                      for k, v in sorted(groups.items()))
          + f"; slowest step {max(run['ms']):.1f} ms (step {run['ms'].index(max(run['ms']))}, "
          f"{run['served'][run['ms'].index(max(run['ms']))]} served) [{card}]")
    return med


def _check_steps(r, tag, kf_slots):
    _check(all(x == 2 for x in r["launches"][1:]),
           f"[{tag}] a step after the first did not launch the KLT kernel twice")
    _check(r["other_launches"] == 0, f"[{tag}] a KLT launch outside fb_klt_track")
    _check(max(r["gate_syncs"]) == MS_GATE_SYNCS,
           f"[{tag}] election reads {max(r['gate_syncs'])} != {MS_GATE_SYNCS}")
    _check(max(r["syncs"]) <= MS_MAX_SYNCS,
           f"[{tag}] {max(r['syncs'])} host syncs in a step > {MS_MAX_SYNCS}")
    _check(max(r["served"]) <= kf_slots, f"[{tag}] more than {kf_slots} keyframes in a step")


def phase_multistream(frames, gt, card):
    """Phase 6: 16 streams at 640x480, default config, 3 keyframe slots;
    stream b sees golden frames 3b .. 3b + 59.  Then, for every stream, the
    B = 1, one-slot run of its frames through the same step, from the
    same fresh row (its generator included): the ATE bars and the host
    syncs at B = 1.  Returns (launches, stream 0's B = 1 run)."""
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera

    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    B, N = BATCH_STREAMS, MS_FRAMES
    seq = np.stack([np.stack([frames[3 * b + i] for b in range(B)]) for i in range(N)])
    frames_dev = torch.as_tensor(seq, device="cuda")
    states, run = _multistream_run(frames_dev, cfg, cam, MS_KF_SLOTS, "multi", card)
    t0 = time.perf_counter()
    ones = [_multistream_run(frames_dev[:, k:k + 1].contiguous(), cfg, cam, 1,
                             f"multi B=1 stream {k}", card, row=k)[1] for k in range(B)]
    wall_one = time.perf_counter() - t0
    del frames_dev
    one = ones[0]

    st = run["status"]
    n_kf = states.kf_valid.sum(dim=1).cpu().numpy()
    ates = [_ate_cm(run, k, 3 * k, gt) for k in range(B)]
    ates1 = [_ate_cm(ones[k], k, 3 * k, gt) for k in range(B)]
    ratio = [a / a1 for (a, _), (a1, _) in zip(ates, ates1)]
    worst = int(np.argmax(ratio))
    steps = run["ms"][10:]
    fps = (N - 10) * B / (sum(steps) / 1e3)
    gated = [t - tr for t, tr in zip(run["ms"], run["track_ms"])]
    syncs1 = [x for r in ones for x in r["syncs"]]
    print(f"[multi] tracked frames per stream {[int((st[:, k] == 1).sum()) for k in range(B)]}, "
          f"keyframes in the window {n_kf.tolist()}, status-2 reports {int((st == 2).sum())} "
          f"on {int((st == 2).any(axis=0).sum())} streams, first status 1 per stream "
          f"{[int(np.argmax(st[:, k] == 1)) for k in range(B)]}")
    print("[multi] ATE cm per stream (B=16 / its own B=1, 1-slot run, frames at status 1): "
          + ", ".join(f"{k}: {a:.4f}/{a1:.4f} ({n}/{n1})"
                      for k, ((a, n), (a1, n1)) in enumerate(zip(ates, ates1))))
    print(f"[multi] ATE ratio B=16 / B=1 per stream {[round(x, 3) for x in ratio]}: stream 0 "
          f"{ratio[0]:.3f}, median {statistics.median(ratio):.3f}, worst {ratio[worst]:.3f} "
          f"(stream {worst}); median ATE {statistics.median(a for a, _ in ates):.4f} cm (B=16), "
          f"{statistics.median(a for a, _ in ates1):.4f} cm (B=1) (bar 1.5x)")
    print(f"[multi] steps 10-{N - 1}: aggregate {fps:.1f} frames/s ({B} streams), median "
          f"{statistics.median(steps):.2f} ms per step: track phase "
          f"{statistics.median(run['track_ms'][10:]):.2f} ms, gated phases and finalize "
          f"{statistics.median(gated[10:]):.2f} ms; keyframes served per step median "
          f"{statistics.median(run['served'][10:])} (total {sum(run['served'])}); slowest step "
          f"{max(run['ms']):.1f} ms (step {run['ms'].index(max(run['ms']))}); peak device "
          f"memory {run['peak_mib']:.1f} MiB [{card}]")
    _by_served(run, "multi", card, MS_KF_SLOTS)
    print(f"[multi] KLT launches per step {sorted(set(run['launches'][1:]))} (B={B}), "
          f"{sorted({x for r in ones for x in r['launches'][1:]})} (B=1); election reads per "
          f"step median {statistics.median(run['gate_syncs'])} (B={B}) and "
          f"{statistics.median(one['gate_syncs'])} (B=1); all host syncs per step median "
          f"{statistics.median(run['syncs'])} max {max(run['syncs'])} (B={B}), median "
          f"{statistics.median(syncs1)} max {max(syncs1)} (B=1), bound {MS_MAX_SYNCS}; B=1 median "
          f"{statistics.median(one['ms'][10:]):.2f} ms per step, the {B} B=1 runs "
          f"{wall_one:.1f} s [{card}]")
    # a stream that reset starts its map again from a later frame, with
    # its generator advanced: its run is no longer the B = 1 run's, so the
    # ATE bar holds stream 0 and every stream that never reset
    reset = [k for k in range(B) if 2 in st[:, k]]
    barred = [k for k in range(B) if k == 0 or k not in reset]
    print(f"[multi] ATE bar on streams {barred}; reset (ratio printed, no bar): {reset}")
    for k in range(B):
        _check(1 in st[:, k], f"[multi] stream {k} never tracked")
        _check(2 not in ones[k]["status"], f"[multi B=1] stream {k} reset")
    for k in barred:
        _check(ratio[k] <= 1.5, f"[multi] stream {k} ATE {ates[k][0]:.4f} cm > 1.5 x "
               f"{ates1[k][0]:.4f} cm of its B=1 run")
    _check((n_kf >= 2).all(), f"[multi] keyframe starvation: {n_kf.tolist()}")
    for r, tag, slots in ([(run, f"multi B={B}", MS_KF_SLOTS)]
                          + [(r, f"multi B=1 stream {k}", 1) for k, r in enumerate(ones)]):
        _check_steps(r, tag, slots)
    return sum(run["launches"]) + sum(sum(r["launches"]) for r in ones), one


def phase_multistream_wide(frames, gt, one0, card):
    """Phase 6d: 48 streams at 640x480, default config, 8 keyframe slots
    (the JAX bench's max(3, ceil(B / 6))); stream b sees golden frames
    b .. b + 39, staged on the card.  Every stream tracks with >= 2
    keyframes; stream 0's ATE at most 1.5x its B = 1 run (the first 40
    steps of phase 6's: the same fresh row and frames)."""
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera

    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    B, N = WIDE_STREAMS, WIDE_FRAMES
    golden = torch.as_tensor(np.stack(frames[:B + N]), device="cuda")
    at = torch.arange(N, device="cuda")[:, None] + torch.arange(B, device="cuda")[None, :]
    frames_dev = golden[at]                                  # [N, B, H, W]
    del golden
    states, run = _multistream_run(frames_dev, cfg, cam, WIDE_KF_SLOTS, "wide", card)
    del frames_dev
    st = run["status"]
    n_kf = states.kf_valid.sum(dim=1).cpu().numpy()
    one0 = {k: one0[k][:N] for k in ("status", "pose")}      # the same frames
    (a0, n0), (a1, n1) = _ate_cm(run, 0, 0, gt), _ate_cm(one0, 0, 0, gt)
    steps = run["ms"][10:]
    fps = (N - 10) * B / (sum(steps) / 1e3)
    gated = [t - tr for t, tr in zip(run["ms"], run["track_ms"])]
    print(f"[wide] tracked frames per stream {[int((st[:, k] == 1).sum()) for k in range(B)]}, "
          f"keyframes in the window {n_kf.tolist()}, status-2 reports {int((st == 2).sum())} on "
          f"{int((st == 2).any(axis=0).sum())} streams")
    print(f"[wide] stream 0 ATE {a0:.4f} cm ({n0} frames) against {a1:.4f} cm ({n1}) at B=1, "
          f"ratio {a0 / a1:.3f} (bar 1.5x)")
    print(f"[wide] steps 10-{N - 1}: aggregate {fps:.1f} frames/s ({B} streams), median "
          f"{statistics.median(steps):.2f} ms per step: track phase "
          f"{statistics.median(run['track_ms'][10:]):.2f} ms, gated phases and finalize "
          f"{statistics.median(gated[10:]):.2f} ms; keyframes served per step median "
          f"{statistics.median(run['served'][10:])} max {max(run['served'])} (total "
          f"{sum(run['served'])}); host syncs per step max {max(run['syncs'])} (bound "
          f"{MS_MAX_SYNCS}); peak device memory {run['peak_mib']:.1f} MiB [{card}]")
    _by_served(run, "wide", card, WIDE_KF_SLOTS)
    for k in range(B):
        _check(1 in st[:, k], f"[wide] stream {k} never tracked")
    _check((n_kf >= 2).all(), f"[wide] keyframe starvation: {n_kf.tolist()}")
    _check(a0 <= 1.5 * a1, f"[wide] stream 0 ATE {a0:.4f} cm > 1.5 x {a1:.4f} cm")
    _check_steps(run, "wide", WIDE_KF_SLOTS)
    return sum(run["launches"])


def phase_multistream_loop(card):
    """Phase 6b: loop closure inside the keyframe sub-batch, 4 streams, 2
    slots, on phase 5b's 320x240 out-and-back."""
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.parallel import multistream as ms
    from render_scene_np import TwoPlaneScene, trajectory

    cfg = SlamConfig(width=320, height=240, cell_size=24, window_size=10, max_landmarks=512,
                     ransac_iters=50, ba_iters=4, init_parallax_px=12.0, kf_parallax_px=6.0)
    cam = Camera.from_fov(320, 240, 60.0)
    fwd = trajectory(45, step=0.04)
    gt = np.concatenate([fwd, fwd[::-1][1:]], axis=0)
    scene = TwoPlaneScene(np.random.default_rng(11), width=320, height=240, fov=60.0)
    frames = torch.as_tensor(np.stack([scene.render(T) for T in gt]).astype(np.float32),
                             device="cuda")
    B = 4
    step = ms.make_multistream_step(cfg, cam, kf_slots=2, loop_closure=True, loop_delay=4)
    states = ms.init_multistream_state(cfg, B, device="cuda")
    dbs = ms.init_multistream_loopdbs(cfg, B, capacity=64, device="cuda")
    fb_klt_track.launches = 0
    statuses = []
    t0 = time.perf_counter()
    for i in range(len(gt)):
        states, dbs, out = step(states, dbs, frames[i].expand(B, -1, -1))
        statuses.append(out.status.cpu().numpy())
    wall = time.perf_counter() - t0
    launches = fb_klt_track.launches
    st = np.stack(statuses)
    n_entries = (dbs.kf_id >= 0).sum(dim=1).cpu().numpy()
    last = dbs.last_match.cpu().numpy()
    print(f"[multi-loop] B={B} kf_slots=2, {len(gt)} frames: tracked per stream "
          f"{[int((st[:, k] == 1).sum()) for k in range(B)]}, database entries "
          f"{n_entries.tolist()}, last_match {last.tolist()}, KLT launches {launches}, "
          f"{wall:.1f} s [{card}]")
    for k in range(B):
        _check(1 in st[:, k], f"[multi-loop] stream {k} never tracked")
    _check((n_entries >= 2).all(), f"[multi-loop] database starvation {n_entries.tolist()}")
    _check((last >= 0).any(), "[multi-loop] no stream registered a loop")
    return launches


def phase_server(frames, card):
    """Phase 6c: SlamServer with 4 streams at 640x480 on the card, 4
    clients each sending 30 uint8 frames of its slice (client b: golden
    frames 3b ..), then a fifth client on a recycled slot."""
    import threading
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.serving.server import SlamClient, SlamServer

    h, w = frames[0].shape
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    srv = SlamServer(num_streams=4, width=w, height=h, fov=60.0, device="cuda").start()
    results, errors = {}, []

    def client(b):
        try:
            c = SlamClient("127.0.0.1", srv.port, w, h)
            try:
                out = []
                for i in range(30):
                    t0 = time.perf_counter()
                    status, _, _ = c.process(u8[3 * b + i], timeout=300.0)
                    out.append((status, c.last_frame_id == i + 1,
                                (time.perf_counter() - t0) * 1e3))
                results[b] = out
            finally:
                c.close()
        except (OSError, ConnectionError) as e:
            errors.append(f"client {b}: {e!r}")

    fb_klt_track.launches = 0
    try:
        ts = [threading.Thread(target=client, args=(b,)) for b in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        _check(not any(t.is_alive() for t in ts), "[server] a client hung")
        _check(not errors, f"[server] {errors}")
        c = SlamClient("127.0.0.1", srv.port, w, h)
        try:
            status5, _, _ = c.process(u8[0], timeout=300.0)
        finally:
            c.close()
    finally:
        srv.stop()
    _check(srv.engine_error is None, f"[server] engine failed: {srv.engine_error!r}")
    rt = [m for out in results.values() for _, _, m in out]
    print(f"[server] 4 clients x 30 frames: statuses "
          + " ".join("".join(str(x[0]) for x in results[b]) for b in sorted(results))
          + f"; round trip median {statistics.median(rt):.1f} ms, max {max(rt):.1f} ms; a fifth "
          f"client on a recycled slot got status {status5}; frames served {srv.frames_served}, "
          f"KLT launches {fb_klt_track.launches} [{card}]")
    _check(sorted(results) == [0, 1, 2, 3], "[server] a client got no replies")
    _check(all(any(x[0] == 1 for x in out) for out in results.values()),
           "[server] a client never got status 1")
    _check(all(x[1] for out in results.values() for x in out), "[server] reply frame ids differ")
    _check(status5 == 3, f"[server] the recycled slot answered status {status5}, not 3")
    return fb_klt_track.launches


MESH_STREAMS = 8           # phase 6e: B, stream b on golden frames 3b .. 3b + 23
MESH_FRAMES = 24
MESH_KF_SLOTS = 2          # per device, as the JAX package counts them
MESH_TIMED_FROM = 8        # frames/s over steps 8-23


def _sync_all() -> None:
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _mesh_drive(step, blocks, frames_dev, tag, shards):
    """The sharded step over staged frames [N, B, H, W], each step
    synchronised on every card and timed; per step the KLT launches, the
    election reads and all host syncs (the output read included), the
    statuses, keyframes and the blocks' poses (T_cw, gathered on card 0).
    Returns (blocks, run)."""
    import torch
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.parallel import multistream as ms
    from alvaar_tpu_torch.worldmap.keyframe import host_bool

    run = {k: [] for k in ("ms", "launches", "gate_syncs", "syncs", "status", "kf", "q", "t")}
    dev0 = frames_dev.device
    fb_klt_track.launches = ms.multistream_step_local.syncs = host_bool.syncs = 0
    for i in range(frames_dev.shape[0]):
        l0, g0, h0 = fb_klt_track.launches, ms.multistream_step_local.syncs, host_bool.syncs
        _sync_all()
        t0 = time.perf_counter()
        blocks, out = step(blocks, frames_dev[i])
        status = out.status.cpu()                        # the caller's output read
        _sync_all()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["launches"].append(fb_klt_track.launches - l0)
        run["gate_syncs"].append(ms.multistream_step_local.syncs - g0)
        run["syncs"].append(host_bool.syncs - h0 + 1)
        run["status"].append(status.numpy())
        run["kf"].append(out.is_keyframe.cpu().numpy())
        run["q"].append(torch.cat([b.pose.q.to(dev0) for b in blocks]))
        run["t"].append(torch.cat([b.pose.t.to(dev0) for b in blocks]))
    run["status"], run["kf"] = np.stack(run["status"]), np.stack(run["kf"])
    st = run["status"]
    print(f"[{tag}] {shards} shards, B={st.shape[1]}, kf_slots={MESH_KF_SLOTS} per device, "
          f"{st.shape[0]} steps: statuses per stream "
          + " ".join("".join(map(str, st[:, k])) for k in range(st.shape[1])))
    return blocks, run


def _mesh_serial(fresh, devices, frames_dev, cam, cfg):
    """``multistream_step_local`` on each block of ``fresh`` alone, one
    block after the other, from the same fresh rows and generators, with
    the same per-device slots.  Returns the statuses, keyframes and poses
    per step, in stream order."""
    import torch
    from alvaar_tpu_torch.parallel import multistream as ms

    blocks = ms.shard_states(fresh, devices)
    n = ms.num_streams(blocks[0])
    cols = {k: [] for k in ("status", "kf", "q", "t")}
    for k, blk in enumerate(blocks):
        dev = torch.device(devices[k])
        per = {key: [] for key in cols}
        with torch.cuda.device(dev):
            for i in range(frames_dev.shape[0]):
                blk, out = ms.multistream_step_local(
                    blk, frames_dev[i, k * n:(k + 1) * n].to(dev), torch.ones(n, device=dev),
                    cam, cfg, MESH_KF_SLOTS)
                per["status"].append(out.status.cpu().numpy())
                per["kf"].append(out.is_keyframe.cpu().numpy())
                per["q"].append(blk.pose.q.to(frames_dev.device))
                per["t"].append(blk.pose.t.to(frames_dev.device))
        for key in cols:
            cols[key].append(per[key])
    steps = range(frames_dev.shape[0])
    return (np.stack([np.concatenate([c[i] for c in cols["status"]]) for i in steps]),
            np.stack([np.concatenate([c[i] for c in cols["kf"]]) for i in steps]),
            [torch.cat([c[i] for c in cols["q"]]) for i in steps],
            [torch.cat([c[i] for c in cols["t"]]) for i in steps])


def _fps(ms_per_step, b):
    steps = ms_per_step[MESH_TIMED_FROM:]
    return len(steps) * b / (sum(steps) / 1e3)


def phase_mesh(frames, card):
    """Phase 6e: the stream mesh.  B = 8 streams at 640x480,
    ``SlamConfig()``, 2 keyframe slots per device; stream b on golden
    frames 3b .. 3b + 23, staged on card 0.  (a) two shards on one card,
    (b) one shard per visible card; each shard equal to
    ``multistream_step_local`` on its block alone; then the unsharded
    B = 8 step with 4 slots (the same slot total), for frames/s."""
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.parallel import multistream as ms

    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    B, N = MESH_STREAMS, MESH_FRAMES
    seq = np.stack([np.stack([frames[3 * b + i] for b in range(B)]) for i in range(N)])
    frames_dev = torch.as_tensor(seq, device="cuda:0")
    fresh = ms.init_multistream_state(cfg, B, device="cuda:0")
    cards = torch.cuda.device_count()
    layouts = {"mesh a": ["cuda:0", "cuda:0"],
               "mesh b": [f"cuda:{i}" for i in range(cards)]}
    launches, fps = 0, {}
    for tag, devices in layouts.items():
        if B % len(devices):
            print(f"[{tag}] {B} streams do not split over {len(devices)} cards: not run")
            continue
        shards = len(devices)
        step = ms.make_multistream_step(cfg, cam, kf_slots=MESH_KF_SLOTS, devices=devices)
        blocks, run = _mesh_drive(step, ms.shard_states(fresh, devices), frames_dev, tag, shards)
        launches += sum(run["launches"])
        st_ref, kf_ref, q_ref, t_ref = _mesh_serial(fresh, devices, frames_dev, cam, cfg)
        dq = max(_q_diff(a, b) for a, b in zip(run["q"], q_ref))
        dt = max(float((a - b).abs().max()) for a, b in zip(run["t"], t_ref))
        fps[tag] = _fps(run["ms"], B)
        st = run["status"]
        print(f"[{tag}] against each block alone: statuses equal {np.array_equal(st, st_ref)}, "
              f"keyframes served equal {np.array_equal(run['kf'], kf_ref)} "
              f"({int(run['kf'].sum())} in all), pose q {dq:.3e}, t {dt:.3e} (bars "
              f"{POSE_Q_TOL}, {POSE_T_TOL}); KLT launches per step "
              f"{sorted(set(run['launches'][1:]))}, election reads per step "
              f"{sorted(set(run['gate_syncs']))}, host syncs per step max {max(run['syncs'])} "
              f"(bar {MS_MAX_SYNCS * shards}); steps {MESH_TIMED_FROM}-{N - 1}: "
              f"{fps[tag]:.1f} frames/s, median {statistics.median(run['ms'][MESH_TIMED_FROM:]):.1f} "
              f"ms per step [{card}]")
        _check(np.array_equal(st, st_ref), f"[{tag}] statuses differ from the blocks run alone")
        _check(np.array_equal(run["kf"], kf_ref), f"[{tag}] keyframes served differ")
        _check(dq <= POSE_Q_TOL and dt <= POSE_T_TOL, f"[{tag}] poses differ: q {dq}, t {dt}")
        _check(all(x == 2 * shards for x in run["launches"][1:]),
               f"[{tag}] a step after the first did not launch the KLT kernel twice per shard")
        _check(max(run["syncs"]) <= MS_MAX_SYNCS * shards,
               f"[{tag}] {max(run['syncs'])} host syncs in a step > {MS_MAX_SYNCS} per shard")
        _check((st == 1).any(axis=0).all(), f"[{tag}] a stream never reached status 1")
        del blocks

    # the unsharded step, the same streams and the same slot total
    step = ms.make_multistream_step(cfg, cam, kf_slots=MESH_KF_SLOTS * 2)
    states, times = fresh, []
    fb_klt_track.launches = 0
    for i in range(N):
        _sync_all()
        t0 = time.perf_counter()
        states, out = step(states, frames_dev[i])
        out.status.cpu()
        _sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    launches += fb_klt_track.launches
    fps["unsharded"] = _fps(times, B)
    print(f"[mesh] aggregate frames/s over steps {MESH_TIMED_FROM}-{N - 1}, B={B}, one call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in fps.items())
          + f" (mesh a: 2 shards on card 0, {MESH_KF_SLOTS} slots each; mesh b: {cards} "
          f"card(s); unsharded: {MESH_KF_SLOTS * 2} slots); cards visible {cards} [{card}]")
    return launches


INGEST_FRAMES = 60         # phase 7: golden frames 0-59 through the ring
INGEST_IMU_FRAMES = 10     # then 60-69 through find_camera_pose_with_imu
RING_CAPACITY = 8


def phase_ingest(frames, card):
    """Phase 7: host ingest on the card.  A producer thread pushes golden
    frames 0-69, quantised to uint8, through the port's ``FrameRing``
    (``push_gray``, capacity 8, under a semaphore as ``VideoCapture``
    does); ``AlvaAR.find_camera_pose`` consumes frames 0-59 on the card and
    ``find_camera_pose_with_imu`` frames 60-69, fed from an
    ``ImuCapture``.  ``Stats`` times the ring wait and the step."""
    import threading
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.io import FrameRing
    from alvaar_tpu_torch.io.imu import ImuCapture
    from alvaar_tpu_torch.ops.image import rgba_to_gray
    from alvaar_tpu_torch.ops.klt import fb_klt_track
    from alvaar_tpu_torch.utils.stats import Stats

    h, w = frames[0].shape
    n, total = INGEST_FRAMES, INGEST_FRAMES + INGEST_IMU_FRAMES
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames[:total]]
    ring, space, stop, errors = FrameRing(w, h, RING_CAPACITY), threading.Semaphore(RING_CAPACITY), \
        threading.Event(), []

    def produce():
        try:
            for i, g in enumerate(u8):
                while not space.acquire(timeout=0.05):
                    if stop.is_set():
                        return
                if ring.push_gray(g, i / 30.0) < 0:
                    raise RuntimeError("ring overflow despite the semaphore")
        except Exception as e:                  # reported by the consumer
            errors.append(e)

    slam = AlvaAR(w, h, fov=60.0, config=SlamConfig(), device="cuda")
    stats, imu = Stats(window=total), ImuCapture(platform="android")
    angles = np.random.default_rng(9).uniform(-60, 60, (INGEST_IMU_FRAMES, 3))
    run = {k: [] for k in ("status", "pose", "launches", "ms")}
    imu_worst, imu_launches = 0.0, 0
    fb_klt_track.launches = 0
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        for i in range(total):
            stats.start("ring wait")
            while (item := ring.front()) is None:
                _check(producer.is_alive() and not errors, f"[ingest] producer stopped: {errors}")
                time.sleep(0.0002)
            frame = item[0].copy()               # detach from the slot before release
            ring.release()
            space.release()
            stats.stop("ring wait")
            l0 = fb_klt_track.launches
            torch.cuda.synchronize()
            stats.start("find_camera_pose" if i < n else "find_camera_pose_with_imu")
            if i < n:
                T = slam.find_camera_pose(frame)
            else:
                imu.push_orientation(*angles[i - n])
                imu.push_motion(i / 30.0, (0.01, 0.0, 0.0), (0.0, 0.0, 0.1))
                q, motion = imu.snapshot()
                T = slam.find_camera_pose_with_imu(frame, q, motion)
                imu.drain()
                qw, x, y, z = q[0], q[1], -q[2], -q[3]      # conj of (w, -x, y, z)
                R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - qw * z), 2 * (x * z + qw * y)],
                              [2 * (x * y + qw * z), 1 - 2 * (x * x + z * z), 2 * (y * z - qw * x)],
                              [2 * (x * z - qw * y), 2 * (y * z + qw * x), 1 - 2 * (x * x + y * y)]])
                imu_worst = max(imu_worst, float(np.abs(T[:3, :3] - R).max()))
            torch.cuda.synchronize()
            ms_ = stats.stop("find_camera_pose" if i < n else "find_camera_pose_with_imu")
            if i < n:
                run["status"].append(slam.last_status)
                run["pose"].append(T)
                run["launches"].append(fb_klt_track.launches - l0)
                run["ms"].append(ms_)
            else:
                imu_launches += fb_klt_track.launches - l0
    finally:
        stop.set()
        producer.join(timeout=10)
    _check(not producer.is_alive() and not errors, f"[ingest] producer: {errors}")
    launches = sum(run["launches"]) + imu_launches

    # the same uint8 frames fed directly as float32 arrays to a fresh AlvaAR
    direct = AlvaAR(w, h, fov=60.0, config=SlamConfig(), device="cuda")
    fb_klt_track.launches = 0
    d_st, d_T = [], []
    for g in u8[:n]:
        d_T.append(direct.find_camera_pose(g.astype(np.float32)))
        d_st.append(direct.last_status)
    launches += fb_klt_track.launches
    same_pose = all((a is None and b is None) or (a is not None and b is not None
                                                  and np.array_equal(a, b))
                    for a, b in zip(run["pose"], d_T))
    tracked = [i for i, x in enumerate(run["status"]) if x == 1]

    # RGBA through the ring against the port's rgba_to_gray on the card
    g0 = u8[0]
    rgba = np.stack([g0, np.roll(g0, 7, axis=1), 255 - g0, np.full_like(g0, 255)], axis=-1)
    rgba_ring = FrameRing(w, h, 1)
    _check(rgba_ring.push_rgba(rgba) == 0, "[ingest] push_rgba refused")
    native = rgba_ring.front()[0].copy()
    rgba_ring.release()
    on_card = rgba_to_gray(torch.as_tensor(rgba, device="cuda")).cpu().numpy()
    rgba_err = float(np.abs(native - on_card).max())

    steady = run["ms"][20:]
    print(f"[ingest] ring-fed statuses {''.join(map(str, run['status']))}")
    print(f"[ingest] ring-fed against direct-fed ({n} frames): statuses equal "
          f"{run['status'] == d_st}, poses bit-equal {same_pose}; {len(tracked)} at status 1, "
          f"KLT launches per status-1 frame {sorted({run['launches'][i] for i in tracked})}; "
          f"push_rgba against rgba_to_gray on the card: max |diff| {rgba_err:.3e} (bit-equal "
          f"{np.array_equal(native, on_card)}); find_camera_pose_with_imu over "
          f"{INGEST_IMU_FRAMES} frames from ImuCapture: max |R - R(q)| {imu_worst:.2e}, KLT "
          f"launches {imu_launches}")
    print(f"[ingest] Stats (mean over the run): {stats.summary()}; frames 20-{n - 1} median "
          f"{statistics.median(steady):.3f} ms/frame, ring wait median "
          f"{statistics.median(list(stats.stages['ring wait'].samples)):.4f} ms [{card}]")
    _check(run["status"] == d_st, "[ingest] ring-fed statuses differ from direct-fed")
    _check(same_pose, "[ingest] ring-fed poses differ from direct-fed")
    _check(bool(tracked) and all(run["launches"][i] == 2 for i in tracked),
           "[ingest] a status-1 frame did not launch the KLT kernel exactly twice")
    _check(rgba_err <= 1e-3, f"[ingest] push_rgba differs from rgba_to_gray by {rgba_err}")
    _check(imu_worst <= 1e-6, f"[ingest] IMU rotation off by {imu_worst}")
    _check(imu_launches > 0, "[ingest] the IMU path launched no KLT kernel")
    return launches


HD_SEED, HD_TEX_SCALE, HD_FOV = 7, 120.0, 60.0   # the JAX bench's 1080p scene (bench.py:235-266)
HD_STREAMS, HD_KF_SLOTS, HD_FRAMES, HD_STAGGER = 8, 2, 60, 3    # the bench's B, slots, stagger
HD_WIDE_STREAMS, HD_WIDE_KF_SLOTS, HD_WIDE_FRAMES = 64, 11, 48  # max(3, ceil(64 / 6)); stagger 1
HD_WIDE_HELD = 4           # at B = 64, the never-reset streams held to their B = 1 run, besides 0
RENDER_TOL = 1e-6          # the card twin against render_scene_np


class _CardScene:
    """A float64 torch twin of ``render_scene_np.TwoPlaneScene.render`` on
    the card: the numpy scene's textures, the same operations in the same
    order and precision (float64 throughout, but for ``z - t_z``, which
    the numpy renderer takes from a float32 pose: that difference is taken
    by numpy on the host, so it matches whatever NumPy's promotion gives),
    ``fmod`` as NumPy's float ``mod``.  Returns float64 images, as the
    numpy renderer does."""

    def __init__(self, scene, device="cuda"):
        import torch
        f64 = dict(dtype=torch.float64, device=device)
        self.scene, self.f64 = scene, f64
        self.tex = [torch.as_tensor(t, **f64) for t in (scene.tex_a, scene.tex_b)]
        yy, xx = torch.meshgrid(torch.arange(scene.h, **f64), torch.arange(scene.w, **f64),
                                indexing="ij")
        # divide by tensors: a CUDA tensor divided by a Python number is
        # multiplied by its reciprocal
        c = lambda v: torch.tensor(float(v), **f64)
        self.d_cam = torch.stack([(xx - c(scene.cx)) / c(scene.fx),
                                  (yy - c(scene.cy)) / c(scene.fy), torch.ones_like(xx)], dim=-1)

    def _sample(self, tex, u, v):
        import torch
        n = tex.shape[0] - 1.001

        def wrap(x):
            m = torch.fmod(x * self.scene.tex_scale, n)
            return torch.where(m < 0, m + n, m)

        u, v = wrap(u), wrap(v)
        u0, v0 = u.to(torch.int64), v.to(torch.int64)
        fu, fv = u - u0, v - v0
        return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u0 + 1] * (1 - fv) * fu
                + tex[v0 + 1, u0] * fv * (1 - fu) + tex[v0 + 1, u0 + 1] * fv * fu)

    def render(self, T_wc):
        import torch
        s = self.scene
        t = np.asarray(T_wc[:3, 3])
        R = torch.as_tensor(np.asarray(T_wc[:3, :3], np.float64), device=self.d_cam.device)
        o_w = torch.as_tensor(t.astype(np.float64), device=self.d_cam.device)
        d_w = self.d_cam @ R.T
        dz = d_w[..., 2]
        dz = torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
        hits = []
        for z in (s.z_near, s.z_far):
            t_hit = torch.tensor(float(z - t[2]), **self.f64) / dz
            hits.append((t_hit, o_w + d_w * t_hit[..., None]))
        (t_near, p_near), (t_far, p_far) = hits
        use_near = (t_near > 0.1) & (p_near[..., 0] < 0)
        use_far = (t_far > 0.1) & ~use_near
        img = torch.full(dz.shape, 50.0, **self.f64)
        img = torch.where(use_near, self._sample(self.tex[0], p_near[..., 0], p_near[..., 1]), img)
        return torch.where(use_far, self._sample(self.tex[1], p_far[..., 0], p_far[..., 1]), img)


def _hd_serving_run(stack, gt, cfg, cam, B, kf_slots, N, stagger, held_max, one0, card):
    """Phase 8 at one width: B streams, stream b on frames stagger*b ..
    stagger*b + N - 1 of ``stack``, ``kf_slots`` keyframe slots; then the
    B = 1, one-slot run of stream 0 and of every stream that never reset
    (the first ``held_max`` of them when given), each from its own fresh
    row.  ``one0``, stream 0's B = 1 run over at least N of the same
    frames, is reused when given.  Returns (launches, stream 0's B = 1
    run)."""
    import torch
    tag = f"hd B={B}"
    at = (torch.arange(N, device="cuda")[:, None]
          + stagger * torch.arange(B, device="cuda")[None, :])
    staged = _Staged(stack, at)
    states, run = _multistream_run(staged, cfg, cam, kf_slots, tag, card)
    st = run["status"]
    n_kf = states.kf_valid.sum(dim=1).cpu().numpy()
    reset = [k for k in range(B) if 2 in st[:, k]]
    never = [k for k in range(1, B) if k not in reset]
    held = [0] + (never if held_max is None else never[:held_max])
    t0 = time.perf_counter()
    ones, new_ones = {}, []
    for k in held:
        if k == 0 and one0 is not None:
            ones[0] = {key: one0[key][:N] for key in ("status", "pose")}     # the same frames
        else:
            ones[k] = _multistream_run(staged.column(k), cfg, cam, 1, f"{tag} B=1 stream {k}",
                                       card, row=k, of=B)[1]
            new_ones.append((k, ones[k]))
    wall_one = time.perf_counter() - t0
    ates = {k: _ate_cm(run, k, stagger * k, gt) for k in held}
    ates1 = {k: _ate_cm(ones[k], k, stagger * k, gt) for k in held}
    ratio = {k: ates[k][0] / ates1[k][0] for k in held}
    steps = run["ms"][10:]
    fps = (N - 10) * B / (sum(steps) / 1e3)
    gated = [t - tr for t, tr in zip(run["ms"], run["track_ms"])]
    print(f"[{tag}] tracked frames per stream {[int((st[:, k] == 1).sum()) for k in range(B)]}, "
          f"keyframes in the window {n_kf.tolist()}, final statuses {st[-1].tolist()}, first "
          f"status 1 per stream {[int(np.argmax(st[:, k] == 1)) for k in range(B)]}")
    print(f"[{tag}] start-up resets: {int((st == 2).sum())} status-2 reports on {len(reset)} "
          f"streams {reset}")
    print(f"[{tag}] ATE cm, B={B} / its own B=1 1-slot run (frames at status 1), held streams "
          f"{held} (stream 0 and " + ("every stream that never reset" if held_max is None else
                                      f"the first {held_max} that never reset") + "): "
          + ", ".join(f"{k}: {ates[k][0]:.4f}/{ates1[k][0]:.4f} ({ates[k][1]}/{ates1[k][1]}) "
                      f"ratio {ratio[k]:.3f}" for k in held) + " (bar 1.5x)")
    print(f"[{tag}] steps 10-{N - 1}: aggregate {fps:.1f} frames/s ({B} streams at "
          f"{cfg.width}x{cfg.height}), median {statistics.median(steps):.2f} ms per step: track phase "
          f"{statistics.median(run['track_ms'][10:]):.2f} ms, gated phases and finalize "
          f"{statistics.median(gated[10:]):.2f} ms; keyframes served per step median "
          f"{statistics.median(run['served'][10:])} max {max(run['served'])} (total "
          f"{sum(run['served'])}); slowest step {max(run['ms']):.1f} ms (step "
          f"{run['ms'].index(max(run['ms']))}); peak device memory {run['peak_mib']:.1f} MiB "
          f"[{card}]")
    _by_served(run, tag, card, kf_slots)
    syncs1 = [x for _, r in new_ones for x in r["syncs"]]
    print(f"[{tag}] KLT launches per step {sorted(set(run['launches'][1:]))}; election reads per "
          f"step max {max(run['gate_syncs'])}; all host syncs per step median "
          f"{statistics.median(run['syncs'])} max {max(run['syncs'])} (bound {MS_MAX_SYNCS}); the "
          f"{len(new_ones)} B=1 runs run here: {wall_one:.1f} s, host syncs per step max "
          f"{max(syncs1) if syncs1 else None} [{card}]")
    for k in range(B):
        _check(st[-1, k] == 1, f"[{tag}] stream {k} ends at status {st[-1, k]}")
    _check((n_kf >= 2).all(), f"[{tag}] keyframe starvation: {n_kf.tolist()}")
    for k in held:
        _check(2 not in ones[k]["status"], f"[{tag} B=1] stream {k} reset")
        _check(ratio[k] <= 1.5, f"[{tag}] stream {k} ATE {ates[k][0]:.4f} cm > 1.5 x "
               f"{ates1[k][0]:.4f} cm of its B=1 run")
    _check_steps(run, tag, kf_slots)
    for k, r in new_ones:
        _check_steps(r, f"{tag} B=1 stream {k}", 1)
    launches = sum(run["launches"]) + sum(sum(r["launches"]) for _, r in new_ones)
    return launches, one0 if one0 is not None else ones[0]


def phase_hd_serving(card):
    """Phase 8: BASELINE configuration 5, ``hd_serving()`` at 1920x1080,
    on the JAX bench's 1080p scene rendered on the card: K1 at the step's
    level-1 shapes, then B = 8 (2 slots, stagger 3, 60 frames) and B = 64
    (11 slots, stagger 1, 48 frames).  Returns (launches on the main path,
    K1's rows)."""
    import torch
    from alvaar_tpu_torch.config import hd_serving
    from alvaar_tpu_torch.geom.camera import Camera
    from render_scene_np import TwoPlaneScene, trajectory

    cfg = hd_serving()
    cam = Camera.from_fov(cfg.width, cfg.height, HD_FOV)
    M = max(HD_STAGGER * (HD_STREAMS - 1) + HD_FRAMES, HD_WIDE_STREAMS - 1 + HD_WIDE_FRAMES)
    gt = trajectory(M, step=0.04)
    scene = TwoPlaneScene(np.random.default_rng(HD_SEED), width=cfg.width, height=cfg.height,
                          fov=HD_FOV, tex_scale=HD_TEX_SCALE)
    twin = _CardScene(scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = torch.stack([twin.render(T).to(torch.float32) for T in gt])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    diffs = {i: float(np.abs(scene.render(gt[i]) - twin.render(gt[i]).cpu().numpy()).max())
             for i in (0, M - 1)}
    print(f"[hd] hd_serving(): {cfg.width}x{cfg.height}, cell {cfg.cell_size}, grid "
          f"{cfg.grid_cells} = {cfg.max_keypoints} keypoints, KLT from level "
          f"{cfg.track_base_level}, pyramid {cfg.pyr_shapes}")
    print(f"[hd] {M} frames rendered on the card in {render_s:.2f} s, staged as "
          f"{tuple(stack.shape)} float32 ({stack.numel() * 4 / 2 ** 30:.2f} GiB); the card twin "
          f"against render_scene_np: max |diff| " + ", ".join(
              f"frame {i} {d:.3e}" for i, d in diffs.items()) + f" (bar {RENDER_TOL})")
    _check(all(d <= RENDER_TOL for d in diffs.values()),
           f"[hd] the card renderer differs from render_scene_np: {diffs}")

    shapes = []
    for B, stagger in ((HD_STREAMS, HD_STAGGER), (HD_WIDE_STREAMS, 1)):
        first = torch.arange(B, device="cuda") * stagger
        shapes.append(_batched_shape(stack[first], stack[first + 1], cfg, card,
                                     bit_equal_bar=B == HD_STREAMS))
    launches, one0 = _hd_serving_run(stack, gt, cfg, cam, HD_STREAMS, HD_KF_SLOTS, HD_FRAMES,
                                     HD_STAGGER, None, None, card)
    wide, _ = _hd_serving_run(stack, gt, cfg, cam, HD_WIDE_STREAMS, HD_WIDE_KF_SLOTS,
                              HD_WIDE_FRAMES, 1, HD_WIDE_HELD, one0, card)
    return launches + wide, shapes


MAP10K_LANDMARKS = 10240   # BASELINE configuration 4's pool
BA_TIMED_CALLS = 10
BA_CONST_Q_TOL = 2.4e-7    # two float32 ulps at 1: the solver renormalises every pose


def phase_map10k(frames, gt, main_run, card):
    """Phase 9: BASELINE configuration 4, ``SlamConfig(max_landmarks=10240)``:
    (a) ``local_ba`` alone on the JAX bench's problem (bench.py:516-537);
    (b) the golden sequence through ``AlvaAR.find_camera_pose``, against
    phase 3's run (``main_run``) in the same call, then at the default pool
    and at this pool again, for the frame times in turns."""
    import torch
    from alvaar_tpu_torch import AlvaAR, SlamConfig
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.geom.lie import SE3
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.solvers.ba import BAProblem, local_ba
    from alvaar_tpu_torch.worldmap.keyframe import host_bool
    from render_scene_np import ate_rmse

    cfg = SlamConfig(max_landmarks=MAP10K_LANDMARKS)
    W, K, L = cfg.window_size, cfg.max_keypoints, cfg.max_landmarks
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    dev = torch.device("cuda")
    on = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    # (a) the bench's problem, its draws in its order
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (W, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    obs_lm = np.tile(rng.integers(0, L, (1, K)), (W, 1))
    prob = BAProblem(
        poses=SE3(on(q), on(rng.normal(0, 0.5, (W, 3)), torch.float32)),
        kf_valid=torch.ones(W, dtype=torch.bool, device=dev),
        constant=on(np.arange(W) < 2),
        anchor_kf=on(rng.integers(0, W, L), torch.int64),
        anchor_mxy=on(rng.normal(0, 0.3, (L, 2)), torch.float32),
        invdepth=on(1 / rng.uniform(2, 8, L), torch.float32),
        lm_valid=torch.ones(L, dtype=torch.bool, device=dev),
        obs_lm=on(obs_lm, torch.int64),
        obs_px=on(rng.uniform(20, 460, (W, K, 2)), torch.float32),
        obs_valid=on(rng.random((W, K)) < 0.6))
    call = lambda: local_ba(prob, cam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    finite = all(bool(torch.isfinite(x).all())
                 for x in (res.poses.q, res.poses.t, res.invdepth, res.cost))
    const_dq = float((res.poses.q[:2] - prob.poses.q[:2]).abs().max())
    const_t = torch.equal(res.poses.t[:2], prob.poses.t[:2])
    moved = float((res.poses.t[2:] - prob.poses.t[2:]).abs().max())
    for _ in range(2):
        call()
    times = []
    for _ in range(BA_TIMED_CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    kernels, device_ms, syncs, wall = _profile_counts(call)
    print(f"[map10k] local_ba on the bench's problem (W={W}, K={K}, L={L}, "
          f"{int(prob.obs_valid.sum())} observations valid, {len(np.unique(obs_lm[0]))} landmarks "
          f"observed): poses, inverse depths and cost finite {finite}, cost {float(res.cost):.6g}, "
          f"{int(res.num_obs)} inliers; constant poses: t bit-equal {const_t}, max |dq| "
          f"{const_dq:.3e} (bar {BA_CONST_Q_TOL}); free poses moved up to {moved:.4f}")
    print(f"[map10k] local_ba {statistics.median(times):.3f} ms per call (CUDA events around one "
          f"call, median of {BA_TIMED_CALLS} after 2 warm-up calls; min {min(times):.3f}, max "
          f"{max(times):.3f}); under torch.profiler {kernels} kernels, {device_ms:.3f} ms device "
          f"time in {wall:.1f} ms (busy {device_ms / wall:.3f}), {syncs} host stream syncs per "
          f"call; peak device memory {peak:.1f} MiB above the problem [{card}]")
    _check(finite, "[map10k] local_ba returned non-finite poses, inverse depths or cost")
    _check(const_t and const_dq <= BA_CONST_Q_TOL, "[map10k] local_ba moved a constant pose")

    # (b) the golden sequence at the 10240-landmark pool
    h, w = frames[0].shape
    slam = AlvaAR(w, h, fov=60.0, config=cfg, device="cuda")
    pool = []

    def pool_read(s):   # live landmarks and the highest slot in use, one read
        v = s.state.lm_valid
        ids = torch.arange(1, v.shape[0] + 1, device=v.device)
        return torch.stack([v.sum(), torch.where(v, ids, 0).max()]).tolist()

    fb_klt_track.launches = klt_pyramidal.launches = lk_level.launches = host_bool.syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = _drive(slam, frames, "map10k", lambda s: pool.append(pool_read(s)))
    peak_run = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = fb_klt_track.launches
    _check(lk_level.launches == 0 and klt_pyramidal.launches == 0,
           "[map10k] a KLT launch outside fb_klt_track")
    tracked = [i for i, x in enumerate(run["status"]) if x == 1]
    est = np.stack([run["pose"][i][:3, 3] for i in tracked]) if tracked else None
    ate_cm = 100.0 * ate_rmse(est, gt[tracked][:, :3, 3]) if len(tracked) > 2 else float("inf")
    both = [i for i, (T, T3) in enumerate(zip(run["pose"], main_run["pose"]))
            if T is not None and T3 is not None]
    dpose = max((float(np.abs(run["pose"][i] - main_run["pose"][i]).max()) for i in both),
                default=float("nan"))
    kf_ms = lambda r: [m for m, k in zip(r["ms"][20:], r["kf"][20:]) if k]
    tr_ms = lambda r: [m for m, k in zip(r["ms"][20:], r["kf"][20:]) if not k]
    med = lambda xs: statistics.median(xs) if xs else float("nan")
    live, high = [p[0] for p in pool], [p[1] for p in pool]
    print(f"[map10k] golden sequence at max_landmarks={L}: ATE {ate_cm:.4f} cm (bar "
          f"{REF_ATE_WORST_CM}); statuses equal to phase 3's "
          f"{run['status'] == main_run['status']}, "
          f"max |pose - phase 3's pose| {dpose:.3e} over {len(both)} frames; live landmarks "
          f"max {max(live)} (final {live[-1]}), the pool's high-water mark {max(high)} of {L} "
          f"slots (phase 3's pool: {SlamConfig().max_landmarks}); peak device memory "
          f"{peak_run:.1f} MiB")
    # frame times in turns: the default pool, then this one again, each
    # run with the same per-frame read (phase 3 ran minutes earlier)
    turns = [run]
    for c in (SlamConfig(), cfg):
        fb_klt_track.launches = 0
        turns.append(_drive(AlvaAR(w, h, fov=60.0, config=c, device="cuda"), frames,
                            f"map10k turn, {c.max_landmarks} landmarks", pool_read))
        launches += fb_klt_track.launches
    print(f"[map10k] frames 20-119, keyframe / tracking frames median, in turns at 10240, 4096 "
          f"and 10240 landmarks: " + ", ".join(
              f"{med(kf_ms(r)):.3f} / {med(tr_ms(r)):.3f} ms" for r in turns)
          + f"; phase 3 (4096): {med(kf_ms(main_run)):.3f} / {med(tr_ms(main_run)):.3f} ms "
          f"({len(kf_ms(run))} keyframes); statuses equal in every turn "
          f"{all(r['status'] == run['status'] for r in turns)}; host syncs per frame median "
          f"{statistics.median(run['syncs'])} [{card}]")
    _check_bars(run, "map10k", 25, REF_TRACKED)
    _check(ate_cm <= REF_ATE_WORST_CM, f"[map10k] ATE {ate_cm:.4f} cm > {REF_ATE_WORST_CM} cm")
    _check(all(r["status"] == run["status"] for r in turns), "[map10k] the turns' statuses differ")
    return launches


LOOP_DB_CAPACITY = 256     # phase 10a: the bench's loop-closure databases
BENCH_FRAMES = 12          # phase 10b: python -m alvaar_tpu_torch.bench --frames 12 --skip-aux
BENCH_TIMEOUT_S = 400


def _serial_scatter(arr, idx, values, mask):
    """``arr[idx[i]] = values[i]`` where ``mask[i]``, in order of i: for
    each index the last live write, in numpy."""
    out = arr.copy()
    live = np.flatnonzero(mask)[::-1]
    _, first = np.unique(idx[live], return_index=True)
    keep = live[first]
    out[idx[keep]] = values[keep]
    return out


def check_scatter_order(card, rows=MS_KF_SLOTS, seed=0):
    """``masked_scatter_set`` on the card against a serial loop, at local
    BA's write-back size in the keyframe sub-batch (one write per
    [window, keypoint] cell into the landmark pool, ``rows`` streams under
    ``vmap``) with about eleven writes per written index, most of them
    live: colliding writes must keep the last one, as on the CPU."""
    import torch
    from alvaar_tpu_torch import SlamConfig
    from alvaar_tpu_torch.worldmap.state import masked_scatter_set

    cfg = SlamConfig()
    L, n = cfg.max_landmarks, cfg.window_size * cfg.max_keypoints
    rng = np.random.default_rng(seed)
    bad, collided, unordered = 0, 0, 0
    for width in ((), (3,)):
        arr = rng.normal(size=(rows, L) + width).astype(np.float32)
        idx = rng.integers(0, n // 11, size=(rows, n))
        vals = rng.normal(size=(rows, n) + width).astype(np.float32)
        mask = rng.random((rows, n)) < 0.6
        want = np.stack([_serial_scatter(*(a[r] for a in (arr, idx, vals, mask)))
                         for r in range(rows)])
        dev = [torch.as_tensor(a, device="cuda") for a in (arr, idx, vals, mask)]
        got = torch.func.vmap(masked_scatter_set)(*dev).cpu().numpy()
        one = masked_scatter_set(*(a[0] for a in dev)).cpu().numpy()
        bad += int((got != want).any(axis=tuple(range(2, got.ndim))).sum())
        bad += int((one != want[0]).any(axis=tuple(range(1, one.ndim))).sum())
        for r in range(rows):        # the same writes through index_put_ alone
            plain = torch.cat([dev[0][r], torch.zeros_like(dev[0][r][:1])])
            plain[torch.where(dev[3][r], dev[1][r], L)] = dev[2][r]
            unordered += int((plain[:L].cpu().numpy() != want[r]).any(
                axis=tuple(range(1, want.ndim - 1))).sum())
        collided += int(sum(len(np.unique(idx[r][mask[r]])) < mask[r].sum()
                            for r in range(rows)))
    print(f"[scatter-order] masked_scatter_set on the card, {rows} rows of {n} writes into "
          f"{L} landmarks (vmapped and alone, scalar and 3-vector values), about 11 writes per "
          f"written index: {bad} landmarks differ from the serial loop's last write (through a "
          f"plain index_put_: {unordered}); rows with colliding live writes "
          f"{collided}/{2 * rows} [{card}]")
    _check(collided == 2 * rows, "[scatter-order] no colliding live writes")
    _check(bad == 0, f"[scatter-order] {bad} landmarks keep another write than the last")


def phase_bench_loop(frames, card):
    """Phase 10a: the bench's loop-closure serving stage on phase 6's 16
    staged streams, one timed rep, each step's host time, KLT launches
    and host syncs recorded by wrapping the step the scan builds."""
    import torch
    from alvaar_tpu_torch import SlamConfig, bench
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.ops.klt import fb_klt_track, klt_pyramidal
    from alvaar_tpu_torch.ops.lk_level import lk_level
    from alvaar_tpu_torch.parallel import multistream as ms
    from alvaar_tpu_torch.worldmap.keyframe import host_bool

    cfg = SlamConfig()
    cam = Camera.from_fov(cfg.width, cfg.height, 60.0)
    B, N = BATCH_STREAMS, MS_FRAMES
    seq = np.stack([np.stack([frames[3 * b + i] for b in range(B)]) for i in range(N)])
    frames_dev = torch.as_tensor(seq, device="cuda")
    dts = torch.ones((N, B), device="cuda")
    steps = []
    make_step = ms.make_multistream_step

    def traced(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args, **kwargs):
            l0, h0 = fb_klt_track.launches, host_bool.syncs
            t0 = time.perf_counter()
            out = step(*args, **kwargs)
            steps.append(((time.perf_counter() - t0) * 1e3, fb_klt_track.launches - l0,
                          host_bool.syncs - h0))
            return out
        return run

    fb_klt_track.launches = klt_pyramidal.launches = lk_level.launches = 0
    ms.multistream_step_local.syncs = host_bool.syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms.make_multistream_step = traced
    try:
        fps, tracked, entries, outs = bench.bench_multistream_loop(
            cfg, cam, frames_dev, dts, MS_KF_SLOTS, reps=1, capacity=LOOP_DB_CAPACITY,
            device="cuda")
    finally:
        ms.make_multistream_step = make_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = fb_klt_track.launches
    del frames_dev
    timed = steps[-N:]                   # the warm-up's steps come first
    st = outs[-1][0]
    step_ms = [t for t, _, _ in timed]
    syncs = [h for _, _, h in timed]
    print(f"[bench-loop] B={B} kf_slots={MS_KF_SLOTS}, {N} steps, databases of "
          f"{LOOP_DB_CAPACITY}: aggregate {fps:.2f} frames/s (one rep, the bench's clock), "
          f"median step {statistics.median(step_ms):.2f} ms (host clock per step call), slowest "
          f"{max(step_ms):.1f} ms; tracked median {tracked}/{N} (bar {N // 3}), per stream "
          f"{[int((st[:, k] == 1).sum()) for k in range(B)]}; database entries {entries}; KLT "
          f"launches per step after the first {sorted({x for _, x, _ in timed[1:]})}, "
          f"{launches} in all with the warm-up; host syncs per step median "
          f"{statistics.median(syncs)} max {max(syncs)} (bound {MS_MAX_SYNCS}); peak device "
          f"memory {peak:.1f} MiB [{card}]")
    _check(tracked >= N // 3, f"[bench-loop] tracks only {tracked}/{N} frames")
    _check(np.isfinite(outs[-1][1]).all(), "[bench-loop] non-finite poses")
    _check(min(entries) >= 2, f"[bench-loop] database starvation {entries}")
    _check(all(x == 2 for _, x, _ in timed[1:]),
           "[bench-loop] a step after the first did not launch the KLT kernel twice")
    _check(lk_level.launches == 0 and klt_pyramidal.launches == 0,
           "[bench-loop] a KLT launch outside fb_klt_track")
    _check(max(syncs) <= MS_MAX_SYNCS, f"[bench-loop] {max(syncs)} host syncs in a step")
    return launches


def _json_object(line: str) -> bool:
    try:
        return isinstance(json.loads(line), dict)
    except ValueError:
        return False


def phase_bench_command(card):
    """Phase 10b: the bench's command in a fresh interpreter, its stdout
    contract checked."""
    cmd = [sys.executable, "-m", "alvaar_tpu_torch.bench", "--frames", str(BENCH_FRAMES),
           "--skip-aux"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    heads = [ln for ln in lines if _json_object(ln)]
    for ln in r.stderr.splitlines():
        if ln.startswith(("aux ", "devices", "  ", "multi-stream", "bench total")):
            print(f"[bench-cmd] | {ln}")
    print(f"[bench-cmd] python -m alvaar_tpu_torch.bench --frames {BENCH_FRAMES} --skip-aux: "
          f"exit {r.returncode} in {wall:.1f} s, {len(lines)} stdout lines, {len(heads)} of them "
          f"bare JSON; the last: {lines[-1] if lines else None} [{card}]")
    _check(r.returncode == 0, f"[bench-cmd] exit {r.returncode}: {r.stderr[-3000:]}")
    _check(len(heads) == 2 and heads[0] == heads[1] and lines[-1] == heads[1],
           "[bench-cmd] stdout is not two equal bare-JSON lines with the last line one of them")
    head = json.loads(heads[1])
    _check(head.get("metric") == "multistream_fps_per_chip_640x480"
           and np.isfinite(head.get("value", float("nan"))),
           f"[bench-cmd] headline {head}")


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

    t_phase = [time.perf_counter()]

    def lap(name):
        """Print the seconds since the previous lap: the script's time
        limit is shared by every phase."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    card = phase_env()
    golden = np.load(os.path.join(ROOT, "tests", "golden", "ref_synthetic_640.npz"))
    n = int(golden["n_frames"])
    gt = golden["gt"]
    _check(np.abs(trajectory(n + 45, step=0.04)[:n] - gt).max() < 1e-6,
           "numpy trajectory differs from the golden ground truth")
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640,
                          height=480, fov=60.0, tex_scale=120.0)
    frames = [scene.render(gt[i]).astype(np.float32) for i in range(n)]

    max_err, shapes = phase_kernel(frames, card)
    lap("phases 1-2 (environment, golden frames, kernel build and checks)")
    slam, launches, main_run = phase_main_path(frames, gt, card)
    launches += phase_eight_point(frames, card)
    lap("phases 3, 3b")
    gt_more = trajectory(n + 45, step=0.04)[n:n + 20]
    more = [scene.render(T).astype(np.float32) for T in gt_more]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        launches += phase_facade(slam, more, card, tmp)
    launches += phase_loop_closure(card)
    lap("phases 4, 5")
    launches += phase_subbatch_probe(frames, card)
    lap("phase 6a")
    ms_launches, one0 = phase_multistream(frames, gt, card)
    lap("phase 6")
    launches += ms_launches + phase_multistream_wide(frames, gt, one0, card)
    lap("phase 6d")
    launches += phase_multistream_loop(card)
    launches += phase_server(frames, card)
    lap("phases 6b, 6c")
    launches += phase_mesh(frames, card)
    launches += phase_ingest(frames, card)
    lap("phases 6e, 7")
    hd_launches, hd_shapes = phase_hd_serving(card)
    lap("phase 8")
    shapes += hd_shapes
    max_err = max([max_err] + [row["max_abs_err"] for row in hd_shapes])
    launches += hd_launches + phase_map10k(frames, gt, main_run, card)
    lap("phase 9")
    check_scatter_order(card)
    launches += phase_bench_loop(frames, card)
    phase_bench_command(card)
    lap("phase 10")

    # the top-level numbers are at the heavier main-path call, stage 2 at N=192
    main = shapes[1]
    print(json.dumps({"kernels": [{
        "name": "klt_track", "route": "cuda",
        "source": "alvaar_tpu_torch/csrc/klt_track.cu",
        "replaces": "alvaar_tpu/ops/pallas/lk_kernel.py:173",
        "launches": launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "device_ms": main["device_ms"],
        "shape": main["shape"], "card": card, "shapes": shapes}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
