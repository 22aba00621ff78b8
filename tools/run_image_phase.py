#!/usr/bin/env python3
"""Run chip_smoke.py phase 2e (the image kernels K7, K5, K3 and K8) alone,
and the phases they serve for two checkouts in turns.

    python3 tools/run_image_phase.py [--clahe-paths] [--ab OTHER_ROOT] [--turns 4] [--times-only]

Prints the environment lines of phase 1, builds the image kernels (the
compiler's register and spill lines printed) and runs
``chip_smoke.phase_image_kernels``: K7 and K5 bit-equal to their plain
versions and K3 at its bar at every case of ``IMAGE_STACK_CASES``,
``IMAGE_PYRAMID_CASES``, ``IMAGE_DETECT_CASES``, ``IMAGE_DETECT_TRAPS``
and ``IMAGE_DESCRIBE_CASES`` and at S = 65 535, their times at those
shapes, and ``AlvaAR`` on golden frames as u8 RGBA; the last lines before
the turns are the smoke's kernel rows for rgba_to_gray, build_pyramid,
detect_grid, describe and clahe.  Exits non-zero when a bar fails.  Needs
CUDA.

With ``--clahe-paths`` it then runs the paths under ``use_clahe=True`` as
the smoke does: phase 3 (the default config, whose kernels per frame the
CLAHE run prints beside its own), phase 11a's CLAHE golden runs at
``CLAHE_SEEDS`` (``chip_smoke.preset_run``, their median ATE held by
``check_clahe_ates``) and phase 6f (16 streams), with the CLAHE runs'
digests printed, not held (the smoke holds them).

With ``--ab OTHER_ROOT`` it then runs, in turns (other, this, this, other
with four turns; other, this with two), a process per turn that imports
only its own checkout's ``chip_smoke`` and package and runs: a lone
640x480 ``build_pyramid`` (3 levels), ``detect_grid`` (cell 40, 120 live
keypoints) and ``describe`` (K = 192) call, each timed by this checkout's
``chip_smoke._lone_ms`` (host and CUDA events); phase 2e's times by this
checkout's ``_image_kernel_times`` (K5's kernels one by one at every
detection case, the 3-level pyramid's and the gray conversion's (u8 RGBA,
float32 RGB) kernels and CUDA-event time at every stack, its device time
also with the L2 emptied before each call, K8's two kernels and CUDA-event
time at every ``IMAGE_CLAHE_CASES`` shape (at 640x480 and 16 x 640x480 its
device time also with the L2 emptied), K3's device and CUDA-event time at every describe case, a merged
pass's N also as two calls of N / 2, as the keyframe pass made them before
commit c08cb84); then, as that checkout's
smoke runs them, phase 3 with this checkout's profiled frames
(``MAIN_PROFILED``: two keyframe frames among them), whose kernels per
tracking and keyframe frame it prints (the kernel bars not held); the keyframe
pass of phase 6a at
S = 1 and 8 attributed by this checkout's ``_probe_rows`` and
``_pass_attribution`` (the 15 longest kernels, the busy share); and phase
6 (16 streams).  Each phase's failure is printed and the next phase run;
the run digests are printed, not held, and the bars on phase 3's kernels
are not held.  From each turn's lines: phase 3's frame medians and
kernels, the attribution's numbers, the aggregate frames/s, the digests
and the lone calls' times; printed per turn and as medians per checkout
(tools/ab_turns.py), and written, with each turn's log, to ``--out``
(default ``build/image_ab/``).  With ``--times-only`` the turns run the
lone calls and phase 2e's times, not phases 3, 6a and 6.  Place the other checkout under the
git-ignored ``build/`` before the call, e.g. ``mkdir -p build/parent &&
git archive COMMIT | tar -x -C build/parent``: the checkout the chip runs
is not a git repository.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_turns  # noqa: E402  (tools/, beside this file)

ROOT = ab_turns.ROOT
AB_DIR = os.path.join(ROOT, "build", "image_ab")
TIMES_ONLY = "RUN_IMAGE_PHASE_TIMES_ONLY"
LONE = ("build_pyramid", "detect_grid", "describe")

_INTS = lambda g: statistics.median(int(x) for x in g.split(","))
DETECT_KERNELS = ("detect_blur_kernel", "detect_cells_kernel", "detect_select_kernel",
                  "detect_rank_kernel")
CLAHE_KERNELS = ("clahe_lut_kernel", "clahe_apply_kernel")
# (key, pattern, conversion): what each turn's lines give
PATTERNS = (
    ("track_ms", r"\[main\] frames 20-119 by kind: \d+ tracking frames median ([\d.]+) ms", float),
    ("keyframe_ms", r"\[main\] frames 20-119 by kind: .* keyframes median ([\d.]+) ms", float),
    ("kernels_per_tracking_frame", r"\[turn\] kernels per tracking frame \[([\d, ]+)\]", _INTS),
    ("kernels_per_keyframe_frame", r"\[turn\] kernels per keyframe frame \[([\d, ]+)\]", _INTS),
    ("pass_s1_kernels", r"\[probe S=1\] under torch\.profiler: (\d+) kernels", int),
    ("pass_s1_device_ms", r"\[probe S=1\] under torch\.profiler: \d+ kernels, ([\d.]+) ms", float),
    ("pass_s1_busy", r"\[probe S=1\] .*\(busy ([\d.]+)\)", float),
    ("pass_s8_kernels", r"\[probe S=8\] under torch\.profiler: (\d+) kernels", int),
    ("pass_s8_device_ms", r"\[probe S=8\] under torch\.profiler: \d+ kernels, ([\d.]+) ms", float),
    ("pass_s8_busy", r"\[probe S=8\] .*\(busy ([\d.]+)\)", float),
    ("fps_16", r"\[multi\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("digest_main", r"\[main\] statuses \d+; digest of statuses and poses (\w+)", str),
) + tuple(
    p for name in LONE for p in (
        (f"lone_{name}_host_ms", rf"\[turn\] a lone {name} call .*: host ([\d.]+) ms", float),
        (f"lone_{name}_event_ms", rf"\[turn\] a lone {name} call .*, ([\d.]+) ms by CUDA",
         float)))


def _split_patterns():
    """The keys of ``_image_kernel_times``' lines: K5's device time per call
    and per kernel at each detection case, the pyramid's device and
    CUDA-event time at each stack, the gray conversion's also with the L2
    emptied before each call, K8's per call and per kernel at each CLAHE
    case (at 640x480 and 16 x 640x480 also with the L2 emptied), K3's at
    each describe case."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = []
    for case in chip_smoke.IMAGE_DETECT_CASES:
        head = rf"\[image-split\] detect_grid {re.escape(case[0])}: device "
        out.append((f"k5 {case[0]} device_ms", head + r"([\d.]+) ms", float))
        out += [(f"k5 {case[0]} {k}_ms", head + rf".*{k} ([\d.]+) ms", float)
                for k in DETECT_KERNELS]
    for case in chip_smoke.IMAGE_STACK_CASES:
        head = rf"\[image-split\] build_pyramid {re.escape(case[0])}: device "
        out += [(f"pyramid {case[0]} device_ms", head + r"([\d.]+) ms", float),
                (f"pyramid {case[0]} event_ms", head + r".*, ([\d.]+) ms per call by CUDA",
                 float)]
        for what in ("u8 RGBA", "float32 RGB"):
            head = rf"\[image-split\] rgba_to_gray {re.escape(case[0])} {what}: device "
            out += [(f"gray {case[0]} {what} device_ms", head + r"([\d.]+) ms", float),
                    (f"gray {case[0]} {what} event_ms",
                     head + r".*, ([\d.]+) ms per call by CUDA", float),
                    (f"gray {case[0]} {what} cold_l2_device_ms",
                     head + r".*, device ([\d.]+) ms with the L2 emptied", float)]
    for case in chip_smoke.IMAGE_CLAHE_CASES:
        head = rf"\[image-split\] clahe {re.escape(case[0])}: device "
        out += [(f"k8 {case[0]} device_ms", head + r"([\d.]+) ms", float),
                (f"k8 {case[0]} event_ms", head + r".*, ([\d.]+) ms per call by CUDA", float),
                (f"k8 {case[0]} cold_l2_device_ms",
                 head + r".*, device ([\d.]+) ms with the L2 emptied", float)]
        out += [(f"k8 {case[0]} {k}_ms", head + rf".*{k} ([\d.]+) ms", float)
                for k in CLAHE_KERNELS]
    for name, *_, merged in chip_smoke.IMAGE_DESCRIBE_CASES:
        for two in (False, True) if merged else (False,):
            what = name + (" as two calls of N / 2" if two else "")
            head = rf"\[image-split\] describe {re.escape(what)}: device "
            key = f"k3 {name}" + (" two calls" if two else "")
            out += [(f"{key} device_ms", head + r"([\d.]+) ms", float),
                    (f"{key} event_ms", head + r".*, ([\d.]+) ms per call by CUDA", float)]
    return tuple(out)


def _this_smoke():
    """This checkout's chip_smoke.py as a module of its own (its functions
    import whichever package comes first on ``sys.path``: the turn's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("this_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _turn(root: str) -> int:
    """One turn, in a process that imports only ``root``'s checkout."""
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    import torch
    import chip_smoke as cs
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke")
    from render_scene_np import TwoPlaneScene
    this = _this_smoke()

    cs._check_run_digest = lambda run, tag: print(
        f"[{tag}] digest {cs._run_digest(run)} (printed, not held)")
    cs.PARENT_TRACKING_KERNELS = cs.PARENT_KEYFRAME_KERNELS = 10 ** 9   # not held here
    cs.IMAGE_PARENT_TRACKING_KERNELS = cs.IMAGE_PARENT_KEYFRAME_KERNELS = 10 ** 9
    cs.IMAGE_PR19_TRACKING_KERNELS = cs.IMAGE_PR19_KEYFRAME_KERNELS = 10 ** 9
    cs.IMAGE_PR20_KEYFRAME_KERNELS = 10 ** 9
    cs.MAIN_PROFILED = this.MAIN_PROFILED
    card = cs.phase_env()
    golden = np.load(os.path.join(root, "tests", "golden", "ref_synthetic_640.npz"))
    gt = golden["gt"]
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640, height=480,
                          fov=60.0, tex_scale=120.0)
    frames = [scene.render(gt[i]).astype(np.float32) for i in range(int(golden["n_frames"]))]
    failed = 0

    def attempt(name, fn):
        nonlocal failed
        t0 = time.time()
        try:
            return fn()
        except Exception as e:          # the next phase still runs
            failed += 1
            print(f"[turn] phase {name} failed: {type(e).__name__}: {e}")
            return None
        finally:
            print(f"[time] phase {name}: {time.time() - t0:.1f} s", flush=True)

    def main_path():
        _, _, run = cs.phase_main_path(frames, gt, card)
        prof = run["prof"]
        print(f"[turn] kernels per tracking frame "
              f"{[p[4] for p in prof if p[1] == 1 and not p[2]]}")
        print(f"[turn] kernels per keyframe frame {[p[4] for p in prof if p[2]]} (frames "
              f"{[p[0] for p in prof if p[2]]})")

    def attribution():
        from alvaar_tpu_torch.frontend.step import keyframe_phase_batched
        from alvaar_tpu_torch.worldmap.state import stack_states
        pool, cam, cfg, _, _ = this._probe_rows(frames)
        for S in (1, max(this.PROBE_SIZES)):
            stack = stack_states(pool[:S])
            this._pass_attribution(lambda: keyframe_phase_batched(stack, cam, cfg),
                                   f"probe S={S}", card)

    def lone():
        from alvaar_tpu_torch.ops.detect import detect_grid
        from alvaar_tpu_torch.ops.image import build_pyramid
        from alvaar_tpu_torch.ops.orb import describe
        dev = torch.device("cuda")
        img = torch.as_tensor(frames[0], device=dev)
        rng = np.random.default_rng(7)        # 120 live keypoints (the other checkout may
        ex = torch.as_tensor(rng.uniform([2, 2], [638, 478], size=(121, 2)).astype(np.float32),
                             device=dev)      # have no tests/image_problems.py)
        exv = torch.arange(121, device=dev) < 120
        q = torch.tensor(0.001, device=dev)
        det = detect_grid(img, ex, exv, cell=40, border=20, quality=q)
        calls = {"build_pyramid": lambda: build_pyramid(img, 3),
                 "detect_grid": lambda: detect_grid(img, ex, exv, cell=40, border=20, quality=q),
                 "describe": lambda: describe(img, det.xy, det.valid)}
        for name in LONE:
            host, event = this._lone_ms(calls[name])
            print(f"[turn] a lone {name} call at 640x480: host {host:.4f} ms (median), "
                  f"{event:.4f} ms by CUDA events around back-to-back calls")

    attempt("lone calls", lone)
    attempt("2e times", lambda: this._image_kernel_times(card))
    if not os.environ.get(TIMES_ONLY):
        attempt("3", main_path)
        attempt("6a attribution", attribution)
        attempt("6", lambda: cs.phase_multistream(frames, gt, card))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT")
    ap.add_argument("--turns", type=int, default=4, choices=(2, 4))
    ap.add_argument("--out", default=AB_DIR, help="where the turns' logs and ab.json go")
    ap.add_argument("--times-only", action="store_true",
                    help="the turns run the lone calls and phase 2e's times only")
    ap.add_argument("--clahe-paths", action="store_true",
                    help="then phase 3, phase 11a's CLAHE run and phase 6f")
    ap.add_argument("--turn", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.times_only:
        os.environ[TIMES_ONLY] = "1"          # the turns' processes inherit it
    if args.turn:
        return _turn(os.path.abspath(args.turn))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    import chip_smoke
    from render_scene_np import TwoPlaneScene
    from alvaar_tpu_torch.ops import image_kernels
    if not torch.cuda.is_available():
        print("run_image_phase: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    card = chip_smoke.phase_env()
    lib = image_kernels.build_kernel(verbose=True)
    print(f"[image] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")
    golden = np.load(os.path.join(ROOT, "tests", "golden", "ref_synthetic_640.npz"))
    scene = TwoPlaneScene(np.random.default_rng(int(golden["seed"])), width=640, height=480,
                          fov=60.0, tex_scale=120.0)
    n = int(golden["n_frames"]) if args.clahe_paths else chip_smoke.IMAGE_RGBA_FRAMES
    frames = [scene.render(golden["gt"][i]).astype(np.float32) for i in range(n)]
    rows = chip_smoke.phase_image_kernels(frames, card)
    print(f"[time] phase 2e: {time.time() - t0:.1f} s")
    for name, row in rows.items():
        print(json.dumps({"name": name, "card": card, **row}))
    if args.clahe_paths:
        from alvaar_tpu_torch import SlamConfig
        gt = golden["gt"]
        held = chip_smoke._check_run_digest
        ates = {}

        def clahe_runs():
            for seed in chip_smoke.CLAHE_SEEDS:
                ates[seed] = chip_smoke.preset_run(seed, frames, gt, card)[2]
            chip_smoke.check_clahe_ates(ates, card)

        for name, fn in (
                ("3", lambda: chip_smoke.phase_main_path(frames, gt, card)),
                ("11a CLAHE", clahe_runs),
                ("6f", lambda: chip_smoke.phase_multistream(
                    frames, gt, card, cfg=SlamConfig(use_clahe=True),
                    n=chip_smoke.CLAHE_MS_FRAMES, tag="multi clahe"))):
            t1 = time.time()
            chip_smoke._check_run_digest = held if name == "3" else (
                lambda run, tag: print(f"[{tag}] digest {chip_smoke._run_digest(run)} "
                                       f"(printed, not held)"))
            chip_smoke._image_zero()
            fn()
            print(f"[time] phase {name}: {time.time() - t1:.1f} s", flush=True)
    if args.ab:
        return ab_turns.run(__file__, os.path.abspath(args.ab), args.turns,
                            os.path.abspath(args.out), PATTERNS + _split_patterns(),
                            echo=("[turn]", "[time]", "[probe S=", "[main] kernels",
                                  "[image-split]", "NVIDIA"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
