#!/usr/bin/env python3
"""Run chip_smoke.py phase 2d (descriptor Hamming's kernel K4) alone, and
the phases that K4 serves for two checkouts in turns.

    python3 tools/run_hamming_phase.py [--ab OTHER_ROOT] [--turns 4]

Prints the environment lines of phase 1, builds K4 (the compiler's
register and spill lines printed), and runs
``chip_smoke.phase_hamming_kernel``: K4 bit-equal to its plain versions at
every case of ``HAMMING_CASES`` and ``HAMMING_LOOP_CASES``, then its times
at those shapes; the last lines before the turns are the smoke's kernel
rows for hamming_min_crossbag, hamming_best_two and hamming_matrix.  Exits non-zero when a
bar fails.  Needs CUDA.

With ``--ab OTHER_ROOT`` it then runs, in turns (other, this, this, other
with four turns; other, this with two), a process per turn that imports
only its own checkout's ``chip_smoke`` and package and runs: a lone
``hamming_min_crossbag`` call at L = 4096 x K = 192 timed by this
checkout's ``chip_smoke._lone_ms`` (host and CUDA events); then, as that
checkout's smoke runs them, phase 2d (K4's checks and its device time
per shape); each loop query's call (``detect_loop``, ``verify_loop``,
``relocalize_topk`` on phase 5a's database) under the profiler by this
checkout's ``_loop_query_profile`` (kernels, device and event time, K4's
kernels per call); phase 3 with this checkout's profiled frames
(``MAIN_PROFILED``: two keyframe frames among them), whose kernels per
keyframe frame it prints; the keyframe pass of phase 6a at S = 1 and 8
attributed by this checkout's ``_probe_rows`` and ``_pass_attribution``
(the 15 longest kernels, the device time inside local-map matching's
Hamming pass, the busy share); phase 5 (the loop queries' times on a
256-keyframe database); phases 6 (16 streams), 6d (48) and 8 (1080p, B = 8
and 64).  Each phase's failure is printed and the next phase run; the run
digests are printed, not held, and this checkout's bars on phase 3's
kernels are not held.  From each turn's lines: phase 3's frame medians and
kernels, the attribution's numbers, the loop queries' ms, the aggregate
frames/s, the digests, K4's device time per shape and the lone call's
times; printed per turn and as medians per checkout
(tools/ab_turns.py), and written, with each turn's log, to ``--out``
(default ``build/hamming_ab/``).  Place the other checkout under the git-ignored
``build/`` before the call, e.g. ``mkdir -p build/parent && git archive
COMMIT | tar -x -C build/parent``: the checkout the chip runs is not a git
repository.
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
AB_DIR = os.path.join(ROOT, "build", "hamming_ab")

_INTS = lambda g: statistics.median(int(x) for x in g.split(","))
# (key, pattern, conversion): what each turn's lines give
PATTERNS = (
    ("track_ms", r"\[main\] frames 20-119 by kind: \d+ tracking frames median ([\d.]+) ms", float),
    ("keyframe_ms", r"\[main\] frames 20-119 by kind: .* keyframes median ([\d.]+) ms", float),
    ("kernels_per_tracking_frame", r"\[turn\] kernels per tracking frame \[([\d, ]+)\]", _INTS),
    ("kernels_per_keyframe_frame", r"\[turn\] kernels per keyframe frame \[([\d, ]+)\]", _INTS),
    ("pass_s1_kernels", r"\[probe S=1\] under torch\.profiler: (\d+) kernels", int),
    ("pass_s1_device_ms", r"\[probe S=1\] under torch\.profiler: \d+ kernels, ([\d.]+) ms", float),
    ("pass_s1_hamming_ms", r"\[probe S=1\] .*Hamming pass ([\d.]+) ms", float),
    ("pass_s1_busy", r"\[probe S=1\] .*\(busy ([\d.]+)\)", float),
    ("pass_s8_kernels", r"\[probe S=8\] under torch\.profiler: (\d+) kernels", int),
    ("pass_s8_device_ms", r"\[probe S=8\] under torch\.profiler: \d+ kernels, ([\d.]+) ms", float),
    ("pass_s8_hamming_ms", r"\[probe S=8\] .*Hamming pass ([\d.]+) ms", float),
    ("pass_s8_busy", r"\[probe S=8\] .*\(busy ([\d.]+)\)", float),
    ("loop_query_ms", r"\[loop\] detect_loop \+ db_add ([\d.]+) ms per round", float),
    ("relocalize_topk_ms", r"\[loop\] .*relocalize_topk \(top 8, 100 iterations\) ([\d.]+) ms",
     float),
    ("fps_16", r"\[multi\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_48", r"\[wide\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_1080p_8", r"\[hd B=8\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_1080p_64", r"\[hd B=64\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("digest_main", r"\[main\] statuses \d+; digest of statuses and poses (\w+)", str),
    ("lone_host_ms", r"\[turn\] a lone hamming_min_crossbag call .*: host ([\d.]+) ms", float),
    ("lone_event_ms", r"\[turn\] a lone hamming_min_crossbag call .*, ([\d.]+) ms by CUDA",
     float),
) + tuple(  # each loop query's call under the profiler (this checkout's _loop_query_profile)
    (f"{call} {key}", rf"\[loop\] {call} on the 256x192 database: " + pat, conv)
    for call in ("detect_loop", "verify_loop", "relocalize_topk")
    for key, pat, conv in (("kernels", r"(\d+) kernels", int),
                           ("device_ms", r"\d+ kernels, ([\d.]+) ms device", float),
                           ("event_ms", r".*, ([\d.]+) ms per call \(CUDA events\)", float),
                           ("k4_kernels", r".*K4's kernels (\d+)", int))
) + tuple(  # this checkout's best two per loop shape (the other checkout has none)
    (f"best_two_device_ms {name}", re.escape(f"[hamming] best two {name}: ")
     + r"[\d.]+ ms per call \(CUDA events\), device ([\d.]+) ms", float)
    for name in ("192 x 192", "192 x 3072", "192 x 49152", "4 x 192 x 3072")
) + tuple(  # phase 2d's device time per shape, as both checkouts' smokes print it
    (f"device_ms {name}", re.escape(f"[hamming] {name}: ")
     + r"[\d.]+ ms per call \(CUDA events\), device ([\d.]+) ms", float)
    for name in ("L=4096 K=192", "L=4096 K=130", "L=4096 K=352", "L=4096 K=240",
                 "L=10240 K=192", "3 x L=4096 K=192", "8 x L=4096 K=192", "192 x 192",
                 "192 x 3072", "192 x 49152", "4 x 192 x 3072"))


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
    import chip_smoke as cs
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke")
    from render_scene_np import TwoPlaneScene
    this = _this_smoke()

    cs._check_run_digest = lambda run, tag: print(
        f"[{tag}] digest {cs._run_digest(run)} (printed, not held)")
    cs.PARENT_TRACKING_KERNELS = cs.PARENT_KEYFRAME_KERNELS = 10 ** 9   # not held here
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
        from hamming_problems import bag_problem
        from alvaar_tpu_torch.ops import hamming
        x = bag_problem(np.random.default_rng(7), 1, 4096, 192, 6, "matching", "cuda")
        args = [c[0] for c in x]
        host, event = this._lone_ms(lambda: hamming.hamming_min_crossbag(*args))
        print(f"[turn] a lone hamming_min_crossbag call at L=4096 K=192: host {host:.4f} ms "
              f"(median), {event:.4f} ms by CUDA events around back-to-back calls")

    attempt("lone call", lone)
    attempt("2d", lambda: cs.phase_hamming_kernel(card))
    attempt("5a profile", lambda: this._loop_query_profile(card))
    attempt("3", main_path)
    attempt("6a attribution", attribution)
    attempt("5", lambda: cs.phase_loop_closure(card))
    multi = attempt("6", lambda: cs.phase_multistream(frames, gt, card))
    if multi is not None:
        attempt("6d", lambda: cs.phase_multistream_wide(frames, gt, multi[1], card))
    attempt("8", lambda: cs.phase_hd_serving(card))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT")
    ap.add_argument("--turns", type=int, default=4, choices=(2, 4))
    ap.add_argument("--out", default=AB_DIR, help="where the turns' logs and ab.json go")
    ap.add_argument("--turn", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return _turn(os.path.abspath(args.turn))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import chip_smoke
    from alvaar_tpu_torch.ops import hamming_kernel
    if not torch.cuda.is_available():
        print("run_hamming_phase: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    card = chip_smoke.phase_env()
    lib = hamming_kernel.build_kernel(verbose=True)
    print(f"[hamming] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")
    rows = chip_smoke.phase_hamming_kernel(card)
    print(f"[time] phase 2d: {time.time() - t0:.1f} s")
    for name, row in rows.items():
        print(json.dumps({"name": name, "card": card, **row}))
    if args.ab:
        return ab_turns.run(__file__, os.path.abspath(args.ab), args.turns,
                            os.path.abspath(args.out), PATTERNS,
                            echo=("[turn]", "[time]", "[probe S=", "[hamming]", "NVIDIA"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
