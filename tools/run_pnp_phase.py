#!/usr/bin/env python3
"""Run chip_smoke.py phase 2c (motion-only PnP's kernel K9) alone, and the
end-to-end phases that K9 serves for two checkouts in turns.

    python3 tools/run_pnp_phase.py [--ab OTHER_ROOT] [--turns 4]

Prints the environment lines of phase 1, builds K9 (the compiler's
register and spill lines printed), and runs ``chip_smoke.phase_pnp_kernel``:
K9 against its plain version and a float64 evaluation of it at every case
of ``PNP_CASES``, then its times at the main path's shapes; the last line
before the turns is the smoke's kernel row for pnp_refine.  Exits non-zero
when a bar fails.  Needs CUDA.

With ``--ab OTHER_ROOT`` it then runs, in turns (other, this, this, other
with four turns; other, this with two), a process per turn that imports
only its own checkout's ``chip_smoke`` and package and runs phase 3 (the
default config over the 120 golden frames), 6 (16 streams), 6d (48
streams), 8 (1080p, B = 8 and 64) and 11a (the FAST and ACCURATE presets)
as that checkout's smoke runs them, each phase's failure printed and the
next phase run; before them, a lone ``pnp_refine`` call at N = 192 (its
host time and CUDA-event time, this checkout's ``chip_smoke._pnp_lone_ms``
timing the turn's own ``pnp_refine``).  In these turns the run digests
are printed, not held (a checkout that changes them on purpose sets its
new ones from such a run), and this checkout's bar on phase 3's kernels
per tracking frame is not held.  From each turn's lines: the lone call's
times, the tracking and keyframe frames' medians
and the kernels per tracking frame of phase 3, the aggregate frames/s of
phases 6, 6d and 8, the presets' tracking and keyframe frames' medians, and
the digests; printed per turn and as medians per checkout
(tools/ab_turns.py), and written, with each turn's log, to ``--out``
(default ``build/pnp_ab/``).  Place the other checkout under the
git-ignored ``build/`` before the call, e.g.
``mkdir -p build/parent && git archive COMMIT | tar -x -C build/parent``:
the checkout the chip runs is not a git repository.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_turns  # noqa: E402  (tools/, beside this file)

ROOT = ab_turns.ROOT
AB_DIR = os.path.join(ROOT, "build", "pnp_ab")

# (key, pattern, groups): what each turn's lines give
PATTERNS = (
    ("track_ms", r"\[main\] frames 20-119 by kind: \d+ tracking frames median ([\d.]+) ms", float),
    ("keyframe_ms", r"\[main\] frames 20-119 by kind: .* keyframes median ([\d.]+) ms", float),
    ("kernels_per_tracking_frame", r"\[main\] under torch\.profiler.*kernels per tracking frame "
                                   r"\[([\d, ]+)\]", lambda g: statistics.median(
                                       int(x) for x in g.split(","))),
    ("fps_16", r"\[multi\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_48", r"\[wide\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_1080p_8", r"\[hd B=8\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fps_1080p_64", r"\[hd B=64\] steps 10-\d+: aggregate ([\d.]+) frames/s", float),
    ("fast_track_ms", r"\[preset FAST\] cell .* frames 20-119: \d+ tracking frames median "
                      r"([\d.]+) ms", float),
    ("fast_keyframe_ms", r"\[preset FAST\] cell .* keyframes median ([\d.]+) ms", float),
    ("accurate_track_ms", r"\[preset ACCURATE\] cell .* frames 20-119: \d+ tracking frames "
                          r"median ([\d.]+) ms", float),
    ("accurate_keyframe_ms", r"\[preset ACCURATE\] cell .* keyframes median ([\d.]+) ms", float),
    ("lone_host_ms", r"\[lone\] pnp_refine at N=192: host ([\d.]+) ms", float),
    ("lone_event_ms", r"\[lone\] pnp_refine at N=192: .* ([\d.]+) ms per call by CUDA events",
     float),
    ("digest_main", r"\[main\] statuses \d+; digest of statuses and poses (\w+)", str),
    ("digest_fast", r"\[preset FAST\] statuses \d+; digest of statuses and poses (\w+)", str),
    ("digest_accurate", r"\[preset ACCURATE\] statuses \d+; digest of statuses and poses (\w+)",
     str),
)


def _turn(root: str) -> int:
    """One turn, in a process that imports only ``root``'s checkout."""
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    import chip_smoke as cs
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke")
    from render_scene_np import TwoPlaneScene, trajectory

    cs._check_run_digest = lambda run, tag: print(
        f"[{tag}] digest {cs._run_digest(run)} (printed, not held)")
    cs.PARENT_TRACKING_KERNELS = 10 ** 9      # this checkout's bar: not held here
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

    def lone():
        # this tool's checkout's timing (chip_smoke._pnp_lone_ms) of the turn's
        # own pnp_refine: a lone call as a tracking frame makes it
        import importlib.util
        import torch
        from alvaar_tpu_torch.solvers import pnp
        spec = importlib.util.spec_from_file_location("timing", os.path.join(ROOT, "chip_smoke.py"))
        timing = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(timing)
        rows, cam = cs._pnp_problems(("lone", 192, 1, 4, 0.3, 4, False), torch.device("cuda"))
        host, event = timing._pnp_lone_ms(pnp.pnp_refine, rows[0], cam)
        print(f"[lone] pnp_refine at N=192: host {host:.4f} ms (time.perf_counter, median), "
              f"{event:.4f} ms per call by CUDA events [{card}]")

    attempt("lone", lone)
    attempt("3", lambda: cs.phase_main_path(frames, gt, card))
    multi = attempt("6", lambda: cs.phase_multistream(frames, gt, card))
    if multi is not None:
        attempt("6d", lambda: cs.phase_multistream_wide(frames, gt, multi[1], card))
    attempt("8", lambda: cs.phase_hd_serving(card))
    attempt("11a", lambda: cs.phase_presets(frames, gt, card))
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
    from alvaar_tpu_torch.solvers import pnp_kernel
    if not torch.cuda.is_available():
        print("run_pnp_phase: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    card = chip_smoke.phase_env()
    lib = pnp_kernel.build_kernel(verbose=True)
    print(f"[pnp] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")
    row = chip_smoke.phase_pnp_kernel(card)
    print(f"[time] phase 2c: {time.time() - t0:.1f} s")
    print(json.dumps({"name": "pnp_refine", "card": card, **row}))
    if args.ab:
        return ab_turns.run(__file__, os.path.abspath(args.ab), args.turns,
                            os.path.abspath(args.out), PATTERNS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
