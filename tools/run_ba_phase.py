#!/usr/bin/env python3
"""Run chip_smoke.py phase 2b (local BA's kernels) alone, and time local
BA's kernels of two checkouts in turns.

    python3 tools/run_ba_phase.py [--ab OTHER_ROOT]

Prints the environment lines of phase 1, builds the KLT kernel, renders
the 120 golden frames at 640x480, runs phase 3 (the main path, whose
golden keyframes' local-BA problems phase 2b takes; its bars held, its run
digest too) and then ``chip_smoke.phase_ba_kernels``.  Each line carries
the card's name and power limit; the last lines give the kernel rows of
the smoke's ``kernels`` line and the phases' seconds.  Exits non-zero
when a bar fails.  Needs CUDA.

With ``--ab OTHER_ROOT`` it then times K6a (the linearisation and the
residual pass) and K6b of OTHER_ROOT's package and of this checkout on the
same inputs, on one card, in turns (other, this, this, other), each turn a
process of its own that imports only its own checkout's package and calls
its ``solvers/ba_kernels`` launchers.  The inputs, written once by this
process to ``build/ba_ab/cases.npz``: phase 3's first golden keyframe (S =
1, W = 30, K = 192) and its keyframes stacked at S = 3 and 8, the W = 30
forward windows of tests/ba_problems.py at K = 130, 240 and 352, K = 240
stacked at S = 2 and 11, and the bench's L = 10 240 problem.  Per case and
op: device time per call (``torch.profiler``: the mean time per launch of
each kernel launched in the window, summed over the kernels), ms per call by CUDA events around
back-to-back calls, the launches per call, the bound and its share, the
other's time over this one's, and the largest difference of the two
checkouts' outputs over the output's magnitude; the table also goes to
``build/ba_ab/ab.json``.  Place the other checkout
under the git-ignored ``build/`` before the call, e.g. ``mkdir -p
build/parent && git archive COMMIT | tar -x -C build/parent``: the
checkout the chip runs is not a git repository.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AB_DIR = os.path.join(ROOT, "build", "ba_ab")
CASE_KEYS = ("q", "t", "lam_v", "valid", "px", "mxy", "first", "a_idx", "constant", "free")
OPS = ("linearize", "residuals", "schur")


def _cases(golden, delta):
    """[(name, problems, cam)] of the A/B run."""
    import torch
    from ba_problems import bench_problem, build_problem
    from alvaar_tpu_torch import config
    dev = torch.device("cuda")
    gcam = golden[0][1]
    probs = [g[0] for g in golden]
    out = [("golden keyframe 0", probs[:1], gcam)]
    out += [(f"golden keyframes x{S}", [probs[i % len(probs)] for i in range(S)], gcam)
            for S in (3, 8)]
    for K in (config.FAST.max_keypoints, 240, config.ACCURATE.max_keypoints):
        prob, cam = build_problem(np.random.default_rng(K), W=30, L=2 * K, K=K, device=dev)
        out.append((f"forward window K={K}", [prob], cam))
    for S in (2, 11):
        rows = [build_problem(np.random.default_rng(240 + i), W=30, L=480, K=240, device=dev)
                for i in range(S)]
        out.append((f"forward windows K=240 x{S}", [p for p, _ in rows], rows[0][1]))
    bench, bcam = bench_problem(np.random.default_rng(0), device=dev)
    out.append(("bench problem L=10240", [bench], bcam))
    return out


def _write_cases(golden, delta) -> tuple:
    """The cases' kernel inputs into build/ba_ab/cases.npz; returns their
    names and bounds (this checkout's ``chip_smoke._ba_bounds``)."""
    import torch
    import chip_smoke
    from alvaar_tpu_torch.solvers import ba, ba_kernels
    os.makedirs(AB_DIR, exist_ok=True)
    arrays, meta = {}, []
    for i, (name, probs, cam) in enumerate(_cases(golden, delta)):
        x, vps = chip_smoke._ba_stack(probs, cam)
        for k in CASE_KEYS:
            arrays[f"{i}_{k}"] = x[k].cpu().numpy()
        camt = (cam.fx, cam.fy, cam.cx, cam.cy)
        lin = ba_kernels.launch_linearize(*(x[k] for k in CASE_KEYS[:-1]), camt, delta)
        rows = [ba._Linearization(*(t[s] for t in lin)) for s in range(len(probs))]
        bounds = chip_smoke._ba_bounds(x, vps, rows)
        meta.append(dict(name=name, S=len(probs), W=int(x["q"].shape[1]),
                         K=int(x["lam_v"].shape[2]), cam=camt, delta=delta,
                         bound_ms={op: bounds[op][2] for op in OPS},
                         bound_by={op: bounds[op][3] for op in OPS}))
    torch.cuda.synchronize()
    np.savez(os.path.join(AB_DIR, "cases.npz"), **arrays)
    with open(os.path.join(AB_DIR, "cases.json"), "w") as f:
        json.dump(meta, f)
    return meta


def _turn(root: str, tag: str) -> dict:
    """One turn, in a process that imports only ``root``'s package: each
    case's ops timed; the outputs saved for the comparison."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from alvaar_tpu_torch.solvers import ba_kernels
    if not os.path.abspath(ba_kernels.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {ba_kernels.__file__}, not {root}'s package")
    ba_kernels.build_kernel()
    with open(os.path.join(AB_DIR, "cases.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(AB_DIR, "cases.npz"))
    result, outputs = [], {}
    for i, m in enumerate(meta):
        x = {k: torch.as_tensor(data[f"{i}_{k}"], device="cuda") for k in CASE_KEYS}
        lin_args = [x[k] for k in CASE_KEYS[:-1]]
        lin = ba_kernels.launch_linearize(*lin_args, tuple(m["cam"]), m["delta"])
        H, g_c, u, va, D, g_l = lin
        lam = torch.full((m["S"],), 1e-3, device="cuda")
        calls = {
            "linearize": lambda: ba_kernels.launch_linearize(*lin_args, tuple(m["cam"]),
                                                             m["delta"]),
            "residuals": lambda: ba_kernels.launch_residuals(*lin_args[:-1], tuple(m["cam"]),
                                                             m["delta"]),
            "schur": lambda: ba_kernels.launch_schur(D, u, va, x["first"], x["a_idx"], H, g_c,
                                                     g_l, lam, x["free"]),
        }
        row = dict(name=m["name"])
        for op, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            # each kernel of an op launches once a call: its mean per launch
            # (the profiler may drop an event)
            evs = [e for e in prof.key_averages() if e.self_device_time_total > 0 and e.count]
            dev_ms = sum(e.self_device_time_total / e.count for e in evs) / 1e3
            launches = sum(e.count for e in evs) / 20
            ev = []
            for _ in range(5):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    fn()
                b.record()
                torch.cuda.synchronize()
                ev.append(a.elapsed_time(b) / 20)
            row[op] = dict(device_ms=dev_ms, event_ms=statistics.median(ev), launches=launches,
                           kernels=sorted({e.key for e in evs}))
            for j, t in enumerate(fn()):
                outputs[f"{i}_{op}_{j}"] = t.cpu().numpy()
        result.append(row)
    np.savez(os.path.join(AB_DIR, f"out_{tag}.npz"), **outputs)
    return dict(rows=result)


def _rel(a, b) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def ab(other: str, meta, card: str) -> None:
    """The turns (other, this, this, other) and their table."""
    other = os.path.abspath(other)
    runs = {"other": [], "this": []}
    for tag, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root, tag],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"the {tag} turn ({root}) failed:\n{res.stderr[-4000:]}")
        runs[tag].append(json.loads(res.stdout.strip().splitlines()[-1])["rows"])
        print(f"[ab] turn {tag} ({root}) in {time.perf_counter() - t0:.1f} s", flush=True)
    outs = {t: np.load(os.path.join(AB_DIR, f"out_{t}.npz")) for t in ("other", "this")}
    table = []
    for i, m in enumerate(meta):
        for op in OPS:
            dev = {t: [r[i][op]["device_ms"] for r in runs[t]] for t in runs}
            evm = {t: [r[i][op]["event_ms"] for r in runs[t]] for t in runs}
            n = {t: runs[t][0][i][op]["launches"] for t in runs}
            diff = max(_rel(outs["this"][k], outs["other"][k]) for k in outs["this"].files
                       if k.startswith(f"{i}_{op}_"))
            this_ms, other_ms = statistics.median(dev["this"]), statistics.median(dev["other"])
            bound = m["bound_ms"][op]
            row = dict(case=m["name"], S=m["S"], K=m["K"], op=op, other_device_ms=dev["other"],
                       this_device_ms=dev["this"], other_event_ms=evm["other"],
                       this_event_ms=evm["this"], other_launches=n["other"],
                       this_launches=n["this"], speedup=other_ms / this_ms, bound_ms=bound,
                       bound_by=m["bound_by"][op], this_share=bound / this_ms,
                       other_share=bound / other_ms, max_rel_diff=diff)
            table.append(row)
            print(f"[ab] {m['name']} (S={m['S']}, K={m['K']}) {op}: device ms per call other "
                  f"{'/'.join(f'{v:.4f}' for v in dev['other'])} ({n['other']:g} launches), "
                  f"this {'/'.join(f'{v:.4f}' for v in dev['this'])} ({n['this']:g} launches), "
                  f"other/this {other_ms / this_ms:.2f}x; events ms other "
                  f"{'/'.join(f'{v:.4f}' for v in evm['other'])}, this "
                  f"{'/'.join(f'{v:.4f}' for v in evm['this'])}; bound {bound * 1e3:.3f} us by "
                  f"{m['bound_by'][op]}: this {100 * bound / this_ms:.2f}% of it, other "
                  f"{100 * bound / other_ms:.2f}%; outputs differ by {diff:.1e} of their "
                  f"magnitude [{card}]", flush=True)
    with open(os.path.join(AB_DIR, "ab.json"), "w") as f:
        json.dump(dict(card=card, other=other, rows=table), f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT", help="the other checkout to time against")
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn(*args.turn)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("run_ba_phase: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke
    from alvaar_tpu_torch.config import SlamConfig
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
    print(f"[time] phase 2b {time.perf_counter() - t2:.1f} s", flush=True)
    if args.ab:
        t3 = time.perf_counter()
        meta = _write_cases(run["ba_problems"], SlamConfig().huber_thresh)
        ab(args.ab, meta, card)
        print(f"[time] A/B {time.perf_counter() - t3:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
