#!/usr/bin/env python3
"""Where the time goes inside motion-only PnP's kernel K9 (csrc/pnp_kernel.cu).

    python3 tools/pnp_kernel_timeline.py [--source PATH ...] [--out build/pnp_timeline.json]

For chip_smoke.py phase 2c's timed shapes (N = 130, 192, 240 and 352 at
S = 1, 16 x 192 and 64 x 240 at 4 LM iterations, N = 192 at the loop's 8;
outlier fraction 0.3, tests/pnp_problems.py's rows):

* the kernel's device time per launch (``torch.profiler``, the mean over
  50 launches);
* a copy of the source built into ``build/`` with a tracer: in every pass
  (a linearisation, or a prune of a source that still has them) lane 0 of
  each warp records the ``clock64`` cycles of four phases: the point
  evaluation, the warp reduction, the block combine with its barriers, and
  the 6x6 step (in a design whose step runs in one thread, the other warps'
  wait for it).  Per phase, the median over the launch's warps summed over
  the passes, at the SM clock ``nvidia-smi`` reports as its maximum.

``--source`` takes other copies of the kernel's source (repeatable), e.g.
an earlier commit's, ``git show COMMIT:alvaar_tpu_torch/csrc/pnp_kernel.cu
> build/pnp_kernel_COMMIT.cu``, kept under the git-ignored ``build/``; the
default is this checkout's.  Commit 3504313's source (one block of 256
threads, the step in thread 0, two prune passes) is traced through markers
patched into a copy; a source with the ``PNP_TRACE`` hooks is built with
them and launched at ``solvers/pnp_kernel.py``'s ``threads_for`` block
size.  Prints one line per source and case with the card's name and power
limit, and writes the rows to ``--out``.  Needs
CUDA and nvcc; the built libraries stay under ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PASSES, WARPS, PHASES = 64, 24, 8, 4       # the tracer's room
PHASE_NAMES = ("evaluation", "warp reduction", "block combine", "6x6 step")

TRACER = r'''
#include <cuda_runtime.h>
// [ROWS][PASSES][WARPS][PHASES] cycles, then per warp (pass, clock)
__device__ long long* g_trace;
__device__ __forceinline__ void pnp_trace_mark(int pass, int phase, long long cycles) {
  if ((threadIdx.x & 31) != 0 || g_trace == nullptr || blockIdx.x >= %(rows)d || pass >= %(passes)d)
    return;
  const long long warp = (blockIdx.x * %(passes)dLL + pass) * %(warps)d + (threadIdx.x >> 5);
  g_trace[warp * %(phases)d + phase] += cycles;
}
// for a source without hooks: the pass count and the last clock of each warp
__device__ __forceinline__ long long* pnp_trace_state() {
  return g_trace + %(rows)dLL * %(passes)d * %(warps)d * %(phases)d
         + (blockIdx.x * %(warps)dLL + (threadIdx.x >> 5)) * 2;
}
__device__ __forceinline__ void trace_start() {
  if ((threadIdx.x & 31) != 0 || g_trace == nullptr || blockIdx.x >= %(rows)d) return;
  long long* st = pnp_trace_state();
  st[0] += 1;
  st[1] = clock64();
}
__device__ __forceinline__ void trace_mark(int phase) {
  if ((threadIdx.x & 31) != 0 || g_trace == nullptr || blockIdx.x >= %(rows)d) return;
  long long* st = pnp_trace_state();
  const long long now = clock64();
  pnp_trace_mark(static_cast<int>(st[0] - 1), phase, now - st[1]);
  st[1] = now;
}
''' % dict(rows=ROWS, passes=PASSES, warps=WARPS, phases=PHASES)

# commit 3504313's source: where its passes' phases begin and end
MARKERS_3504313 = (
    ("  double v[kSum];\n", "  double v[kSum];\n  trace_start();\n", 1),
    ("  double v[2] = {0.0, 0.0};\n", "  double v[2] = {0.0, 0.0};\n  trace_start();\n", 1),
    ("  block_sum(v, red, tot);\n}", "  trace_mark(0);\n  block_sum(v, red, tot);\n}", 2),
    ("  warp_sum(v);\n", "  warp_sum(v);\n  trace_mark(1);\n", 1),
    ("    tot[threadIdx.x] = s;\n  }\n  __syncthreads();\n}",
     "    tot[threadIdx.x] = s;\n  }\n  __syncthreads();\n  trace_mark(2);\n}", 1),
    ("    lm_step(st);\n  }\n  __syncthreads();\n",
     "    lm_step(st);\n  }\n  __syncthreads();\n  trace_mark(3);\n", 1),
    ("      lm_step(st);\n    }\n    __syncthreads();\n",
     "      lm_step(st);\n    }\n    __syncthreads();\n    trace_mark(3);\n", 1),
)


def _traced_source(src: str) -> str:
    if "#ifdef PNP_TRACE" in src:
        out = "#define PNP_TRACE 1\n" + TRACER + src
    else:
        for old, new, n in MARKERS_3504313:
            if src.count(old) != n:
                raise RuntimeError("unknown kernel source: no PNP_TRACE hooks and not commit "
                                   "3504313's markers")
            src = src.replace(old, new)
        out = TRACER + src
    return out + ('extern "C" int pnp_set_trace(void* p) '
                  '{ return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n')


def _build(path: str, traced: bool, tag: str) -> str:
    from alvaar_tpu_torch.solvers import pnp_kernel
    src = open(path).read()
    if traced:
        src = _traced_source(src)
    base = os.path.join(ROOT, "build", f"pnp_timeline_{tag}{'_traced' if traced else ''}")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(base + ".cu", "w") as f:
        f.write(src)
    res = subprocess.run(["/usr/local/cuda/bin/nvcc", *pnp_kernel._NVCC_FLAGS, "-o", base + ".so",
                          base + ".cu"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {base}.cu:\n{res.stderr}")
    regs = re.findall(r"Used (\d+) registers", res.stderr)
    print(f"[timeline] built {os.path.relpath(base, ROOT)}.so: registers {regs}, "
          f"spills {'none' if ' 0 bytes spill stores' in res.stderr else 'see log'}", flush=True)
    return base + ".so"


class Kernel:
    """One build of a K9 source, called through its own C interface: a
    source with the ``PNP_TRACE`` hooks takes a block size and one output
    buffer, commit 3504313's five outputs at 256 threads."""

    def __init__(self, path: str, sized: bool):
        import torch
        self.lib = ctypes.CDLL(path)
        ptr, i32, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
        fn = self.lib.pnp_refine_launch
        fn.restype = i32
        self.sized = sized
        if sized:
            fn.argtypes = [ptr] * 5 + [i32] * 3 + [f32] * 4 + [i32, f64, f32, i32] + [ptr] * 2
        else:
            fn.argtypes = [ptr] * 5 + [i32] * 2 + [f32] * 4 + [i32, f64, f32, i32] + [ptr] * 6
        if hasattr(self.lib, "pnp_set_trace"):
            self.lib.pnp_set_trace.argtypes = [ptr]
        self.torch = torch

    def threads(self, n: int) -> int:
        from alvaar_tpu_torch.solvers import pnp_kernel
        return pnp_kernel.threads_for(n) if self.sized else 256

    def launcher(self, x, cam, iters: int, threads: int):
        """A function that launches the kernel once on the stack ``x``."""
        torch = self.torch
        from alvaar_tpu_torch.solvers import pnp_kernel
        from alvaar_tpu_torch.solvers.pnp import CHI2_THRESH_2DOF
        q, t, pts, obs, valid = x
        S, N = valid.shape
        ins = [a.data_ptr() for a in x]
        common = (*cam, iters, CHI2_THRESH_2DOF ** 0.5, CHI2_THRESH_2DOF, 1)
        stream = torch.cuda.current_stream().cuda_stream
        if self.sized:
            outs = (torch.empty(pnp_kernel.out_bytes(S, N, threads), dtype=torch.uint8,
                                device="cuda"),)
            args = (*ins, S, N, threads, *common, outs[0].data_ptr(), stream)
        else:
            outs = (torch.empty_like(q), torch.empty_like(t), torch.empty_like(valid),
                    torch.empty(S, dtype=torch.int64, device="cuda"), torch.empty_like(q[:, 0]))
            args = (*ins, S, N, *common, *[o.data_ptr() for o in outs], stream)

        def run(outs=outs, x=x):    # the buffers live as long as the launcher
            rc = self.lib.pnp_refine_launch(*args)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return run


def _device_us(run) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            run()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "pnp_refine_kernel" in e.key and e.count > 0]
    return sum(e.self_device_time_total / e.count for e in hits) if hits else float("nan")


def _phases(traced: Kernel, run, trace, S: int, threads: int, mhz: float):
    """One traced launch: per phase, the median over the warps (of every
    row) of its cycles, summed over the passes, in us; and each pass's
    phases."""
    import torch
    trace.zero_()
    traced.lib.pnp_set_trace(trace.data_ptr())
    run()
    torch.cuda.synchronize()
    traced.lib.pnp_set_trace(None)
    rec = trace[:ROWS * PASSES * WARPS * PHASES].view(ROWS, PASSES, WARPS, PHASES).cpu().numpy()
    rec = rec[:min(S, ROWS), :, :threads // 32]
    passes = int((rec.reshape(rec.shape[0], PASSES, -1) > 0).any(axis=(0, 2)).sum())
    per_pass = np.median(rec[:, :passes].transpose(1, 0, 2, 3).reshape(passes, -1, PHASES),
                         axis=1) / mhz
    return per_pass.sum(axis=0), per_pass, passes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pnp_kernel_timeline: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="a K9 source to time (repeatable; default: this checkout's)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "pnp_timeline.json"))
    args = ap.parse_args()
    import chip_smoke
    from pnp_problems import stack
    sources = args.source or [os.path.join(ROOT, "alvaar_tpu_torch", "csrc", "pnp_kernel.cu")]

    card = chip_smoke._card()
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    tags = [re.sub(r"\W", "_", os.path.splitext(os.path.basename(p))[0]) + f"_{i}"
            for i, p in enumerate(sources)]
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        jobs = [(pool.submit(_build, p, False, tag), pool.submit(_build, p, True, tag))
                for p, tag in zip(sources, tags)]
        sized = ["#ifdef PNP_TRACE" in open(p).read() for p in sources]
        builds = [(Kernel(a.result(), z), Kernel(b.result(), z)) for (a, b), z in zip(jobs, sized)]
    trace = torch.zeros(ROWS * PASSES * WARPS * PHASES + ROWS * WARPS * 2, dtype=torch.int64,
                        device="cuda")
    cases = {c[0]: c for c in chip_smoke.PNP_CASES}
    shapes = (("N=130", "N=130 outliers 0.3"), ("N=192", "N=192 outliers 0.3"),
              ("N=240", "N=240 outliers 0.3"), ("N=352", "N=352 outliers 0.3"),
              ("16 x 192", "16 x 192"), ("64 x 240", "64 x 240"),
              ("N=192, 8 iterations", "N=192 loop iterations, outliers"))
    rows = []
    for name, key in shapes:
        case = cases[key]
        probs, cam = chip_smoke._pnp_problems(case, torch.device("cuda"))
        x = stack(probs)
        S, N = x[4].shape
        camt = (cam.fx, cam.fy, cam.cx, cam.cy)
        for path, (plain, traced) in zip(sources, builds):
            threads = plain.threads(N)
            us = _device_us(plain.launcher(x, camt, case[3], threads))
            tot, per_pass, passes = _phases(traced, traced.launcher(x, camt, case[3], threads),
                                            trace, S, threads, mhz)
            row = dict(source=os.path.relpath(path, ROOT), shape=name, S=S, N=N,
                       iters=case[3], threads=threads, device_us=us, passes=passes,
                       phases_us=dict(zip(PHASE_NAMES, tot.round(3).tolist())),
                       per_pass_us=per_pass.round(3).tolist(), mhz=mhz, card=card)
            rows.append(row)
            split = ", ".join(f"{k} {v:.2f}" for k, v in zip(PHASE_NAMES, tot))
            print(f"[timeline] {row['source']} {name} (S={S}, N={N}, {case[3]} LM iterations, "
                  f"{threads} threads): {us:.2f} us per launch; {passes} passes, us summed "
                  f"over them (median warp): {split}; sum {tot.sum():.2f} "
                  f"(clock64 at {mhz:.0f} MHz) [{card}]", flush=True)
            print(f"[timeline]   per pass (evaluation, warp, combine, step): "
                  + " | ".join("/".join(f"{v:.2f}" for v in p) for p in per_pass), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
