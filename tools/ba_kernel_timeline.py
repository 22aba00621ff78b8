#!/usr/bin/env python3
"""Where the time goes inside local BA's kernels (csrc/ba_kernels.cu).

    python3 tools/ba_kernel_timeline.py

For the W = 30 forward windows of tests/ba_problems.py at K = 130, 192 and
352 (S = 1) and K = 240 as S = 11 rows, and the bench's L = 10 240 problem:

* each kernel's device time per launch (``torch.profiler``, the mean over
  50 calls of each op);
* a copy of the source built into ``build/`` with a tracer in
  ``ba_linearize_reduce_kernel`` and ``ba_schur_kernel``: lane 0 of every
  warp records its SM, its start on the global timer and its ``clock64``
  cycles from start to return.  Per kind of block (diagonal blocks, pair
  warps, member threads) the warps' median and largest duration, at the
  SM clock ``nvidia-smi`` reports as its maximum, and the span of their
  starts (a span beyond a few hundred ns: more blocks than fit at once).

Prints one line per problem and kernel with the card's name and power
limit.  Needs CUDA and nvcc; the built library stays under ``build/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRACER = '''
__device__ unsigned long long* g_trace;
struct Trace {   // lane 0 of each warp: start time, cycles to return, SM, block
  long long c0;
  unsigned long long t0;
  long long slot;
  __device__ explicit Trace(int kernel) {
    c0 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    slot = ((kernel * 16LL + blockIdx.y) * 1024 + blockIdx.x) * 32 + (threadIdx.x >> 5);
  }
  __device__ ~Trace() {
    if ((threadIdx.x & 31) != 0 || g_trace == nullptr) return;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* p = g_trace + 4 * slot;
    p[0] = t0;
    p[1] = clock64() - c0;
    p[2] = sm + 1;
    p[3] = blockIdx.x;
  }
};
'''
ROWS, BLOCKS = 16, 1024     # the tracer's room: rows and blocks a row of one launch


def _traced_library(ba_kernels):
    src = open(os.path.join(ROOT, "alvaar_tpu_torch", "csrc", "ba_kernels.cu")).read()
    src = src.replace("namespace {\n", "namespace {\n" + TRACER, 1)
    for kernel, marker in ((0, "  const int s = blockIdx.y, b = blockIdx.x;\n"),
                           (1, "  const int s = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;\n")):
        if src.count(marker) != 1:
            raise RuntimeError("the kernels' source changed: update the tracer's markers")
        src = src.replace(marker, f"  Trace trace_({kernel});\n" + marker)
    src += ('extern "C" int set_trace(void* p) '
            '{ return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n')
    path = os.path.join(ROOT, "build", "ba_kernels_traced.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    out = path[:-3] + ".so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", *ba_kernels._NVCC_FLAGS, "-o", out, path],
                   check=True, capture_output=True)
    lib = ba_kernels.bind(ctypes.CDLL(out))
    lib.set_trace.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ba_kernel_timeline: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from ba_problems import bench_problem, build_problem
    from alvaar_tpu_torch.solvers import ba_kernels

    card = chip_smoke._card()
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    plain_lib, traced = ba_kernels._load(), _traced_library(ba_kernels)
    trace = torch.zeros(2 * ROWS * BLOCKS * 32 * 4, dtype=torch.int64, device="cuda")
    cases = [(f"K={K}", [build_problem(np.random.default_rng(K), W=30, L=2 * K, K=K,
                                       device="cuda")[0]]) for K in (130, 192, 352)]
    cases.append(("K=240 x11", [build_problem(np.random.default_rng(240 + i), W=30, L=480,
                                              K=240, device="cuda")[0] for i in range(11)]))
    cases.append(("bench L=10240", [bench_problem(np.random.default_rng(0), device="cuda")[0]]))
    cams = {name: (bench_problem(np.random.default_rng(0))[1] if name.startswith("bench")
                   else build_problem(np.random.default_rng(0))[1]) for name, _ in cases}
    keys = ("q", "t", "lam_v", "valid", "px", "mxy", "first", "a_idx", "constant")
    for name, probs in cases:
        cam = cams[name]
        x, _ = chip_smoke._ba_stack(probs, cam)
        a = [x[k] for k in keys]
        camt = (cam.fx, cam.fy, cam.cx, cam.cy)
        S, W, K = x["lam_v"].shape
        if S > ROWS or W + -(-(W * (W - 1) // 2) // 8) + -(-W * K // 256) > BLOCKS:
            raise ValueError(f"{name}: more rows or blocks than the tracer has room for")
        ba_kernels._lib = plain_lib
        H, g_c, u, va, D, g_l = ba_kernels.launch_linearize(*a, camt, 2.0)
        lam = torch.full((S,), 1e-3, device="cuda")
        ops = {"linearize": lambda: ba_kernels.launch_linearize(*a, camt, 2.0),
               "residuals": lambda: ba_kernels.launch_residuals(*a[:-1], camt, 2.0),
               "schur": lambda: ba_kernels.launch_schur(D, u, va, x["first"], x["a_idx"], H,
                                                        g_c, g_l, lam, x["free"])}
        per_kernel = {}
        for fn in ops.values():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                kernel = re.search(r"ba_\w+_kernel", e.key)
                if kernel and e.count and e.self_device_time_total > 0:
                    per_kernel[kernel.group()] = round(e.self_device_time_total / e.count, 2)
        print(f"[timeline] {name} (S={S}, W={W}, K={K}) us per launch: {json.dumps(per_kernel)} "
              f"[{card}]", flush=True)
        ba_kernels._lib = traced
        trace.zero_()
        traced.set_trace(trace.data_ptr())
        ops["linearize"]()
        ops["schur"]()
        torch.cuda.synchronize()
        traced.set_trace(None)
        rec = trace.view(2, -1, 4).cpu().numpy()
        n_pairs = -(-(W * (W - 1) // 2) // 8)
        for k, kernel in ((0, "ba_linearize_reduce_kernel"), (1, "ba_schur_kernel")):
            r = rec[k][rec[k][:, 2] > 0]
            start = (r[:, 0] - r[:, 0].min()) / 1e3
            us = r[:, 1] / mhz
            kind = np.where(r[:, 3] < W, 0, np.where(r[:, 3] < W + n_pairs, 1, 2))
            parts = []
            for j, what in enumerate(("diagonal blocks", "pair warps", "member threads")):
                m = kind == j
                if m.any():
                    parts.append(f"{what}: {int(m.sum())} warps, median {np.median(us[m]):.2f} "
                                 f"max {us[m].max():.2f} us")
            print(f"[timeline] {name} {kernel}: {len(r)} warps on {len(set(r[:, 2]))} SMs, "
                  f"starts within {start.max():.2f} us; " + "; ".join(parts)
                  + f" (clock64 at {mhz:.0f} MHz) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
