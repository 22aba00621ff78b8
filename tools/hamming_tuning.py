#!/usr/bin/env python3
"""Time variants of K4's kernels (csrc/hamming.cu) in one process on a
card, and the rates that forms of ``mma.sync`` reach there.

    python3 tools/hamming_tuning.py [--variant NAME=V[,NAME=V...]]... [--rate]
                                    [--dense] [--swap NAME[,NAME]]... [--rounds 4]
                                    [--out build/x.json]

A variant sets ``constexpr int NAME = V;`` lines of the source (the
tiling's constants, e.g. ``kStageTiles=2``, or the dense pass's
``kDenseWarpTiles``, ``kDenseFewTiles``, ``kDenseAhead``, ``kStoreAhead``,
``kSmallTiles``, ``kSmallMaxTiles``, ``kStoreMaxTiles``,
``kDenseBlocksPerSm``); a ``--swap`` variant is the source with the edits
of tools/hamming_dense_variants.py's named designs (``staged b``: B staged
by cp.async, double-buffered; ``ticket``: the merge in the last block to
arrive; both, comma-separated).  The source as it stands is always the first.  Each
variant is written under ``build/hamming_tuning/`` and built with
``ops/hamming_kernel._NVCC_FLAGS`` (its registers and spills printed; one
that does not build is left out); at every shape of
``chip_smoke.HAMMING_CASES`` (with ``--dense``: of ``HAMMING_LOOP_CASES``,
the best two and the dense int32 form, the best two's two kernels timed
together) it must be bit-equal to the plain version, and its device time
per call (``chip_smoke._device_ms``, torch.profiler) is taken in
``--rounds`` rounds, the variants in turns (forward, then backward), and
printed as the median with the spread.

``--rate`` first times a probe kernel that only issues one form of ``mma``
(``RATE_FORMS``: the int8 m16n8k32 form with u8 A and s8 B, and the
binary m16n8k256 forms with AND or XOR and popcount, where they
assemble): per warp ``chains`` independent accumulators (1-8), 4, 8 or 16
warps a multiprocessor, one block a multiprocessor; it prints TOP/s and
the clocks an instruction takes a sub-partition at the card's SM clock
during the run.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "hamming_tuning")

# (name, the mma's PTX with %0-%3 the accumulators, %4-%7 A, %8-%9 B, the
# operations an instruction counts: the int8 form's 2 x 16 x 8 x 32 or the
# binary forms' 2 x 16 x 8 x 256 bit operations)
RATE_FORMS = (
    ("u8.s8 m16n8k32", "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32", 2 * 16 * 8 * 32),
    ("b1 and.popc m16n8k256", "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc",
     2 * 16 * 8 * 256),
    ("b1 xor.popc m16n8k256", "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc",
     2 * 16 * 8 * 256),
)

RATE_PROBE = r"""
#include <cuda_runtime.h>

template <int CHAINS>
__global__ void mma_rate_kernel(int iters, int* sink) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  unsigned b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  int d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "MMA {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (sum == 0x7FFFFFFF) *sink = sum;
}

extern "C" int mma_rate_launch(int chains, int blocks, int warps, int iters, int* sink) {
  void (*k)(int, int*) = nullptr;
  switch (chains) {
    case 1: k = mma_rate_kernel<1>; break;
    case 2: k = mma_rate_kernel<2>; break;
    case 4: k = mma_rate_kernel<4>; break;
    case 6: k = mma_rate_kernel<6>; break;
    case 8: k = mma_rate_kernel<8>; break;
    default: return 1;
  }
  k<<<blocks, 32 * warps>>>(iters, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc(src_path: str, lib_path: str, flags) -> str:
    """Build ``src_path`` into ``lib_path``; returns ptxas's lines."""
    from alvaar_tpu_torch.utils.build import find_tool
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc", "the CUDA toolkit is needed")
    res = subprocess.run([nvcc, *flags, "-o", lib_path, src_path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_path}:\n{res.stderr}")
    return res.stderr


def mma_rate(flags) -> list:
    """The probe's rows for each of ``RATE_FORMS`` that assembles: (form,
    chains, warps a multiprocessor, TOP/s, clocks an mma a sub-partition)."""
    import torch
    os.makedirs(OUT, exist_ok=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    iters = 4096
    rows = []
    for i, (form, ptx, ops) in enumerate(RATE_FORMS):
        src = os.path.join(OUT, f"mma_rate{i}.cu")
        with open(src, "w") as f:
            f.write(RATE_PROBE.replace("MMA", ptx))
        path = os.path.join(OUT, f"libmma_rate{i}.so")
        try:
            _nvcc(src, path, flags)
        except RuntimeError as e:
            print(f"[rate] {form}: does not build: {str(e).strip().splitlines()[-1]}")
            rows.append(dict(form=form, builds=False))
            continue
        lib = ctypes.CDLL(path)
        lib.mma_rate_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for warps in (4, 8, 16):
            for chains in (1, 2, 4, 6, 8):
                run = lambda: lib.mma_rate_launch(chains, sms, warps, iters, sink.data_ptr())
                for _ in range(2):
                    assert run() == 0
                torch.cuda.synchronize()
                clock = _sm_clock_mhz()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                s = start.elapsed_time(end) / 5 / 1e3
                n = sms * warps * iters * chains          # one block a multiprocessor
                tops = n * ops / s / 1e12
                per_sub = s * clock * 1e6 / (n / (sms * 4))
                rows.append(dict(form=form, chains=chains, warps_per_sm=warps, tops=tops,
                                 clocks_per_mma_per_subpartition=per_sub, sm_clock_mhz=clock))
                print(f"[rate] {form}: {chains} chains a warp, {warps} warps a "
                      f"multiprocessor: {tops:.1f} TOP/s, {per_sub:.2f} clocks an mma a "
                      f"sub-partition (SM clock {clock} MHz)", flush=True)
    return rows


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return float(out[0]) if out else float("nan")


def variant_source(src: str, sets: dict) -> str:
    for name, value in sets.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"no single `constexpr int {name}` in the source")
    return src


def _dense_rows(libs, variants, rounds: int, card: str) -> list:
    """The dense pass's variants at ``chip_smoke.HAMMING_LOOP_CASES``: the
    best two (tests/hamming_problems.py's "ties" problem; both kernels of a
    call) and the dense int32 form, each bit-equal to its plain version
    first; device time per call in ``rounds`` rounds, the variants in
    turns."""
    import numpy as np
    import torch
    import chip_smoke
    from hamming_problems import best_two_problem
    from alvaar_tpu_torch.loopclosure.detector import _BIG
    from alvaar_tpu_torch.ops import hamming, hamming_kernel
    rows = []
    for case, S, N, M in chip_smoke.HAMMING_LOOP_CASES:
        x = best_two_problem(np.random.default_rng(N + M + S), S, N, M, "ties", "cuda")
        want = [hamming._hamming_best_two_plain(*(c[i] for c in x), _BIG) for i in range(S)]
        want = [torch.stack([w[k] for w in want]) for k in range(3)]
        dense_want = torch.stack([hamming._hamming_matrix_plain(x[0][i], x[1][i])
                                  for i in range(S)])
        forms = (("best two", lambda: hamming_kernel.launch_best_two(*x, _BIG), want),
                 ("dense int32", lambda: (hamming_kernel.launch_matrix(x[0], x[1]),),
                  (dense_want,)))
        for form, fn, expect in forms:
            times, kernels = {i: [] for i, _ in libs}, {}
            for r in range(rounds):
                for i, lib in (libs if r % 2 == 0 else libs[::-1]):
                    hamming_kernel._lib = lib
                    hamming_kernel._CHUNKS.clear()
                    if r == 0 and not all(torch.equal(g, w) for g, w in zip(fn(), expect)):
                        raise AssertionError(f"variant {i} differs from the plain version at "
                                             f"{case} ({form})")
                    ms, n = chip_smoke._device_ms(fn, "hamming_bmma")
                    times[i].append(ms)
                    kernels[i] = n
            for i, t in times.items():
                rows.append(dict(shape=case, form=form, variant=variants[i][0],
                                 device_ms=statistics.median(t), min_ms=min(t), max_ms=max(t),
                                 kernels_per_call=kernels[i]))
                print(f"[variant {i}] {case} {form}: device {statistics.median(t) * 1e3:.2f} us "
                      f"({min(t) * 1e3:.2f}-{max(t) * 1e3:.2f}) in {kernels[i]:g} kernels a call "
                      f"[{variants[i][0]}; {card}]", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=V[,NAME=V...]: constants of csrc/hamming.cu to set")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--dense", action="store_true",
                    help="time the dense pass (the loop queries' shapes), not the min cross-bag")
    ap.add_argument("--swap", action="append", default=[],
                    help="NAME[,NAME]: tools/hamming_dense_variants.py's designs to build")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", help="a JSON file for the rows")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    import chip_smoke
    from hamming_problems import bag_problem
    from alvaar_tpu_torch.ops import hamming, hamming_kernel
    if not torch.cuda.is_available():
        print("hamming_tuning: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.phase_env()
    result = dict(card=card)
    if args.rate:
        result["rate"] = mma_rate(hamming_kernel._NVCC_FLAGS)

    with open(hamming_kernel._SRC) as f:
        base = f.read()
    import hamming_dense_variants
    variants = [("as committed", {}, ())]
    for spec in args.variant:
        variants.append((spec, dict(kv.split("=", 1) for kv in spec.split(",")), ()))
    for spec in args.swap:
        variants.append((spec, {}, tuple(spec.split(","))))
    from alvaar_tpu_torch.utils.build import find_tool
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc", "the CUDA toolkit is needed")
    t0 = time.time()
    procs = []
    for i, (name, sets, swaps) in enumerate(variants):       # built at once, a process each
        d = os.path.join(OUT, f"v{i}")
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "hamming.cu")
        with open(src, "w") as f:
            f.write(hamming_dense_variants.edited(variant_source(base, sets), swaps))
        lib = os.path.join(d, "libhamming.so")
        procs.append((i, name, lib, subprocess.Popen(
            [nvcc, *hamming_kernel._NVCC_FLAGS, "-o", lib, src], stderr=subprocess.PIPE,
            text=True)))
    libs = []
    for i, name, lib, proc in procs:
        log = proc.communicate()[1]
        if proc.returncode != 0:
            print(f"[variant {i}] {name}: does not build, left out: {log[-300:]}")
            continue
        regs = re.findall(r"hamming_min_crossbag_kernelILi(\d)E.*?Used (\d+) registers", log,
                          re.S)
        dense = re.findall(r"hamming_bmma_kernelILi(\d+)ELb(\d)E.*?Used (\d+) registers", log,
                           re.S)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"[variant {i}] {name}: built ({time.time() - t0:.1f} s since the first); "
              f"registers by G {dict((int(g), int(r)) for g, r in regs)}; the dense pass's by "
              f"(R, store) {dict(((int(r), int(k)), int(n)) for r, k, n in dense)}; spill stores "
              f"{spills}", flush=True)
        libs.append((i, hamming_kernel.bind(ctypes.CDLL(lib))))

    dev = torch.device("cuda")
    rows = []
    if args.dense:
        rows = _dense_rows(libs, variants, args.rounds, card)
    for case, S, N, M, G in () if args.dense else chip_smoke.HAMMING_CASES:
        x = bag_problem(np.random.default_rng(N + M + G + S), S, N, M, G, "matching", dev)
        plain = torch.stack([hamming._min_crossbag_plain(*(c[i] for c in x)) for i in range(S)])
        times = {i: [] for i, _ in libs}
        for r in range(args.rounds):
            for i, lib in (libs if r % 2 == 0 else libs[::-1]):
                hamming_kernel._lib = lib
                if r == 0 and not torch.equal(hamming_kernel.launch_min_crossbag(*x), plain):
                    raise AssertionError(f"variant {i} differs from the plain version at {case}")
                ms, _ = chip_smoke._device_ms(lambda: hamming_kernel.launch_min_crossbag(*x),
                                              "hamming_min_crossbag_kernel")
                times[i].append(ms)
        for i, t in times.items():
            name = variants[i][0]
            rows.append(dict(shape=case, variant=name, device_ms=statistics.median(t),
                             min_ms=min(t), max_ms=max(t)))
            print(f"[variant {i}] {case}: device {statistics.median(t) * 1e3:.2f} us "
                  f"({min(t) * 1e3:.2f}-{max(t) * 1e3:.2f}) [{name}; {card}]", flush=True)
    result["variants"] = rows
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
