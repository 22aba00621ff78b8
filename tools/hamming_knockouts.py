#!/usr/bin/env python3
"""Where the time goes in K4's dense pass (csrc/hamming.cu), on a card: the
source as it stands beside copies with parts of the work knocked out, each
kernel of a call timed on its own.

    python3 tools/hamming_knockouts.py [--rounds 4] [--out OUT.json]

``KNOCKOUTS`` names each copy and the text it replaces: "no mma" puts four
XORs of the fragments in place of ``mma.sync m16n8k256 .b1 .and.popc``
(the tensor cores' work gone, the dependence on the fragments kept), "one
op a key" a single minimum in place of a key's IMAD and three integer
min/max (the running best two's arithmetic gone), and "neither" both.
Their results are wrong by design; only their times are read.  The copies
are written under ``build/hamming_knockouts/``, built at once with
``ops/hamming_kernel._NVCC_FLAGS`` and timed in turns (forward, then
backward) at every shape of ``chip_smoke.HAMMING_LOOP_CASES``: the best
two (tests/hamming_problems.py's "ties" problem) and the dense int32
form, each kernel's device time per call by ``chip_smoke._kernel_split``
(torch.profiler), so the best two's main kernel and its merge apart.
What a knock-out saves is what that work costs; what stays is the chain
of loads, shuffles, barriers and launches around it.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "hamming_knockouts")

MMA = "        mma_and_popc(d, fa[r], fb, zero);\n"
NO_MMA = ("        d[0] = fb[0] ^ fa[r][0], d[1] = fb[1] ^ fa[r][1], d[2] = fb[0] ^ fa[r][2], "
          "d[3] = fb[1] ^ fa[r][3];\n")
TAKE = """            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(lo) - (static_cast<unsigned>(d[2 * h]) << (kKeyShift + 1)));
            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(hi) -
                     (static_cast<unsigned>(d[2 * h + 1]) << (kKeyShift + 1)));
"""
ONE_OP = ("            kb[r][h] = umin(kb[r][h], static_cast<unsigned>(lo) - d[2 * h]), "
          "ks[r][h] = umin(ks[r][h], static_cast<unsigned>(hi) - d[2 * h + 1]);\n")
# (name, ((text, replacement), ...))
KNOCKOUTS = (("as committed", ()), ("no mma", ((MMA, NO_MMA),)),
             ("one op a key", ((TAKE, ONE_OP),)), ("neither", ((MMA, NO_MMA), (TAKE, ONE_OP))))


def knocked_out(src: str, swaps) -> str:
    """``src`` with each (text, replacement) of ``swaps`` made once; raises
    where a text is not in the source exactly once."""
    for text, repl in swaps:
        if src.count(text) != 1:
            raise ValueError(f"the knock-out's text is not in the source once: {text!r}")
        src = src.replace(text, repl)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", help="a JSON file for the rows")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    import chip_smoke
    from hamming_problems import best_two_problem
    from alvaar_tpu_torch.loopclosure.detector import _BIG
    from alvaar_tpu_torch.ops import hamming_kernel
    from alvaar_tpu_torch.utils.build import find_tool
    if not torch.cuda.is_available():
        print("hamming_knockouts: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.phase_env()
    with open(hamming_kernel._SRC) as f:
        base = f.read()
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc", "the CUDA toolkit is needed")
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for i, (name, swaps) in enumerate(KNOCKOUTS):
        src, lib = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"libv{i}.so")
        with open(src, "w") as f:
            f.write(knocked_out(base, swaps))
        procs.append((name, lib, subprocess.Popen([nvcc, *hamming_kernel._NVCC_FLAGS, "-o", lib,
                                                   src], stderr=subprocess.PIPE, text=True)))
    libs = []
    for name, lib, proc in procs:
        log = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"{name} does not build: {log[-500:]}")
        libs.append((name, hamming_kernel.bind(ctypes.CDLL(lib))))

    rows = []
    for case, S, N, M in chip_smoke.HAMMING_LOOP_CASES:
        x = best_two_problem(np.random.default_rng(N + M + S), S, N, M, "ties", "cuda")
        forms = (("best two", lambda: hamming_kernel.launch_best_two(*x, _BIG)),
                 ("int32", lambda: hamming_kernel.launch_matrix(x[0], x[1])))
        for form, fn in forms:
            times = {name: {} for name, _ in libs}
            for r in range(args.rounds):
                for name, lib in (libs if r % 2 == 0 else libs[::-1]):
                    hamming_kernel._lib = lib
                    hamming_kernel._CHUNKS.clear()
                    for k, (ms, n) in chip_smoke._kernel_split(fn, "hamming_bmma").items():
                        times[name].setdefault(chip_smoke._kernel_short(k), []).append(ms * n)
            for name, split in times.items():
                med = {k: statistics.median(v) for k, v in split.items()}
                rows.append(dict(shape=case, form=form, copy=name, kernels_ms=med,
                                 device_ms=sum(med.values())))
                parts = " + ".join(f"{k} {v * 1e3:.2f} us" for k, v in sorted(med.items()))
                print(f"[knockout] {case} {form} [{name}]: {sum(med.values()) * 1e3:.2f} us = "
                      f"{parts} [{card}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
