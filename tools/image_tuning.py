#!/usr/bin/env python3
"""Time variants of the image kernels K7, K5, K3 and K8
(csrc/image_kernels.cu) in one process on a card.

    python3 tools/image_tuning.py [--variant NAME=V[,NAME=V...]]... [--rounds 4]
                                  [--only describe] [--out OUT.json]

A variant sets ``constexpr int NAME = V;`` lines of the source (e.g.
``kCellThreads=1024``, ``kPyrTileX=32``, ``kDescWideKeypoints=0``: one warp a keypoint,
``kGrayBlocksPerSm=16``: the gray conversion's grid; ``kClaheBandRows=32``,
``kClaheUnroll=2``: K8's bands and loads);
the source as it stands is always the first.  The variants are written
under ``build/image_tuning/`` and built at once with
``ops/image_kernels._NVCC_FLAGS`` (each kernel's registers, spills and
shared memory printed; one that does not build is left out).  At every
shape of ``chip_smoke.IMAGE_DETECT_CASES`` K5 must be bit-equal to the
plain version, at every shape of ``IMAGE_STACK_CASES`` the 3-level
pyramid and the gray conversion (u8 RGBA and float32 RGB), and at every
shape of ``IMAGE_DESCRIBE_CASES`` K3 within its bar
(angles within 2e-5 rad of the plain version's, words bit-equal outside
1e-4 rad of a bin edge), at every shape of ``IMAGE_CLAHE_CASES`` K8
bit-equal at the default clip; then each one's device time per call
(``chip_smoke._kernel_split``, torch.profiler: K5's kernels one by one)
is taken in ``--rounds`` rounds, the variants in turns (forward, then
backward), and printed as the median with the spread.  ``--only`` keeps
the shapes of some kernels (``detect``, ``pyramid``, ``describe``, ``gray``,
``clahe``).
Needs CUDA.
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
OUT = os.path.join(ROOT, "build", "image_tuning")


def variant_source(src: str, sets: dict) -> str:
    for name, value in sets.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"no single `constexpr int {name}` in the source")
    return src


def _ptxas(log: str) -> dict:
    """{kernel: (registers, spill store bytes, shared memory bytes)} of K7's,
    K5's and K3's kernels from nvcc's -Xptxas -v lines."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = next((k for k in ("pyramid_kernel", "detect_cells_kernel", "detect_rank_kernel",
                                 "describe_kernel", "gray_kernel", "clahe_lut_kernel",
                                 "clahe_apply_kernel")
                     if k in chunk.splitlines()[0]),
                    None)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        if name and regs and spill:
            out[name] = (int(regs.group(1)), int(spill.group(1)),
                         int(smem.group(1)) if smem else 0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=V[,NAME=V...]: constants of csrc/image_kernels.cu to set")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--only", choices=("detect", "pyramid", "describe", "gray", "clahe"),
                    action="append",
                    help="time only these kernels' shapes (every one by default)")
    ap.add_argument("--out", help="a JSON file for the rows")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import chip_smoke
    import image_problems as ip
    from alvaar_tpu_torch.ops import image, image_kernels, orb
    from alvaar_tpu_torch.utils.build import find_tool
    if not torch.cuda.is_available():
        print("image_tuning: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.phase_env()
    with open(image_kernels._SRC) as f:
        base = f.read()
    variants = [("as committed", {})]
    for spec in args.variant:
        variants.append((spec, dict(kv.split("=", 1) for kv in spec.split(","))))
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc", "the CUDA toolkit is needed")
    t0 = time.time()
    procs = []
    for i, (name, sets) in enumerate(variants):
        d = os.path.join(OUT, f"v{i}")
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "image_kernels.cu")
        with open(src, "w") as f:
            f.write(variant_source(base, sets))
        lib = os.path.join(d, "libimage_kernels.so")
        procs.append((i, lib, subprocess.Popen([nvcc, *image_kernels._NVCC_FLAGS, "-o", lib, src],
                                               stderr=subprocess.PIPE, text=True)))
    libs = []
    for i, lib, proc in procs:
        log = proc.communicate()[1]
        if proc.returncode != 0:
            print(f"[variant {i}] {variants[i][0]}: does not build, left out: {log[-300:]}")
            continue
        print(f"[variant {i}] {variants[i][0]}: built ({time.time() - t0:.1f} s since the "
              f"first); registers, spill bytes, shared bytes {_ptxas(log)}", flush=True)
        libs.append((i, image_kernels.bind(ctypes.CDLL(lib))))

    dev = torch.device("cuda")
    only = set(args.only or ("detect", "pyramid", "describe", "gray", "clahe"))
    cases = []
    for case in chip_smoke.IMAGE_DETECT_CASES if "detect" in only else ():
        fn, pfn, _, _ = chip_smoke._detect_calls(*case, dev)
        cases.append((f"detect_grid {case[0]}", fn, pfn, "detect_"))
    for name, W, H, N, S, _ in chip_smoke.IMAGE_DESCRIBE_CASES if "describe" in only else ():
        imgs, xy, valid, fn, _ = chip_smoke._describe_calls(W, H, N, S, dev)
        plain = [orb._describe_plain(imgs[s], xy[s], valid[s]) for s in range(S)]
        want = (torch.stack([p[0] for p in plain]), torch.stack([p[1] for p in plain]))

        def held(fn=fn, S=S, want=want):        # K3's bar, not bit-equality
            desc, angle = fn()[0]
            desc, angle = (desc, angle) if S > 1 else (desc[None], angle[None])
            _, off, _ = ip.words_outside_margin(desc, *want)
            err = float((angle - want[1]).abs().max())
            if err > ip.ANGLE_BAR or off:
                raise AssertionError(f"angles {err} rad from the plain ones, {off} words off")
        cases.append((f"describe {name}", fn, held, "describe_"))
    for name, W, H, B in chip_smoke.IMAGE_STACK_CASES if "pyramid" in only else ():
        x = chip_smoke._image_stack(W, H, B, dev)
        x = x if B > 1 else x[0]
        cases.append((f"build_pyramid {name}", lambda x=x: image.build_pyramid(x, 3),
                      lambda x=x: (x, image._pyr_down_plain(x),
                                   image._pyr_down_plain(image._pyr_down_plain(x))), "pyr"))
    for name, W, H, B in chip_smoke.IMAGE_STACK_CASES if "gray" in only else ():
        rgba = chip_smoke._image_rgba_stack(W, H, B, dev)
        for what, x in (("u8 RGBA", rgba), ("float32 RGB", rgba[..., :3].float().contiguous())):
            cases.append((f"rgba_to_gray {name} {what}", lambda x=x: (image.rgba_to_gray(x),),
                          lambda x=x: (image._rgba_to_gray_plain(x),), "gray_kernel"))
    for name, W, H, B in chip_smoke.IMAGE_CLAHE_CASES if "clahe" in only else ():
        x = chip_smoke._clahe_input(W, H, B, dev)
        x = x if B > 1 else x[0]
        cases.append((f"clahe {name}", lambda x=x: (image.clahe(x),),
                      lambda x=x: (image._clahe_plain(x),), "clahe_"))
    rows = []
    for case, fn, pfn, pattern in cases:
        want = pfn if pattern == "describe_" else pfn()
        times = {i: [] for i, _ in libs}
        split = {}
        for r in range(args.rounds):
            for i, lib in list(libs if r % 2 == 0 else libs[::-1]):
                image_kernels._lib = lib
                try:
                    if r == 0 and pattern == "describe_":
                        want()                          # raises unless within the bar
                    elif r == 0 and not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                        raise AssertionError("differs from the plain version")
                    split[i] = chip_smoke._kernel_split(fn, pattern)
                except (AssertionError, RuntimeError) as e:     # the variant is left out
                    print(f"[variant {i}] {case}: {type(e).__name__}: {e}; left out", flush=True)
                    libs.remove((i, lib))
                    times.pop(i)
                    continue
                times[i].append(sum(ms * n for ms, n in split[i].values()))
        for i, t in times.items():
            name = variants[i][0]
            rows.append(dict(shape=case, variant=name, device_ms=statistics.median(t),
                             min_ms=min(t), max_ms=max(t),
                             kernels={chip_smoke._kernel_short(k): ms
                                      for k, (ms, _) in split[i].items()}))
            print(f"[variant {i}] {case}: device {statistics.median(t) * 1e3:.2f} us "
                  f"({min(t) * 1e3:.2f}-{max(t) * 1e3:.2f}; last round "
                  f"{chip_smoke._split_text(split[i])}) [{name}; {card}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, variants=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
