#!/usr/bin/env python3
"""Where the time goes inside K5's cell kernel, K7's pyramid kernel, K3 and
K8 (csrc/image_kernels.cu, or another commit's copy of it), on a card.

    python3 tools/image_kernel_timeline.py [--source build/image_kernels_COMMIT.cu]
                                           [--only describe] [--only clahe] [--out OUT.json]

A copy of the source is written under ``build/image_timeline/`` with
stamps patched in: thread 0 of each block records ``%globaltimer`` (ns)
after every barrier of a response sub-tile (the image's loads, the blur,
Sobel, the box means' vertical pass, the response) and, in the cell
kernel, after the sub-tiles, each peak's argmax and the keypoint scan; in
the pyramid kernel after its loads, level 1's vertical pass, level 1,
level 2's vertical pass and level 2; in K3's ``describe_kernel`` after
each of its barriers (``__syncthreads`` or ``__syncwarp``: thread 0 is
its block's first keypoint's first lane), after the angle's store and at
its end; in K8's table kernel after each barrier and at its end, in its
pixel kernel at its start, after its last band's two barriers and at its end;
and the multiprocessor it ran on.  The copy is built with
``ops/image_kernels._NVCC_FLAGS`` and launched through the port's wrappers
(K3 through ``chip_smoke._describe_launcher`` with the source's own
steering table) at every shape of ``chip_smoke.IMAGE_DETECT_CASES``,
``IMAGE_STACK_CASES``, ``IMAGE_DESCRIBE_CASES`` and (K8, through ``clahe``:
both kernels of one call) ``IMAGE_CLAHE_CASES``; each stage's median
and largest time over the blocks of one launch are printed (a stamp that
no thread 0 reached, in a branch not taken, is left out), with the
blocks' start times (a block of a later wave starts late) and the last
block's end.  With several sub-tiles a block's stamps are its last
sub-tile's, so the first stage then spans the others.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "image_timeline")
SLOTS, MAX_BLOCKS = 16, 70000        # stamps a block (the last: its multiprocessor)

STAMP = ("{ const long long b_ = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x; "
         f"if (threadIdx.x == 0 && b_ < {MAX_BLOCKS}) {{ unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "g_stamps[b_ * 16 + K_] = t_; if (K_ == 0) { unsigned sm_; "
         "asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_)); g_stamps[b_ * 16 + 15] = sm_; } } }")
CELL_STAGES = (5, 6, 7, 8, 9, 1, 2, 3, 4)
CELL_LABELS = ("image loads", "blur", "Sobel", "box means' vertical pass", "response",
               "sub-tiles end", "argmax 1", "argmax 2", "subpixel fit and keypoint scan")
PYR_STAGES = (1, 2, 10, 4, 11)
PYR_LABELS = ("level-0 loads", "level 1's vertical pass", "level 1", "level 2's vertical pass",
              "level 2")
# K8: the table kernel's stamps 0-5 (its start, its four barriers 1-4, its
# end 5); the pixel kernel's 8-11 (its start, its last band's two
# barriers, its end)
CLAHE_LUT_STAGES = (1, 2, 3, 4, 5)
CLAHE_LUT_LABELS = ("histograms zeroed", "pixels counted", "excess", "prefix", "table stored")
CLAHE_APPLY_STAGES = (1, 2, 3)
CLAHE_APPLY_LABELS = ("bands before the last, the band's place and its columns' weights",
                      "tables and row weights staged", "pixels")


# K3's stamps: 0 at the start, then DESC_FIRST, DESC_FIRST + 1, ... after
# each of these in the kernel's text, and one at its end
DESC_ANCHORS = ("__syncthreads();", "__syncwarp();", "angle[n] = ang;")
DESC_FIRST = 1


def _describe_anchors(body: str) -> list:
    """(position, anchor) of every K3 anchor in the kernel's body."""
    return [(m.start(), m.group(0)) for m in
            re.finditer("|".join(re.escape(a) for a in DESC_ANCHORS), body)]


def describe_labels(src: str) -> list:
    """The stage labels of K3's stamps in ``src``: each anchor with the
    source line it ends, then the end."""
    a = src.index("    describe_kernel(")
    body = src.index("{", a) + 1
    seg = src[body:src.index("\n}\n", body)]
    labels = []
    for pos, anchor in _describe_anchors(seg):
        lines = seg[:pos].split("\n")
        prev = next((x.strip() for x in reversed(lines[:-1])
                     if re.search(r"\w{3}", x) and not x.strip().startswith(("#", "} else"))
                     and not re.fullmatch(r"if \(.*\) \{", x.strip())), "")
        labels.append(f"to `{anchor}` at line {len(lines)} of the kernel (after `{prev[:40]}`)")
    return labels + ["to the end"]


def _stamp(k: int) -> str:
    return STAMP.replace("K_", str(k))


def _after_barriers(seg: str, first: int) -> str:
    """``seg`` with a stamp after each of its ``__syncthreads();``, numbered
    from ``first``."""
    parts = seg.split("  __syncthreads();")
    out = parts[0]
    for i, p in enumerate(parts[1:]):
        out += "  __syncthreads();\n  " + _stamp(first + i) + p
    return out


def _patch(s: str, anchor: str, k: int, before: bool = False) -> str:
    if s.count(anchor) < 1:
        raise ValueError(f"the source has no {anchor!r}: update the timeline's anchors")
    return s.replace(anchor, ("  " + _stamp(k) + "\n" + anchor) if before else
                     (anchor + "\n  " + _stamp(k) + "\n"), 1)


def timed_source(src: str) -> str:
    """The source with the stamps, a device array of them and C entries
    that read and clear it."""
    s = src.replace("namespace {\n", f"__device__ unsigned long long g_stamps[{SLOTS} * "
                                     f"{MAX_BLOCKS}];\nnamespace {{\n", 1)
    a = s.index("    detect_cells_kernel(")
    body = s.index("{", a) + 1
    s = s[:body] + "\n  " + _stamp(0) + s[body:]
    s = _patch(s, "cell, resp + s * H * W, v1, i1);", 1)
    s = _patch(s, "  block_argmax<kCellWarps>(v1, i1, sv, si);", 2)
    s = _patch(s, "  block_argmax<kCellWarps>(v2, i2, sv, si);", 3)
    s = _patch(s, "  unsigned any = 0;", 4, before=True)
    a, b = s.index("__device__ void response_chunk("), s.index("// Block (cell, s): the response")
    s = s[:a] + _after_barriers(s[a:b], 5) + s[b:]
    a, b = s.index("    pyramid_kernel("), s.index("// K5: grid Shi-Tomasi detection")
    seg = _after_barriers(s[a:b], 1)
    body = seg.index("{") + 1
    seg = seg[:body] + "\n  " + _stamp(0) + seg[body:]
    seg = seg.replace("  if (out2 == nullptr) return;",
                      "  " + _stamp(10) + "\n  if (out2 == nullptr) return;")
    end = seg.rstrip().rfind("}")
    seg = seg[:end] + "  " + _stamp(11) + "\n" + seg[end:]
    s = s[:a] + seg + s[b:]
    a = s.index("    describe_kernel(")
    body = s.index("{", a) + 1
    end = s.index("\n}\n", body)
    seg = s[body:end]
    anchors = sorted(_describe_anchors(seg))
    out, last = "", 0
    for k, (pos, anchor) in enumerate(anchors):
        out += seg[last:pos + len(anchor)] + " " + _stamp(DESC_FIRST + k)
        last = pos + len(anchor)
    out += seg[last:] + "  " + _stamp(DESC_FIRST + len(anchors)) + "\n"
    s = s[:body] + "\n  " + _stamp(0) + out + s[end:]
    a, b = s.index("    clahe_lut_kernel("), s.index("// A row's (or column's) two tiles")
    seg = _after_barriers(s[a:b], 1)
    body = seg.index("{") + 1
    end = seg.rstrip().rfind("}")
    s = s[:a] + seg[:body] + "\n  " + _stamp(0) + seg[body:end] + "  " + _stamp(5) + "\n" + \
        seg[end:] + s[b:]
    a, b = s.index("    clahe_apply_kernel("), s.index("unsigned blocks(long long n")
    seg = _after_barriers(s[a:b], 9)
    body = seg.index("{") + 1
    end = seg.rstrip().rfind("}")
    s = s[:a] + seg[:body] + "\n  " + _stamp(8) + seg[body:end] + "  " + _stamp(11) + "\n" + \
        seg[end:] + s[b:]
    return s + (
        '\nextern "C" int timeline_read(void* host, long long n) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * 8));\n}\n"
        'extern "C" int timeline_clear() {\n'
        f"  static unsigned long long zero[{SLOTS} * {MAX_BLOCKS}];\n"
        "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero)));\n}\n")


def _stages(name, t, stamps, labels, card) -> dict:
    """Print and return one launch's per-stage times (ns) over its blocks."""
    import numpy as np
    t0 = t[:, 0].min()
    starts = t[:, 0] - t0
    row = dict(kernel=name, blocks=len(t), sms=len(set(t[:, 15].tolist())),
               block_starts_ns=np.percentile(starts, [0, 50, 90, 100]).round().tolist(),
               last_end_ns=int((t[:, stamps[-1]] - t0).max()), stages={})
    print(f"[timeline] {name}: {row['blocks']} blocks on {row['sms']} multiprocessors; block "
          f"starts (0/50/90/100%) {row['block_starts_ns']} ns after the first; the last ends "
          f"{row['last_end_ns']} ns after the first starts [{card}]")
    prev = 0
    for k, label in zip(stamps, labels):
        if not t[:, k].any():               # in a branch no thread 0 took
            continue
        d = t[:, k] - t[:, prev]
        row["stages"][label] = dict(median_ns=int(np.median(d)), max_ns=int(d.max()))
        print(f"[timeline]   {label}: median {int(np.median(d))} ns, largest {int(d.max())} ns")
        prev = k
    return row


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", help="a copy of csrc/image_kernels.cu to time instead")
    ap.add_argument("--only", choices=("detect", "pyramid", "describe", "clahe"),
                    action="append",
                    help="time only these kernels (every one by default)")
    ap.add_argument("--out", help="a JSON file for the rows")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    import chip_smoke
    from alvaar_tpu_torch.ops import image, image_kernels, orb
    from alvaar_tpu_torch.utils.build import find_tool
    if not torch.cuda.is_available():
        print("image_kernel_timeline: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.phase_env()
    only = set(args.only or ("detect", "pyramid", "describe", "clahe"))
    os.makedirs(OUT, exist_ok=True)
    with open(args.source or image_kernels._SRC) as f:
        text = f.read()
    src = os.path.join(OUT, "image_kernels_timed.cu")
    with open(src, "w") as g:
        g.write(timed_source(text))
    path = os.path.join(OUT, "libimage_kernels_timed.so")
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc", "the CUDA toolkit is needed")
    res = subprocess.run([nvcc, *image_kernels._NVCC_FLAGS, "-o", path, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stderr[-3000:], file=sys.stderr)
        return 1
    lib = image_kernels.bind(ctypes.CDLL(path))
    lib.timeline_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    image_kernels._lib = lib
    print(f"[timeline] {args.source or 'the committed source'}", flush=True)

    def launch(fn, blocks):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        assert lib.timeline_clear() == 0
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(SLOTS * MAX_BLOCKS, np.uint64)
        assert lib.timeline_read(buf.ctypes.data, buf.size) == 0
        t = buf.reshape(MAX_BLOCKS, SLOTS)[:min(blocks, MAX_BLOCKS)].astype(np.int64)
        return t[t[:, 0] != 0] if blocks < MAX_BLOCKS else t   # ``blocks`` may be an upper bound

    dev = torch.device("cuda")
    rows = []
    for case in chip_smoke.IMAGE_DETECT_CASES if "detect" in only else ():
        name, W, H, cell, _, S = case
        fn = chip_smoke._detect_calls(*case, dev)[0]
        blocks = S * -(-H // cell) * -(-W // cell)
        rows.append(_stages(f"detect_cells_kernel {name}", launch(fn, blocks), CELL_STAGES,
                            CELL_LABELS, card))
    for name, W, H, B in chip_smoke.IMAGE_STACK_CASES if "pyramid" in only else ():
        x = chip_smoke._image_stack(W, H, B, dev)
        x = x if B > 1 else x[0]
        h2, w2 = (H + 3) // 4, (W + 3) // 4
        blocks = B * -(-h2 // _constant(text, "kPyrTileY")) * \
            -(-w2 // _constant(text, "kPyrTileX"))
        if blocks > MAX_BLOCKS:
            print(f"[timeline] pyramid_kernel {name}: {blocks} blocks, the first {MAX_BLOCKS} "
                  f"kept")
        rows.append(_stages(f"pyramid_kernel {name}",
                            launch(lambda: image.build_pyramid(x, 3), blocks), PYR_STAGES,
                            PYR_LABELS, card))
    # K3 with the source's own steering table: [30, 256, 2] int32 up to
    # commit c08cb84, each pair packed in one int32 since
    packed = "taps [30, 256, 2]" not in text
    taps = torch.as_tensor(orb._TAP_PAIRS if packed else orb._TAP_LUTS.astype(np.int32),
                           device=dev)
    describe = chip_smoke._describe_launcher(lib, taps)
    labels = describe_labels(text)
    stamps = tuple(range(DESC_FIRST, DESC_FIRST + len(labels)))
    for name, W, H, N, S, _ in chip_smoke.IMAGE_DESCRIBE_CASES if "describe" in only else ():
        imgs, xy, valid, _, _ = chip_smoke._describe_calls(W, H, N, S, dev)
        rows.append(_stages(f"describe_kernel {name}",     # at most a block a keypoint
                            launch(lambda: describe(imgs, xy, valid), S * N), stamps, labels,
                            card))
    for name, W, H, B in chip_smoke.IMAGE_CLAHE_CASES if "clahe" in only else ():
        x = chip_smoke._clahe_input(W, H, B, dev)
        x = x if B > 1 else x[0]
        t = launch(lambda: image.clahe(x), MAX_BLOCKS)
        lut_t = t[t[:, 5] != 0]         # the table kernel's blocks
        rows.append(_stages(f"clahe_lut_kernel {name}", lut_t, CLAHE_LUT_STAGES,
                            CLAHE_LUT_LABELS, card))
        apply_t = np.zeros_like(t[t[:, 8] != 0])       # its stamps as the first columns
        apply_t[:, :4] = t[t[:, 8] != 0][:, 8:12]
        apply_t[:, 15] = 1
        rows.append(_stages(f"clahe_apply_kernel {name}", apply_t, CLAHE_APPLY_STAGES,
                            CLAHE_APPLY_LABELS, card))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, source=args.source, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
