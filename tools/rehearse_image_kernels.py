#!/usr/bin/env python3
"""Run the image kernels' CUDA source (csrc/image_kernels.cu: K7, K5, K3,
K8) on the CPU and hold it to chip_smoke.py phase 2e's bars: the rehearsal
before a chip call, where no card and no nvcc exist.

    python3 tools/rehearse_image_kernels.py [--full]

The source is translated and built into ``build/rehearsal/`` by
tools/cuda_on_cpu.py (the CUDA includes replaced by tools/cpu_cuda_shim.h,
every CUDA thread a fiber on one host thread).  Then
``ops/image_kernels`` is pointed at that library with the CUDA calls
around a launch stubbed, the custom ops' CPU kernels are the launchers,
and ``rgba_to_gray``, ``pyr_down``, ``clahe``, ``detect_grid`` and
``describe`` launch the kernels on CPU tensors.  The checks are phase 2e's own
function (``chip_smoke._image_checks``): K7 and K5 bit-equal to their
plain versions (K7's pyramids at odd sizes and 3 and 4 levels, K5's traps
too), K3's angles within 2e-5 rad and its words bit-equal at every
keypoint whose plain angle lies more than 1e-4 rad from a steering bin's
edge, K8's tables and output bit-equal at clip 3.0 and within 1e-3 at
2.7, rows under vmap (and of a stack) equal to each row alone, one launch
per call (two for K5 and K8, one per two pyramid levels).  Without ``--full`` the stacks are
cut (the B = 64 1080p stack takes minutes on the CPU) and K5 at S = 65 535
rows is left out; then the card tests' cases
(tests/test_torch_image_kernels_card.py).
Exits non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import cuda_on_cpu  # noqa: E402  (tools/, beside this file)

ROOT = cuda_on_cpu.ROOT
OUT = os.path.join(ROOT, "build", "rehearsal")


def build(out: str = OUT) -> str:
    """The translated source built into ``out``; returns the library's path."""
    return cuda_on_cpu.build("image_kernels.cu", out)


@contextlib.contextmanager
def on_cpu(lib_path):
    """The image kernels' wrappers launch the CPU build on CPU tensors."""
    from alvaar_tpu_torch.ops import detect, image, image_kernels, orb
    ops = ((detect._DETECT_OP, detect._launch_detect, detect._detect_rows),
           (orb._DESCRIBE_OP, orb._launch_describe, orb._describe_rows))
    mods = (image, detect, orb)
    saved = (image_kernels._lib, image_kernels._cuda) + tuple(m._dispatch for m in mods)
    image_kernels._lib = image_kernels.bind(ctypes.CDLL(lib_path))
    image_kernels._cuda = lambda dev: None
    for m in mods:
        m._dispatch = lambda x, name: True
    for op, launch, _ in ops:      # the custom ops' CPU kernels: the launchers
        op.register_kernel("cpu")(launch)
    try:
        with cuda_on_cpu.cuda_stubs():
            yield
    finally:
        for op, _, plain in ops:
            op.register_kernel("cpu")(plain)
        image_kernels._lib, image_kernels._cuda = saved[:2]
        for m, d in zip(mods, saved[2:]):
            m._dispatch = d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import chip_smoke

    torch.set_num_threads(2)
    t0 = time.time()
    lib = build()
    print(f"[rehearsal] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.1f} s",
          flush=True)
    cpu = torch.device("cpu")
    with on_cpu(lib):
        chip_smoke._image_checks(cpu, quick=not args.full)
        import test_torch_image_kernels_card as card_tests
        for name in card_tests.CARD_CASES:
            card_tests.test_detect_and_describe_on_card(cpu, name)
        card_tests.test_pyramid_and_gray_on_card(cpu)
        card_tests.test_rows_under_vmap_on_card(cpu)
        for case in card_tests.PYRAMID_CASES:
            card_tests.test_fused_pyramid_on_card(cpu, *case)
        for name in card_tests.TRAP_CASES:
            card_tests.test_detect_traps_on_card(cpu, name)
        if args.full:
            card_tests.test_detect_65535_rows_on_card(cpu)
        print("[rehearsal] card tests: passed", flush=True)
    print(f"[rehearsal] every bar held in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
