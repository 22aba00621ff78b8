#!/usr/bin/env python3
"""Run motion-only PnP's CUDA source (csrc/pnp_kernel.cu) on the CPU and
hold it to chip_smoke.py phase 2c's bars: the rehearsal before a chip call,
where no card and no nvcc exist.

    python3 tools/rehearse_pnp_kernel.py

The source is translated and built into ``build/rehearsal/`` by
tools/cuda_on_cpu.py (the CUDA includes replaced by tools/cpu_cuda_shim.h,
every CUDA thread a fiber on one host thread).  Then ``solvers/pnp_kernel``
is pointed at that library with the CUDA calls around a launch stubbed, and
``pnp_refine`` launches the kernel on CPU tensors.  The checks are phase
2c's own function (``chip_smoke._pnp_checks``) at its shapes: N = 130, 192,
240, 352 at S = 1 and 4 LM iterations, 16 x 192, 64 x 240, 8 iterations
at N = 192, outlier fractions 0 and 0.3 with points behind the camera and
masked slots, an all-masked row in a stack; against the plain version and
its float64 evaluation, bits run to run, each row of a stack bit-equal to
its launch alone, one launch per call under vmap; then the card tests'
cases (tests/test_torch_pnp_kernel_card.py).  Exits non-zero when a bar
fails.
"""

from __future__ import annotations

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
    return cuda_on_cpu.build("pnp_kernel.cu", out)


@contextlib.contextmanager
def on_cpu(lib_path):
    """``pnp_refine`` launches the CPU build on CPU tensors."""
    from alvaar_tpu_torch.solvers import pnp, pnp_kernel
    saved = (pnp_kernel._lib, pnp_kernel._cuda, pnp._dispatch)
    pnp_kernel._lib = pnp_kernel.bind(ctypes.CDLL(lib_path))
    pnp_kernel._cuda = lambda dev: None
    pnp._dispatch = lambda x, name: True      # alone and under vmap's rule: K9
    try:
        with cuda_on_cpu.cuda_stubs():
            yield
    finally:
        pnp_kernel._lib, pnp_kernel._cuda, pnp._dispatch = saved


def main() -> int:
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
        chip_smoke._pnp_checks(cpu)
        # the card tests' cases (tests/test_torch_pnp_kernel_card.py)
        import test_torch_pnp_kernel_card as card_tests
        for n in (192, 352):
            for frac in (0.0, 0.3):
                card_tests.test_kernel_matches_float64_on_card(cpu, n, frac)
        card_tests.test_rows_in_one_launch_on_card(cpu)
        for n in (0, 1, 33, 4196):
            card_tests.test_any_n_on_card(cpu, n)
        for n in (20, 50, 70, 200):
            card_tests.test_rows_at_every_block_size_on_card(cpu, n)
        print("[rehearsal] card tests: passed", flush=True)
    print(f"[rehearsal] every bar held in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
