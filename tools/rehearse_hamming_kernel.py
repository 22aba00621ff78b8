#!/usr/bin/env python3
"""Run descriptor Hamming's CUDA source (csrc/hamming.cu) on the CPU and
hold it to chip_smoke.py phase 2d's bars: the rehearsal before a chip call,
where no card and no nvcc exist.

    python3 tools/rehearse_hamming_kernel.py [--full]

The source is translated and built into ``build/rehearsal/`` by
tools/cuda_on_cpu.py (the CUDA includes replaced by tools/cpu_cuda_shim.h,
every CUDA thread a fiber on one host thread).  Then ``ops/hamming_kernel``
is pointed at that library with the CUDA calls around a launch stubbed,
the custom ops' CPU kernels are the launchers, and ``hamming_min_crossbag``,
``hamming_best_two`` and ``hamming_matrix_chunked`` launch the kernel on
CPU tensors.  The checks
are phase 2d's own function (``chip_smoke._hamming_checks``): bit-equal to
the plain versions, run to run and row by row, one launch per call under
vmap.  Without ``--full`` the min cross-bag cases keep their K, G and S
with L cut to 520 landmarks (the plain version at L = 4096 takes ~14 s a
call on the CPU; ``--full`` ~8 min); the loop cases run at their sizes.
Then the card tests' cases (tests/test_torch_hamming_kernel_card.py; the
ragged shapes up to 1037 x 201, the best two at its shapes but 192 x
49 152, which phase 2d's checks already run).
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
QUICK_L = 520


def build(out: str = OUT) -> str:
    """The translated source built into ``out``; returns the library's path."""
    return cuda_on_cpu.build("hamming.cu", out)


@contextlib.contextmanager
def on_cpu(lib_path):
    """K4's wrappers launch the CPU build on CPU tensors."""
    from alvaar_tpu_torch.ops import hamming, hamming_kernel
    ops = ((hamming._MIN_CROSSBAG_OP, hamming._launch_min_crossbag, hamming._min_crossbag_rows),
           (hamming._MATRIX_OP, hamming._launch_matrix, hamming._matrix_rows),
           (hamming._BEST_TWO_OP, hamming._launch_best_two, hamming._best_two_rows))
    saved = (hamming_kernel._lib, hamming_kernel._cuda, hamming._dispatch)
    hamming_kernel._lib = hamming_kernel.bind(ctypes.CDLL(lib_path))
    hamming_kernel._cuda = lambda dev: None
    hamming._dispatch = lambda x, name: True
    for op, launch, _ in ops:      # the custom ops' CPU kernels: the launchers
        op.register_kernel("cpu")(launch)
    try:
        with cuda_on_cpu.cuda_stubs():
            yield
    finally:
        for op, _, plain in ops:
            op.register_kernel("cpu")(plain)
        hamming_kernel._lib, hamming_kernel._cuda, hamming._dispatch = saved


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
    cases = chip_smoke.HAMMING_CASES
    if not args.full:
        cases = tuple((f"{name} (L cut to {QUICK_L})", S, min(N, QUICK_L), M, G)
                      for name, S, N, M, G in cases)
    cpu = torch.device("cpu")
    with on_cpu(lib):
        chip_smoke._hamming_checks(cpu, cases)
        import test_torch_hamming_kernel_card as card_tests
        card_tests.test_min_crossbag_on_card(cpu, "matching")
        card_tests.test_min_crossbag_on_card(cpu, "extreme words")
        card_tests.test_min_crossbag_fragment_layout_on_card(cpu)
        for g in range(1, 9):
            card_tests.test_min_crossbag_bag_sizes_on_card(cpu, g)
        for n, m in ((1, 1), (15, 7), (17, 9), (1037, 201)):
            card_tests.test_min_crossbag_ragged_on_card(cpu, n, m)
        card_tests.test_loop_queries_on_card(cpu)
        for kind in card_tests.BEST_TWO_KINDS:
            for shape in ((1, 192, 192), (1, 192, 3072), (4, 192, 3072), (1, 37, 1),
                          (3, 352, 1037)):
                card_tests.test_best_two_on_card(cpu, kind, *shape)
        card_tests.test_slice_on_card(cpu)
        print("[rehearsal] card tests: passed", flush=True)
    print(f"[rehearsal] every bar held in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
