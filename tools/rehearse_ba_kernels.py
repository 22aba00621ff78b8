#!/usr/bin/env python3
"""Run local BA's CUDA source (csrc/ba_kernels.cu) on the CPU and hold it to
chip_smoke.py phase 2b's bars: the rehearsal before a chip call, where no
card and no nvcc exist.

    python3 tools/rehearse_ba_kernels.py [--quick]

The source is translated and built into ``build/rehearsal/`` by
tools/cuda_on_cpu.py (the CUDA includes replaced by tools/cpu_cuda_shim.h,
every CUDA thread a fiber on one host thread).
Then ``solvers/ba_kernels`` is pointed at that library with the CUDA
calls around a launch stubbed, and local BA's wrappers launch the kernels
on CPU tensors.  The checks are phase 2b's own functions
(``chip_smoke._ba_case``, ``_ba_batched``): every block against the plain
version and a float64 evaluation, the residual pass's r^2 and z bit-equal
to the plain pass, bits run to run, S rows under vmap bit-equal to each row
alone, whole ``local_ba`` at ``test_local_ba_matches``' bars; on
tests/test_torch_solvers.py's two problems, the W = 30 forward windows at
K = 130, 240, 352 (20 LM iterations), the clamp and bench problems
(printed), and an S = 3 stack; then the card tests' dense cases
(tests/test_torch_ba_kernels_card.py: K = 352, and K = 240 as S = 11
rows).  ``--quick`` takes the two small problems, one K = 130 window and
the S = 3 stack.  Exits non-zero when a bar fails.
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
    return cuda_on_cpu.build("ba_kernels.cu", out)


@contextlib.contextmanager
def on_cpu(lib_path):
    """Local BA's wrappers launch the CPU build on CPU tensors."""
    from alvaar_tpu_torch.solvers import ba, ba_kernels
    ops = ((ba._LINEARIZE_OP, ba._launch_linearize, ba._linearize_rows),
           (ba._RESIDUALS_OP, ba._launch_residuals, ba._residuals_rows),
           (ba._SCHUR_OP, ba._launch_schur, ba._schur_rows))
    saved = (ba_kernels._lib, ba_kernels._cuda, ba._dispatch)
    ba_kernels._lib = ba_kernels.bind(ctypes.CDLL(lib_path))
    ba_kernels._cuda = lambda dev, what: None
    ba._dispatch = lambda x, name: True
    for op, launch, _ in ops:      # the custom ops' CPU kernels: the launchers
        op.register_kernel("cpu")(launch)
    try:
        with cuda_on_cpu.cuda_stubs():
            yield
    finally:
        for op, _, plain in ops:
            op.register_kernel("cpu")(plain)
        ba_kernels._lib, ba_kernels._cuda, ba._dispatch = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    import chip_smoke
    from ba_problems import CAM, bench_problem, build_problem, clamp_problem
    from alvaar_tpu_torch import config
    from alvaar_tpu_torch.config import SlamConfig
    from alvaar_tpu_torch.solvers.pnp import CHI2_THRESH_2DOF

    torch.set_num_threads(2)
    t0 = time.time()
    lib = build()
    print(f"[rehearsal] built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.1f} s",
          flush=True)
    delta = SlamConfig().huber_thresh
    with on_cpu(lib):
        for frac in (0.0, 0.05):
            prob, cam = build_problem(np.random.default_rng(0), outlier_frac=frac)
            chip_smoke._ba_case(f"test_torch_solvers problem, outliers {frac}", prob, cam,
                                CHI2_THRESH_2DOF ** 0.5)
        widths = ((config.FAST.max_keypoints,) if args.quick else
                  (config.FAST.max_keypoints, 240, config.ACCURATE.max_keypoints))
        for K in widths:
            prob, cam = build_problem(np.random.default_rng(K), W=30, L=2 * K, K=K)
            chip_smoke._ba_case(f"forward window K={K}", prob, cam, delta,
                                iters=chip_smoke.BA_WINDOW_ITERS)
        if not args.quick:
            prob, cam = clamp_problem(np.random.default_rng(0))
            chip_smoke._ba_case("clamp slots", prob, cam, delta, whole="printed")
            bench, bcam = bench_problem(np.random.default_rng(0))
            chip_smoke._ba_case("bench problem L=10240", bench, bcam, delta, whole="printed")
        rows = [build_problem(np.random.default_rng(240 + i), W=30, L=480, K=240)[0]
                for i in range(3)]
        chip_smoke._ba_batched(rows, CAM, delta)
        if not args.quick:
            # the card's dense cases: K = 352, and K = 240 as S = 11 rows
            import test_torch_ba_kernels_card as card_tests
            for K, S in ((352, 1), (240, 11)):
                card_tests.test_kernels_at_dense_windows_on_card(torch.device("cpu"), K, S)
                print(f"[rehearsal] card test at K={K}, S={S}: passed", flush=True)
    print(f"[rehearsal] every bar held in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
