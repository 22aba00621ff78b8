"""Run a CUDA source of the port (alvaar_tpu_torch/csrc/*.cu) on the CPU,
where no card and no nvcc exist: the rehearsals before a chip call
(tools/rehearse_ba_kernels.py, tools/rehearse_pnp_kernel.py,
tools/rehearse_hamming_kernel.py, tools/rehearse_image_kernels.py) and
their tier-1 tests share these.

``translate`` replaces the CUDA includes by tools/cpu_cuda_shim.h and each
``kernel<<<grid, block, ...>>>(args)`` by ``cpu_launch(kernel, grid,
block, args)``; ``build`` compiles the result with ``g++ -std=c++20 -O1
-ffp-contract=off`` (nvcc's ``--fmad=false``): every CUDA thread a fiber
on one host thread.  ``cuda_stubs`` stubs the CUDA calls that a launcher
makes around a launch (``torch.cuda.device``, ``current_stream``,
``synchronize``), so that the launchers run on CPU tensors.
"""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def translate(src: str) -> str:
    """The CUDA source with the shim's include and ``cpu_launch`` calls."""
    src = re.sub(r"#include <cuda_(runtime|pipeline|bf16)\.h>\n", "", src)
    src = '#include "cpu_cuda_shim.h"\n' + src
    out, pos = [], 0
    for m in re.finditer(r"(\w+)<<<", src):
        if m.start() < pos:
            continue
        end = src.index(">>>(", m.end())
        parts, depth, cur = [], 0, ""
        for ch in src[m.end():end]:
            if ch == "," and depth == 0:
                parts.append(cur.strip())
                cur = ""
                continue
            depth += ch in "(<"
            depth -= ch in ")>"
            cur += ch
        parts.append(cur.strip())
        out.append(src[pos:m.start()])
        out.append(f"cpu_launch({m.group(1)}, {parts[0]}, {parts[1]}, ")
        pos = end + 4
    out.append(src[pos:])
    return "".join(out)


def build(source: str, out: str) -> str:
    """alvaar_tpu_torch/csrc/``source`` (or the CUDA file at the absolute
    path ``source``) translated and built into ``out``; returns the
    library's path."""
    os.makedirs(out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    with open(os.path.join(ROOT, "alvaar_tpu_torch", "csrc", source)) as f:
        cpp = translate(f.read())
    path = os.path.join(out, f"{stem}_cpu.cpp")
    with open(path, "w") as f:
        f.write(cpp)
    lib = os.path.join(out, f"lib{stem}_cpu.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-U_FORTIFY_SOURCE", "-shared", "-fPIC", "-I", os.path.join(ROOT, "tools"),
                    "-o", lib, path], check=True)
    return lib


@contextlib.contextmanager
def cuda_stubs():
    """Within: the CUDA calls around a launch do nothing."""
    import torch
    saved = (torch.cuda.device, torch.cuda.current_stream, torch.cuda.synchronize)
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=None)
    torch.cuda.synchronize = lambda *a: None
    try:
        yield
    finally:
        torch.cuda.device, torch.cuda.current_stream, torch.cuda.synchronize = saved
