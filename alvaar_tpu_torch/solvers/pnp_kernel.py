"""Motion-only PnP's kernel K9 (csrc/pnp_kernel.cu): its build, argument
checks and launch.

``pnp_refine_kernel`` runs the whole of ``pnp_refine`` (the Huber LM, the
chi²/depth prune, the L2 LM over the inliers, the final flags) for S rows
in one launch, a block per row: one call serves every row that
``torch.func.vmap`` batches (``solvers/pnp.py`` registers the custom op and
its batching rule).  The plain version and the wrapper that dispatches on
the device are in ``solvers/pnp.py``; this module only launches, on CUDA
tensors.

The library is compiled with ``nvcc`` at first use into ``build/`` at the
repository root (one shared library with plain C entry points, loaded with
``ctypes``; utils/build.py), and rebuilt when the source's hash changes.
The launch runs on its tensors' device and that device's current stream.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from alvaar_tpu_torch.utils.build import build_library, find_tool

THREADS = 256     # threads per block, one block per row (csrc/pnp_kernel.cu kThreads)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "pnp_kernel.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
_LOAD_LOCK = threading.Lock()


def build_kernel(verbose: bool = False) -> Path:
    """Compile csrc/pnp_kernel.cu with nvcc into ``build/`` unless a library
    built from the same source and flags is already there.  Returns its
    path."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA toolkit is needed to build the PnP kernel")
    return build_library(_SRC, nvcc, _NVCC_FLAGS, verbose=verbose)


def bind(lib):
    """Declare the library's C entry points on the ``ctypes`` handle ``lib``
    and check its block size against this module's.  Returns ``lib``."""
    ptr, i32, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    fn = lib.pnp_refine_launch
    fn.restype = i32
    fn.argtypes = [ptr] * 5 + [i32] * 2 + [f32] * 4 + [i32, f64, f32, i32] + [ptr] * 6
    lim = lib.pnp_kernel_limits
    lim.restype = i32
    lim.argtypes = [ctypes.POINTER(i32)]
    got = i32()
    lim(ctypes.byref(got))
    if got.value != THREADS:
        raise RuntimeError(f"kernel block size {got.value} differs from {THREADS}")
    return lib


def _load():
    """The built library, bound and checked (built and opened once, by the
    first thread that asks)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernel())))
    return _lib


def check_args(q, t, points_w, px_obs, valid):
    """Raise unless K9 takes these: on one device, float32 q [S, 4], t [S,
    3], points_w [S, N, 3], px_obs [S, N, 2], bool valid [S, N], all
    contiguous, 1 <= S < 2^31.  Returns (S, N)."""
    if not isinstance(points_w, torch.Tensor) or points_w.dim() != 3:
        raise ValueError("points_w must be a [S, N, 3] tensor")
    s, n, _ = points_w.shape
    if not 1 <= s < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= S < 2^31 rows and N < 2^31; got S={s}, N={n}")
    dev = points_w.device
    f32 = torch.float32
    for name, x, dt, shape in (("q", q, f32, (s, 4)), ("t", t, f32, (s, 3)),
                               ("points_w", points_w, f32, (s, n, 3)),
                               ("px_obs", px_obs, f32, (s, n, 2)),
                               ("valid", valid, torch.bool, (s, n))):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} is a {type(x).__name__}, expected a tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dt}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return s, n


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"pnp_refine's kernel runs on CUDA tensors, got {dev}")


def launch(q, t, points_w, px_obs, valid, cam, iters: int, huber_delta: float,
           chi2_thresh: float, refine_l2: bool):
    """K9 on S rows: (q [S, 4], t [S, 3], inliers [S, N] bool, num_inliers
    [S] int64, cost [S] float32); ``cam`` is (fx, fy, cx, cy)."""
    s, n = check_args(q, t, points_w, px_obs, valid)
    _cuda(points_w.device)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    lib, dev = _load(), points_w.device
    q_out, t_out = torch.empty_like(q), torch.empty_like(t)
    inliers = torch.empty((s, n), dtype=torch.bool, device=dev)
    num = torch.empty(s, dtype=torch.int64, device=dev)
    cost = torch.empty(s, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.pnp_refine_launch(
            *[x.data_ptr() for x in (q, t, points_w, px_obs, valid)], s, n, *cam, int(iters),
            float(huber_delta), float(chi2_thresh), int(bool(refine_l2)),
            *[x.data_ptr() for x in (q_out, t_out, inliers, num, cost)],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pnp_refine launch failed: cudaError_t {rc}")
    return q_out, t_out, inliers, num, cost
