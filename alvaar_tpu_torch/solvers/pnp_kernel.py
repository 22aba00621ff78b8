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
The launch runs on its tensors' device and that device's current stream,
into one buffer whose views are the five outputs.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from alvaar_tpu_torch.utils.build import build_library, find_tool
from alvaar_tpu_torch.utils.custom_ops import raw_stream

BLOCK_THREADS = 128   # threads per block at most, from 128 points a row up (csrc/pnp_kernel.cu)
REG_POINTS = 32       # a thread's points whose flags the kernel keeps as register bits

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
    fn.argtypes = [ptr] * 5 + [i32] * 3 + [f32] * 4 + [i32, f64, f32, i32] + [ptr] * 2
    lim = lib.pnp_kernel_limits
    lim.restype = i32
    lim.argtypes = [ctypes.POINTER(i32)] * 2
    threads, reg_points = i32(), i32()
    lim(ctypes.byref(threads), ctypes.byref(reg_points))
    if (threads.value, reg_points.value) != (BLOCK_THREADS, REG_POINTS):
        raise RuntimeError(f"kernel limits {threads.value}, {reg_points.value} differ from "
                           f"{BLOCK_THREADS}, {REG_POINTS}")
    return lib


def threads_for(n: int) -> int:
    """K9's threads per block for rows of ``n`` points: a warp per 32
    points, 1 to 4 warps."""
    return min(BLOCK_THREADS, max(32, -(-n // 32) * 32))


def out_bytes(s: int, n: int, threads: int) -> int:
    """The bytes of a launch's one buffer: num [S] int64, q [S, 4], t [S,
    3] and cost [S] float32, the flags [S, N] bool, and the flags' spill
    [S, 3, N - 32 threads] when a thread has more than 32 points."""
    return 40 * s + s * n + 3 * s * max(0, n - REG_POINTS * threads)


def unpack(buf, s: int, n: int, rows: bool = True):
    """The outputs' views of a launch's buffer (bool): (q [S, 4], t [S,
    3], inliers [S, N], num_inliers [S], cost [S]); without S when not
    ``rows``."""
    f32 = buf[8 * s:40 * s].view(torch.float32)
    num = buf[:8 * s].view(torch.int64)
    inliers = buf[40 * s:40 * s + s * n]
    if not rows:
        return f32[:4], f32[4:7], inliers, num[0], f32[7]
    return (f32[:4 * s].view(s, 4), f32[4 * s:7 * s].view(s, 3), inliers.view(s, n), num,
            f32[7 * s:])


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
    contiguous, 1 <= S < 2^31 (or one problem: the same without S).
    Returns (S, N), S = 1 for one problem."""
    if not isinstance(points_w, torch.Tensor) or points_w.dim() not in (2, 3):
        raise ValueError("points_w must be a [S, N, 3] or [N, 3] tensor")
    lead = tuple(points_w.shape[:-2])
    s, n = (lead or (1,))[0], points_w.shape[-2]
    if not 1 <= s < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= S < 2^31 rows and N < 2^31; got S={s}, N={n}")
    dev = points_w.device
    f32 = torch.float32
    for name, x, dt, shape in (("q", q, f32, (4,)), ("t", t, f32, (3,)),
                               ("points_w", points_w, f32, (n, 3)),
                               ("px_obs", px_obs, f32, (n, 2)), ("valid", valid, torch.bool, ())):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} is a {type(x).__name__}, expected a tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dt}")
        want = lead + ((n,) if name == "valid" else shape)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return s, n


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"pnp_refine's kernel runs on CUDA tensors, got {dev}")


def launch(q, t, points_w, px_obs, valid, cam, iters: int, huber_delta: float,
           chi2_thresh: float, refine_l2: bool):
    """K9 on S rows: (q [S, 4], t [S, 3], inliers [S, N] bool, num_inliers
    [S] int64, cost [S] float32), views of one buffer; on one problem
    (points_w [N, 3]) the same without S.  ``cam`` is (fx, fy, cx, cy)."""
    s, n = check_args(q, t, points_w, px_obs, valid)
    dev = points_w.device
    _cuda(dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    lib = _lib or _load()
    threads = threads_for(n)
    buf = torch.empty(out_bytes(s, n, threads), dtype=torch.bool, device=dev)
    args = (q.data_ptr(), t.data_ptr(), points_w.data_ptr(), px_obs.data_ptr(), valid.data_ptr(),
            s, n, threads, *cam, int(iters), float(huber_delta), float(chi2_thresh),
            int(bool(refine_l2)), buf.data_ptr(), raw_stream(dev))
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = lib.pnp_refine_launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.pnp_refine_launch(*args)
    if rc != 0:
        raise RuntimeError(f"pnp_refine launch failed: cudaError_t {rc}")
    return unpack(buf, s, n, points_w.dim() == 3)
