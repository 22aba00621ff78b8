"""Local BA's kernels (csrc/ba_kernels.cu): their build, argument checks and
launches.

K6a linearises a [W, K] window and assembles the normal-equation blocks in
two launches (``ba_linearize_eval_kernel`` evaluates each observation once
into a scratch, ``ba_linearize_reduce_kernel`` sums the blocks), and runs
the residual pass in two (``ba_residuals_kernel``, ``ba_residuals_sum_
kernel``); K6b ``ba_schur_kernel`` assembles the damped, masked Schur
complement in one.  Each takes S problems at once (a leading [S] on every
tensor): one call serves every row that ``torch.func.vmap`` batches
(``solvers/ba.py`` registers the custom ops and their batching rules).  The
plain versions and the wrappers that dispatch on the device are in
``solvers/ba.py``; this module only launches, on CUDA tensors.

The library is compiled with ``nvcc`` at first use into ``build/`` at the
repository root (one shared library with plain C entry points, loaded with
``ctypes``; utils/build.py), and rebuilt when the source's hash changes.
Each launch runs on its tensors' device and that device's current stream;
its scratch is allocated there with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from alvaar_tpu_torch.utils.build import build_library, find_tool

W_MAX = 64        # window rows the kernels take (csrc/ba_kernels.cu kWMax)
THREADS = 256     # threads per block of the reducing kernels (kThreads)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "ba_kernels.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
_LOAD_LOCK = threading.Lock()


def build_kernel(verbose: bool = False) -> Path:
    """Compile csrc/ba_kernels.cu with nvcc into ``build/`` unless a
    library built from the same source and flags is already there.
    Returns its path."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA toolkit is needed to build local BA's kernels")
    return build_library(_SRC, nvcc, _NVCC_FLAGS, verbose=verbose)


def bind(lib):
    """Declare the library's C entry points on the ``ctypes`` handle ``lib``
    and check its limits against this module's.  Returns ``lib``."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lin = lib.ba_linearize_launch
    lin.restype = i32
    lin.argtypes = [ptr] * 9 + [i32] * 3 + [f32] * 5 + [ptr] * 8
    res = lib.ba_residuals_launch
    res.restype = i32
    res.argtypes = [ptr] * 8 + [i32] * 3 + [f32] * 5 + [ptr] * 6
    for size in (lib.ba_linearize_scratch_bytes, lib.ba_residuals_scratch_bytes):
        size.restype = i64
        size.argtypes = [i32] * 3
    schur = lib.ba_schur_launch
    schur.restype = i32
    schur.argtypes = [ptr] * 10 + [i32] * 3 + [ptr] * 3
    lim = lib.ba_kernels_limits
    lim.restype = i32
    lim.argtypes = [ctypes.POINTER(i32)] * 2
    got = [i32(), i32()]
    lim(*(ctypes.byref(v) for v in got))
    if [v.value for v in got] != [W_MAX, THREADS]:
        raise RuntimeError(f"kernel limits {[v.value for v in got]} differ from "
                           f"{[W_MAX, THREADS]}")
    return lib


def _load():
    """The built library, bound and checked (built and opened once, by the
    first thread that asks)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernel())))
    return _lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} is a {type(t).__name__}, expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(name, x):
    """(S, W, K) from ``x`` [S, W, K]."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError(f"{name} must be a [S, W, K] tensor")
    s, w, k = x.shape
    if not 1 <= w <= W_MAX or k < 1 or s < 1:
        raise ValueError(f"the kernels take 1 to {W_MAX} window rows, K >= 1 and S >= 1; "
                         f"got S={s}, W={w}, K={k}")
    if s > 65535:
        raise ValueError(f"the kernels take at most 65535 rows, got {s}")
    return s, w, k


def check_linearize_args(q, t, lam_v, valid, px, mxy, first, a_idx, constant=None):
    """Raise unless K6a takes these: on one device, float32 poses q [S, W,
    4], t [S, W, 3], inverse depths lam_v [S, W, K], pixels px and anchor
    coordinates mxy [S, W, K, 2], bool masks valid [S, W, K] and constant
    [S, W] (the residual pass takes none), int64 indices first and a_idx
    [S, W, K], all contiguous.  Returns (S, W, K)."""
    s, w, k = _dims("lam_v", lam_v)
    dev = lam_v.device
    f32, i64, b = torch.float32, torch.int64, torch.bool
    args = [("q", q, f32, (s, w, 4)), ("t", t, f32, (s, w, 3)), ("lam_v", lam_v, f32, (s, w, k)),
            ("valid", valid, b, (s, w, k)), ("px", px, f32, (s, w, k, 2)),
            ("mxy", mxy, f32, (s, w, k, 2)), ("first", first, i64, (s, w, k)),
            ("a_idx", a_idx, i64, (s, w, k))]
    if constant is not None:
        args.append(("constant", constant, b, (s, w)))
    for name, x, dt, shape in args:
        _check(name, x, dt, shape, dev)
    return s, w, k


def check_schur_args(D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free):
    """Raise unless K6b takes these: on one device, float32 D, g_l [S, W,
    K], u, va [S, W, K, 6], H [S, 6W, 6W], g_c [S, 6W], lam_lm [S], int64
    first, a_idx [S, W, K], bool free [S, W], all contiguous.  Returns
    (S, W, K)."""
    s, w, k = _dims("D", D)
    dev = D.device
    f32, i64 = torch.float32, torch.int64
    c = 6 * w
    for name, x, dt, shape in (("D", D, f32, (s, w, k)), ("u", u, f32, (s, w, k, 6)),
                               ("va", va, f32, (s, w, k, 6)), ("first", first, i64, (s, w, k)),
                               ("a_idx", a_idx, i64, (s, w, k)), ("H", H, f32, (s, c, c)),
                               ("g_c", g_c, f32, (s, c)), ("g_l", g_l, f32, (s, w, k)),
                               ("lam_lm", lam_lm, f32, (s,)), ("free", free, torch.bool, (s, w))):
        _check(name, x, dt, shape, dev)
    return s, w, k


def _cuda(dev, what):
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def launch_linearize(q, t, lam_v, valid, px, mxy, first, a_idx, constant, cam, huber_delta):
    """K6a on S rows: (H_cc [S, 6W, 6W], g_c [S, 6W], u [S, W, K, 6], va [S,
    W, K, 6], D [S, W, K], g_l [S, W, K])."""
    _cuda(lam_v.device, "ba_linearize")
    s, w, k = check_linearize_args(q, t, lam_v, valid, px, mxy, first, a_idx, constant)
    lib, dev, c = _load(), lam_v.device, 6 * w
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    H, g_c, u, va = new(s, c, c), new(s, c), new(s, w, k, 6), new(s, w, k, 6)
    D, g_l = new(s, w, k), new(s, w, k)
    scratch = torch.empty(lib.ba_linearize_scratch_bytes(s, w, k), dtype=torch.uint8,
                          device=dev)
    ptrs = [x.data_ptr() for x in (q, t, lam_v, valid, px, mxy, first, a_idx, constant)]
    with torch.cuda.device(dev):
        rc = lib.ba_linearize_launch(
            *ptrs, s, w, k, *cam, huber_delta,
            *[x.data_ptr() for x in (H, g_c, u, va, D, g_l, scratch)], _stream(dev))
    _raise_on(rc, "ba_linearize")
    return H, g_c, u, va, D, g_l


def launch_residuals(q, t, lam_v, valid, px, mxy, first, a_idx, cam, huber_delta):
    """K6a's residual pass on S rows: (cost [S] float64, r2, z, lam_obs [S,
    W, K] float32); the cost is evaluated and summed in float64."""
    _cuda(lam_v.device, "ba_residuals")
    s, w, k = check_linearize_args(q, t, lam_v, valid, px, mxy, first, a_idx)
    lib, dev = _load(), lam_v.device
    cost = torch.empty(s, dtype=torch.float64, device=dev)
    r2, z, lam_obs = (torch.empty((s, w, k), dtype=torch.float32, device=dev) for _ in range(3))
    scratch = torch.empty(lib.ba_residuals_scratch_bytes(s, w, k), dtype=torch.uint8,
                          device=dev)
    ptrs = [x.data_ptr() for x in (q, t, lam_v, valid, px, mxy, first, a_idx)]
    with torch.cuda.device(dev):
        rc = lib.ba_residuals_launch(
            *ptrs, s, w, k, *cam, huber_delta,
            *[x.data_ptr() for x in (cost, r2, z, lam_obs, scratch)], _stream(dev))
    _raise_on(rc, "ba_residuals")
    return cost, r2, z, lam_obs


def launch_schur(D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free):
    """K6b on S rows: (S [S, 6W, 6W], g_s [S, 6W])."""
    _cuda(D.device, "ba_schur")
    s, w, _ = check_schur_args(D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free)
    lib, dev, c = _load(), D.device, 6 * w
    S = torch.empty((s, c, c), dtype=torch.float32, device=dev)
    g_s = torch.empty((s, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ba_schur_launch(
            *[x.data_ptr() for x in (D, u, va, first, a_idx, H, g_c, g_l, lam_lm, free)],
            s, w, D.shape[2], S.data_ptr(), g_s.data_ptr(), _stream(dev))
    _raise_on(rc, "ba_schur")
    return S, g_s
