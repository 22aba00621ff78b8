"""Descriptor Hamming's kernel K4 (csrc/hamming.cu): its build, argument
checks and launches.

``launch_min_crossbag`` computes local-map matching's minimum cross-bag
distance, ``launch_best_two`` the loop queries' masked best two per query
row (one launch, or two where the column chunks need a merge) and
``launch_matrix`` the dense distance matrix (the same kernel with a store
epilogue), each for S rows: one call serves every row that
``torch.func.vmap`` batches (``ops/hamming.py`` registers the custom ops
and their batching rule).  The plain versions and the wrappers that
dispatch on the device are in ``ops/hamming.py``; this module only
launches, on CUDA tensors.

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

# csrc/hamming.cu's limits (``bind`` checks that the library has these)
MAX_BAG = 8                    # descriptors a bag at most
MAX_ROWS = 65535               # S: the dense pass's grid.z
MAX_N_CROSSBAG = 0x7FFFFFF0    # rows of A of the min cross-bag pass: its row walk's ints
MAX_N_MATRIX = 65535 * 32      # rows of A of the dense pass: its row blocks along grid.y
WORDS = 8                      # 32-bit words of a 256-bit descriptor

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "hamming.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
_LOAD_LOCK = threading.Lock()


def build_kernel(verbose: bool = False) -> Path:
    """Compile csrc/hamming.cu with nvcc into ``build/`` unless a library
    built from the same source and flags is already there.  Returns its
    path."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA toolkit is needed to build the Hamming kernel")
    return build_library(_SRC, nvcc, _NVCC_FLAGS, verbose=verbose)


def bind(lib):
    """Declare the library's C entry points on the ``ctypes`` handle ``lib``
    and check each limit the wrappers rely on (largest bag, S, N of either
    kernel) against this module's.  Returns ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hamming_min_crossbag_launch.restype = i32
    lib.hamming_min_crossbag_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 2
    lib.hamming_matrix_launch.restype = i32
    lib.hamming_matrix_launch.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 2
    lib.hamming_best_two_launch.restype = i32
    lib.hamming_best_two_launch.argtypes = ([ptr] * 4 + [i32] * 3 + [ctypes.c_float]
                                            + [ptr] * 5 + [i32, ptr])
    lib.hamming_best_two_chunks.restype = i32
    lib.hamming_best_two_chunks.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
    lim = lib.hamming_kernel_limits
    lim.restype = i32
    lim.argtypes = [ctypes.POINTER(i32)] * 4
    want = dict(max_bag=MAX_BAG, max_rows=MAX_ROWS, max_n_crossbag=MAX_N_CROSSBAG,
                max_n_matrix=MAX_N_MATRIX)
    got = {k: i32() for k in want}
    lim(*map(ctypes.byref, got.values()))
    for k, v in want.items():
        if got[k].value != v:
            raise RuntimeError(f"kernel limit {k} {got[k].value} differs from {v}")
    return lib


def _load():
    """The built library, bound and checked (built and opened once, by the
    first thread that asks)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernel())))
    return _lib


def _check(name, x, dtype, shape, dev):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} is a {type(x).__name__}, expected a tensor")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _rows(s: int, n: int, m: int, max_n: int) -> None:
    if not 1 <= s <= MAX_ROWS or n > max_n or m >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= S <= {MAX_ROWS} rows, N <= {max_n} and "
                         f"M < 2^31; got S={s}, N={n}, M={m}")


def check_min_crossbag_args(bag_a, filled_a, bag_b, filled_b):
    """Raise unless K4 takes these: on one device, int32 words bag_a [S, N,
    G, 8] and bag_b [S, M, G, 8] (16-byte aligned: the kernel reads them a
    16-byte piece at a time), bool filled_a [S, N, G] and filled_b [S, M,
    G], all contiguous, 1 <= G <= 8.  Returns (S, N, M, G)."""
    if not isinstance(bag_a, torch.Tensor) or bag_a.dim() != 4:
        raise ValueError("bag_a must be a [S, N, G, 8] tensor")
    s, n, g, _ = bag_a.shape
    if not 1 <= g <= MAX_BAG:
        raise ValueError(f"the kernel takes bags of 1 to {MAX_BAG} descriptors, got G={g}")
    m = bag_b.shape[1] if isinstance(bag_b, torch.Tensor) and bag_b.dim() == 4 else -1
    dev = bag_a.device
    _check("bag_a", bag_a, torch.int32, (s, n, g, WORDS), dev)
    _check("filled_a", filled_a, torch.bool, (s, n, g), dev)
    _check("bag_b", bag_b, torch.int32, (s, m, g, WORDS), dev)
    _check("filled_b", filled_b, torch.bool, (s, m, g), dev)
    for name, x in (("bag_a", bag_a), ("bag_b", bag_b)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    _rows(s, n, m, MAX_N_CROSSBAG)
    return s, n, m, g


def check_matrix_args(a, b):
    """Raise unless K4's dense pass takes these: on one device, int32 words
    a [S, N, 8] and b [S, M, 8], contiguous and 8-byte aligned (a lane reads
    two words at once).  Returns (S, N, M)."""
    if not isinstance(a, torch.Tensor) or a.dim() != 3:
        raise ValueError("a must be a [S, N, 8] tensor")
    s, n, _ = a.shape
    m = b.shape[1] if isinstance(b, torch.Tensor) and b.dim() == 3 else -1
    _check("a", a, torch.int32, (s, n, WORDS), a.device)
    _check("b", b, torch.int32, (s, m, WORDS), a.device)
    for name, x in (("a", a), ("b", b)):
        if x.data_ptr() % 8:
            raise ValueError(f"{name} must start on an 8-byte boundary")
    _rows(s, n, m, MAX_N_MATRIX)
    return s, n, m


def check_best_two_args(a, b, row_ok, col_ok):
    """Raise unless K4's best two takes these: ``check_matrix_args``' a and
    b with M >= 1, and bool row_ok [S, N] and col_ok [S, M], contiguous, on
    the same device.  Returns (S, N, M)."""
    s, n, m = check_matrix_args(a, b)
    if m < 1:
        raise ValueError("the best two needs at least one column (M >= 1)")
    _check("row_ok", row_ok, torch.bool, (s, n), a.device)
    _check("col_ok", col_ok, torch.bool, (s, m), a.device)
    return s, n, m


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"the Hamming kernel runs on CUDA tensors, got {dev}")


def _run(fn, args, dev, what: str) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def launched(out) -> bool:
    """Whether the launch that gave ``out`` ran the kernel (an empty output
    needs none)."""
    return out.numel() > 0


def launch_min_crossbag(bag_a, filled_a, bag_b, filled_b):
    """[S, N, M] float32: per row, the minimum Hamming distance over the
    filled pairs of each A bag and each B bag, 257 where there is none."""
    s, n, m, g = check_min_crossbag_args(bag_a, filled_a, bag_b, filled_b)
    dev = bag_a.device
    _cuda(dev)
    lib = _lib or _load()
    out = torch.empty((s, n, m), dtype=torch.float32, device=dev)
    if launched(out):
        _run(lib.hamming_min_crossbag_launch,
             (bag_a.data_ptr(), filled_a.data_ptr(), bag_b.data_ptr(), filled_b.data_ptr(), s, n,
              m, g, out.data_ptr()), dev, "hamming_min_crossbag")
    return out


_CHUNKS = {}


def _chunks(lib, s: int, n: int, m: int, dev) -> int:
    """The column chunks of the best two's grid (from the card's
    multiprocessors; asked once per shape and device): past one, the
    merge's scratch is needed."""
    key = (s, n, m, dev.index)
    if key not in _CHUNKS:
        c = ctypes.c_int()
        with torch.cuda.device(dev):
            rc = lib.hamming_best_two_chunks(s, n, m, ctypes.byref(c))
        if rc != 0:
            raise RuntimeError(f"hamming_best_two_chunks failed: cudaError_t {rc}")
        _CHUNKS[key] = c.value
    return _CHUNKS[key]


def best_two_kernels(s: int, n: int, m: int, dev) -> int:
    """The kernels that ``launch_best_two`` starts for S rows of N x M: none
    where N is 0, two where its column chunks need the merge, else one."""
    if s * n == 0:
        return 0
    return 1 + (_chunks(_lib or _load(), s, n, m, dev) > 1)


def launch_best_two(a, b, row_ok, col_ok, big: float):
    """(best [S, N] float32, second [S, N] float32, idx [S, N] int64): per
    row s and query n, the least and second least over m of the distance
    a[s, n] to b[s, m] where row_ok[s, n] and col_ok[s, m] (``big``
    elsewhere; the second inf where M is 1), and the first m of the
    least."""
    s, n, m = check_best_two_args(a, b, row_ok, col_ok)
    dev = a.device
    _cuda(dev)
    lib = _lib or _load()
    best = torch.empty((s, n), dtype=torch.float32, device=dev)
    second = torch.empty((s, n), dtype=torch.float32, device=dev)
    idx = torch.empty((s, n), dtype=torch.int64, device=dev)
    if launched(best):
        chunks = _chunks(lib, s, n, m, dev)
        key = sec = None
        if chunks > 1:
            key = torch.empty((s, n, chunks), dtype=torch.int64, device=dev)
            sec = torch.empty((s, n, chunks), dtype=torch.int32, device=dev)
        _run(lib.hamming_best_two_launch,
             (a.data_ptr(), b.data_ptr(), row_ok.data_ptr(), col_ok.data_ptr(), s, n, m,
              float(big), best.data_ptr(), second.data_ptr(), idx.data_ptr(),
              None if key is None else key.data_ptr(), None if sec is None else sec.data_ptr(),
              chunks),
             dev, "hamming_best_two")
    return best, second, idx


def launch_matrix(a, b):
    """[S, N, M] int32: per row, the Hamming distance of every A descriptor
    to every B descriptor (the dense pass's store epilogue)."""
    s, n, m = check_matrix_args(a, b)
    dev = a.device
    _cuda(dev)
    lib = _lib or _load()
    out = torch.empty((s, n, m), dtype=torch.int32, device=dev)
    if launched(out):
        _run(lib.hamming_matrix_launch, (a.data_ptr(), b.data_ptr(), s, n, m, out.data_ptr()),
             dev, "hamming_matrix")
    return out
