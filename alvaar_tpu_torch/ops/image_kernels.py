"""The image kernels K7, K5, K3 and K8 (csrc/image_kernels.cu): their
build, argument checks and launches.

``launch_gray`` converts an RGB(A) frame or a stack of them to float32
gray, ``launch_pyramid`` builds the levels of a pyramid below level 0 in
one launch per two levels (so a 3-level pyramid in one) and
``launch_pyr_down`` takes one level down (K7); ``launch_detect`` runs the
whole grid Shi-Tomasi detection in two launches (K5); ``launch_describe``
computes the ORB descriptors of every keypoint in one launch (K3);
``launch_clahe`` equalizes an image or a stack of them in two launches
(K8: the tiles' lookup tables, then every pixel).  K5
and K3 take S rows, so one call serves every row that ``torch.func.vmap``
batches (``ops/detect.py`` and
``ops/orb.py`` register the custom ops and their batching rule).  The
plain versions and the wrappers that dispatch on the device are in
``ops/image.py``, ``ops/detect.py`` and ``ops/orb.py``; this module only
launches, on CUDA tensors.

The library is compiled with ``nvcc`` at first use into ``build/`` at the
repository root (one shared library with plain C entry points, loaded with
``ctypes``; utils/build.py), and rebuilt when the source's hash changes.
The launch runs on its tensors' device and that device's current stream
(entering ``torch.cuda.device`` only when that is not the current device).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from alvaar_tpu_torch.utils.build import build_library, find_tool
from alvaar_tpu_torch.utils.custom_ops import raw_stream

# csrc/image_kernels.cu's limits (``bind`` checks that the library has these)
MAX_ROWS = 65535               # S of K5 and K3: their grid.y
PATCH = 36                     # ORB's patch: K3 needs images of at least PATCH x PATCH
BITS = 256                     # descriptor bits
ANGLE_BINS = 30
SCRATCH_F = 6                  # K5's scratch per row: float32s and int32s per grid cell
SCRATCH_I = 3
DETECT_LAUNCHES = 2            # K5's kernels per call: the cells, the ranks
CLAHE_LAUNCHES = 2             # K8's kernels per call: the tables, the pixels
MAX_TILES = 256                # K8's tiles a side at most
LEVELS_PER_LAUNCH = 2          # K7's pyramid levels per launch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "image_kernels.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
_LOAD_LOCK = threading.Lock()


def build_kernel(verbose: bool = False) -> Path:
    """Compile csrc/image_kernels.cu with nvcc into ``build/`` unless a
    library built from the same source and flags is already there.
    Returns its path."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA toolkit is needed to build the image kernels")
    return build_library(_SRC, nvcc, _NVCC_FLAGS, verbose=verbose)


def bind(lib):
    """Declare the library's C entry points on the ``ctypes`` handle ``lib``
    and check its limits and K5's scratch sizes against this module's.
    Returns ``lib``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.image_gray_launch.restype = i32
    lib.image_gray_launch.argtypes = [ptr, i32, i32, i64, ptr, ptr]
    lib.image_pyramid_launch.restype = i32
    lib.image_pyramid_launch.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.detect_tile_floats.restype = i64
    lib.detect_tile_floats.argtypes = [i32] * 3
    lib.detect_grid_launch.restype = i32
    lib.detect_grid_launch.argtypes = ([ptr] * 4 + [ctypes.c_float] + [i32] * 6 + [ptr] * 9)
    lib.describe_launch.restype = i32
    lib.describe_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 3
    lib.image_clahe_launch.restype = i32
    lib.image_clahe_launch.argtypes = [ptr] + [i32] * 4 + [ctypes.c_float] + [ptr] * 3
    lim = lib.image_kernel_limits
    lim.restype = i32
    lim.argtypes = [ctypes.POINTER(i32)] * 7
    want = dict(max_rows=MAX_ROWS, patch=PATCH, bits=BITS, angle_bins=ANGLE_BINS,
                scratch_f=SCRATCH_F, scratch_i=SCRATCH_I, max_tiles=MAX_TILES)
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


def _stack(name, x, min_hw: int):
    """(S, H, W) of a float32 [S, H, W] stack."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError(f"{name} must be a [S, H, W] tensor")
    s, h, w = x.shape
    _check(name, x, torch.float32, (s, h, w), x.device)
    if not 1 <= s <= MAX_ROWS or h < min_hw or w < min_hw:
        raise ValueError(f"the kernel takes 1 <= S <= {MAX_ROWS} rows of at least {min_hw} x "
                         f"{min_hw} pixels, got {tuple(x.shape)}")
    return s, h, w


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"the image kernels run on CUDA tensors, got {dev}")


def _run(fn, args, dev, what: str) -> None:
    if dev.index is None or dev.index == torch._C._cuda_getDevice():   # CUDA is initialised
        rc = fn(*args, raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def check_gray_args(frame):
    """Raise unless K7's gray conversion takes ``frame``: u8 or float32
    [..., H, W, 3 or 4], contiguous.  Returns the number of pixels."""
    if not isinstance(frame, torch.Tensor) or frame.dim() < 3 or frame.shape[-1] not in (3, 4):
        raise ValueError("frame must be a [..., H, W, 3 or 4] tensor")
    if frame.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frame has dtype {frame.dtype}, expected uint8 or float32")
    _check("frame", frame, frame.dtype, tuple(frame.shape), frame.device)
    return frame.numel() // frame.shape[-1]


def launch_gray(frame):
    """[..., H, W] float32 luma of a u8 or float32 [..., H, W, 3 or 4]
    frame (BT.601, the plain version's order of operations)."""
    pixels = check_gray_args(frame)
    dev = frame.device
    _cuda(dev)
    lib = _lib or _load()
    out = torch.empty(frame.shape[:-1], dtype=torch.float32, device=dev)
    if pixels:
        _run(lib.image_gray_launch, (frame.data_ptr(), int(frame.dtype == torch.float32),
                                     frame.shape[-1], pixels, out.data_ptr()), dev, "rgba_to_gray")
    return out


@functools.lru_cache(maxsize=64)
def _pyramid_plan(shape, levels: int):
    """For an image of ``shape`` ([H, W] or [B, H, W]): (the floats of
    levels 1 on, each level's (shape, strides, offset) in that buffer, each
    launch's (B, H, W of its source level, source level, levels written))."""
    h, w = shape[-2:]
    b = shape[0] if len(shape) == 3 else 1
    if h < 1 or w < 1 or b >= 2 ** 31 or levels < 1:
        raise ValueError(f"img has shape {tuple(shape)}, levels {levels}")
    sizes = [(h, w)]
    for _ in range(levels - 1):             # each level ceil(half) of the one before
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    views, o = [], 0
    for y, x in sizes[1:]:
        views.append((shape[:-2] + (y, x), ((y * x,) if len(shape) == 3 else ()) + (x, 1), o))
        o += b * y * x
    launches = tuple((b, *sizes[k], k, min(LEVELS_PER_LAUNCH, levels - 1 - k))
                     for k in range(0, levels - 1, LEVELS_PER_LAUNCH))
    return o, tuple(views), launches if o else ()


def launch_pyramid(img, levels: int):
    """The ``levels``-level pyramid of float32 [H, W] or [B, H, W]
    (contiguous): (img, level 1, ...), the binomial blur at each level's
    even rows and columns.  Levels 1 on are contiguous views of one buffer,
    written by ceil((levels - 1) / 2) launches of two levels (the last of
    one).  Returns (the levels, the launches)."""
    if not isinstance(img, torch.Tensor) or img.dim() not in (2, 3):
        raise ValueError("img must be a [H, W] or [B, H, W] tensor")
    if img.dtype is not torch.float32:
        raise TypeError(f"img has dtype {img.dtype}, expected torch.float32")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    dev = img.device
    _cuda(dev)
    total, views, launches = _pyramid_plan(img.shape, levels)
    lib = _lib or _load()
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    pyr = (img,) + tuple(buf.as_strided(*v) for v in views)
    base = buf.data_ptr()
    for b, h, w, k, n in launches:
        src = img.data_ptr() if k == 0 else base + 4 * views[k - 1][2]
        _run(lib.image_pyramid_launch,
             (src, b, h, w, n, base + 4 * views[k][2],
              base + 4 * views[k + 1][2] if n == 2 else None), dev, "build_pyramid")
    return pyr, len(launches)


def launch_pyr_down(img):
    """One pyramid level down of float32 [H, W] or [B, H, W] (contiguous):
    [..., ceil(H / 2), ceil(W / 2)] in one launch of ``launch_pyramid``."""
    return launch_pyramid(img, 2)[0][1]


def num_cells(h: int, w: int, cell: int) -> int:
    """The grid's cells: ceil(H / cell) ceil(W / cell)."""
    return -(-h // cell) * -(-w // cell)


def check_detect_args(img, existing_xy, existing_valid, quality, cell, border):
    """Raise unless K5 takes these: on one device, float32 img [S, H, W] (H,
    W >= 3), existing_xy [S, K, 2] float32 and existing_valid [S, K] bool,
    quality a float32 [S] tensor or a number, an int 1 <= cell <= 46340
    and an int border, all contiguous.  Returns (S, H, W, K, C)."""
    s, h, w = _stack("img", img, 3)
    dev = img.device
    k = existing_xy.shape[1] if isinstance(existing_xy, torch.Tensor) and existing_xy.dim() == 3 \
        else -1
    _check("existing_xy", existing_xy, torch.float32, (s, k, 2), dev)
    _check("existing_valid", existing_valid, torch.bool, (s, k), dev)
    if isinstance(quality, torch.Tensor):
        _check("quality", quality, torch.float32, (s,), dev)
    elif not isinstance(quality, (int, float)):
        raise TypeError(f"quality is a {type(quality).__name__}, expected a tensor or a number")
    for name, v in (("cell", cell), ("border", border)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"{name} must be an int, got {v!r}")
    if not 1 <= cell <= 46340:
        raise ValueError(f"the kernel takes 1 <= cell <= 46340, got {cell}")
    c = num_cells(h, w, cell)
    if c > 2 ** 24:
        raise ValueError(f"{c} cells; the kernel takes at most 2^24")
    return s, h, w, k, c


@functools.lru_cache(maxsize=64)
def _tile_floats(lib, h: int, w: int, cell: int) -> int:
    return lib.detect_tile_floats(h, w, cell)


def launch_detect(img, existing_xy, existing_valid, quality, cell: int, border: int):
    """``detect_grid`` on S rows in two launches.  Returns (xy [S, C, 2]
    float32, score [S, C] float32, valid [S, C] bool, new_quality [S]
    float32, resp [S, H, W] float32: the Shi-Tomasi response)."""
    s, h, w, k, c = check_detect_args(img, existing_xy, existing_valid, quality, cell, border)
    dev = img.device
    _cuda(dev)
    lib = _lib or _load()
    f32 = dict(dtype=torch.float32, device=dev)
    tf = _tile_floats(lib, h, w, cell)      # the response tiles that shared memory cannot hold
    tiles = torch.empty((s, c * tf), **f32) if tf else None
    resp = torch.empty((s, h, w), **f32)
    wsf = torch.empty((s, SCRATCH_F * c), **f32)
    wsi = torch.empty((s, SCRATCH_I * c), dtype=torch.int32, device=dev)
    xy = torch.empty((s, c, 2), **f32)
    score = torch.empty((s, c), **f32)
    valid = torch.empty((s, c), dtype=torch.bool, device=dev)
    new_quality = torch.empty((s,), **f32)
    q_ptr, q_val = ((quality.data_ptr(), 0.0) if isinstance(quality, torch.Tensor)
                    else (None, float(quality)))
    _run(lib.detect_grid_launch,
         (img.data_ptr(), existing_xy.data_ptr(), existing_valid.data_ptr(), q_ptr, q_val, s, h,
          w, k, cell, border, tiles.data_ptr() if tiles is not None else None, resp.data_ptr(),
          wsf.data_ptr(), wsi.data_ptr(),
          xy.data_ptr(), score.data_ptr(), valid.data_ptr(), new_quality.data_ptr()), dev,
         "detect_grid")
    return xy, score, valid, new_quality, resp


def check_describe_args(img, xy, valid, taps):
    """Raise unless K3 takes these: on one device, float32 img [S, H, W] (H,
    W >= 36), xy [S, N, 2] float32, valid [S, N] bool and the int32
    steering table taps [30, 256] (each pair's flat patch indices as i0 |
    i1 << 16), all contiguous.  Returns (S, H, W,
    N)."""
    s, h, w = _stack("img", img, PATCH)
    dev = img.device
    n = xy.shape[1] if isinstance(xy, torch.Tensor) and xy.dim() == 3 else -1
    _check("xy", xy, torch.float32, (s, n, 2), dev)
    _check("valid", valid, torch.bool, (s, n), dev)
    _check("taps", taps, torch.int32, (ANGLE_BINS, BITS), dev)
    if n >= 2 ** 31:
        raise ValueError(f"the kernel takes N < 2^31 keypoints, got {n}")
    return s, h, w, n


def launch_describe(img, xy, valid, taps, blur: bool = True):
    """ORB descriptors of S rows of N keypoints in one launch: (desc [S, N,
    8] int32, zeros where invalid; angle [S, N] float32)."""
    s, h, w, n = check_describe_args(img, xy, valid, taps)
    dev = img.device
    _cuda(dev)
    lib = _lib or _load()
    desc = torch.empty((s, n, BITS // 32), dtype=torch.int32, device=dev)
    angle = torch.empty((s, n), dtype=torch.float32, device=dev)
    if n:
        _run(lib.describe_launch,
             (img.data_ptr(), xy.data_ptr(), valid.data_ptr(), taps.data_ptr(), s, h, w, n,
              int(bool(blur)), desc.data_ptr(), angle.data_ptr()), dev, "describe")
    return desc, angle


def check_clahe_args(img, clip, tiles):
    """Raise unless K8 takes these: float32 [H, W] or [B, H, W] (1 <= B <=
    65535), contiguous, H and W positive multiples of ``tiles``, 1 <=
    tiles <= MAX_TILES, a finite ``clip``.  Returns (B, H, W)."""
    if not isinstance(img, torch.Tensor) or img.dim() not in (2, 3):
        raise ValueError("img must be a [H, W] or [B, H, W] tensor")
    if not isinstance(tiles, int) or isinstance(tiles, bool) or not 1 <= tiles <= MAX_TILES:
        raise ValueError(f"the kernel takes an int 1 <= tiles <= {MAX_TILES}, got {tiles!r}")
    _check("img", img, torch.float32, tuple(img.shape), img.device)
    b = img.shape[0] if img.dim() == 3 else 1
    h, w = img.shape[-2:]
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1 <= B <= {MAX_ROWS} images, got {b}")
    if h < tiles or w < tiles or h % tiles or w % tiles or h * w >= 2 ** 31:
        raise ValueError(f"the kernel needs H and W divisible by tiles = {tiles} (H W < 2^31), "
                         f"got {h} x {w}")
    if not isinstance(clip, (int, float)) or isinstance(clip, bool) or clip != clip \
            or abs(clip) == float("inf"):
        raise ValueError(f"clip must be a finite number, got {clip!r}")
    return b, h, w


def launch_clahe(img, clip: float = 3.0, tiles: int = 8):
    """CLAHE of float32 [H, W] or [B, H, W] (contiguous) in two launches,
    whatever B: the tables [B, tiles * tiles, 256] float32 (a block per
    tile and image), then every pixel from its four nearest tiles' tables.
    Returns (the equalized images, the tables)."""
    b, h, w = check_clahe_args(img, clip, tiles)
    dev = img.device
    _cuda(dev)
    lib = _lib or _load()
    out = torch.empty_like(img)
    lut = torch.empty((b, tiles * tiles, 256), dtype=torch.float32, device=dev)
    # the histogram's clip in float64 as the plain version computes it; the
    # kernel takes it rounded to float32, as the plain version's float32
    # ``hist - clip_limit`` does
    clip_limit = max(clip * ((h // tiles) * (w // tiles)) / 256.0, 1.0)
    _run(lib.image_clahe_launch, (img.data_ptr(), b, h, w, tiles, clip_limit, lut.data_ptr(),
                                  out.data_ptr()), dev, "clahe")
    return out, lut
