"""The KLT kernel: its build, its launch, the plain level pass, and the
one-pass wrapper ``lk_level``.

The CUDA kernel in ``csrc/klt_track.cu`` runs a whole forward-backward
pyramidal ``fb_klt_track`` call (ops/klt.py) in one launch: for each point a
schedule of level passes (``klt_schedule``).  ``lk_level`` is the port of the
JAX package's ``_lk_level`` (alvaar_tpu/ops/klt.py) with its Pallas kernel
``lk_level_pallas`` (alvaar_tpu/ops/pallas/lk_kernel.py): for CUDA tensors it
launches the same kernel with a one-pass schedule and no gates; for CPU
tensors it runs ``lk_level_plain``, a plain torch port of the XLA body.
There is no fallback between the two: a CUDA tensor either launches the
kernel or raises.

The kernel is compiled with ``nvcc`` at first use into ``build/`` at the
repository root (one shared library with a plain C entry point, loaded
with ``ctypes``; utils/build.py), and rebuilt when the source's hash
changes.  Each launch runs under its tensors' device, whichever device is
current in the calling thread.

The plain level pass sums the 81-tap window terms in the kernel's
(sequential) order and takes every other product and sum as its own torch
op, so that the kernel, built with ``--fmad=false``, agrees with it (and
with the composition of it in ops/klt.py) bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from alvaar_tpu_torch.ops.image import gather_patches
from alvaar_tpu_torch.utils.build import build_library, find_tool
from alvaar_tpu_torch.utils.stats import count

SEARCH_R = 8
BACKWARD_R = 2
BACKWARD_ITERS_MAX = 12
MIN_EIG = 1e-4

# what the kernel takes (csrc/klt_track.cu kWinMax, kRMax, kLevelsMax)
WIN_MAX = 15
R_MAX = 12
LEVELS_MAX = 4

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "klt_track.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None
_LOAD_LOCK = threading.Lock()


def build_kernel(verbose: bool = False, src: Path = _SRC) -> Path:
    """Compile ``src`` (the KLT kernel by default) with nvcc into
    ``build/`` unless a library built from the same source and flags is
    already there (utils/build.py).  Returns its path."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc",
                     "the CUDA toolkit is needed to build the KLT kernel")
    return build_library(src, nvcc, _NVCC_FLAGS, verbose=verbose)


def _load():
    """The built library's launch function, after checking that its limits
    are the ones this module checks against (built and opened once, by
    the first thread that asks)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernel()))
            fn = lib.klt_track_launch
            fn.restype = ctypes.c_int
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr, i32, i32, i32, f32, f32,
                           f32, f32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr]
            lim = lib.klt_track_limits
            lim.restype = ctypes.c_int
            lim.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
            got = [ctypes.c_int() for _ in range(3)]
            lim(*(ctypes.byref(v) for v in got))
            if [v.value for v in got] != [WIN_MAX, R_MAX, LEVELS_MAX]:
                raise RuntimeError(f"kernel limits {[v.value for v in got]} differ from "
                                   f"{[WIN_MAX, R_MAX, LEVELS_MAX]}")
            _lib = (lib, fn)   # keep lib alive
    return _lib[1]


# ---------------------------------------------------------------------------
# Plain level pass
# ---------------------------------------------------------------------------

def _seq_sum(x):
    """Sum over the last axis strictly left to right (the kernel's order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _true_div(x, c: float):
    """x / c as one IEEE division, as the kernel divides.  A CUDA tensor
    divided by a Python number is multiplied by the number's float
    reciprocal instead, one rounding more."""
    return x / torch.full_like(x, c)


def _tent(d, size: int):
    """Bilinear ("tent") weights w[n, i] = max(0, 1 - |i - d_n|)."""
    i = torch.arange(size, device=d.device, dtype=d.dtype)
    return torch.clamp_min(1.0 - torch.abs(i[None, :] - d[:, None]), 0.0)


def template_terms(img_prev, pts_prev, win: int, min_eig: float = MIN_EIG):
    """The template half of a level pass: the window T and its gradients
    gx, gy [N, win, win] from the previous image, the five window sums
    (gxx, gxy, gyy, Σ T·gx, Σ T·gy), the structure tensor's determinant and
    the min-eigenvalue gate ``trackable`` [N]."""
    h, w = img_prev.shape
    r = win // 2
    tpl_size = win + 3
    n = pts_prev.shape[0]
    base_t = torch.floor(pts_prev).to(torch.int64)
    base_t = torch.stack([base_t[:, 0].clamp(r + 2, w - r - 4),
                          base_t[:, 1].clamp(r + 2, h - r - 4)], dim=1)
    ft = (pts_prev - base_t.to(pts_prev.dtype)).clamp(0.0, 1.0)
    tp = gather_patches(img_prev, base_t, tpl_size, r + 1)     # [N, 12, 12]
    out = win + 2
    fx = ft[:, 0, None, None]
    fy = ft[:, 1, None, None]
    t11 = (tp[:, :out, :out] * (1 - fy) * (1 - fx)
           + tp[:, :out, 1:out + 1] * (1 - fy) * fx
           + tp[:, 1:out + 1, :out] * fy * (1 - fx)
           + tp[:, 1:out + 1, 1:out + 1] * fy * fx)              # [N, 11, 11]
    T = t11[:, 1:win + 1, 1:win + 1]
    gx = 0.5 * (t11[:, 1:win + 1, 2:win + 2] - t11[:, 1:win + 1, 0:win])
    gy = 0.5 * (t11[:, 2:win + 2, 1:win + 1] - t11[:, 0:win, 1:win + 1])

    flat = lambda a: a.reshape(n, win * win)
    sums = _seq_sum(torch.stack([flat(gx * gx), flat(gx * gy), flat(gy * gy),
                                 flat(T * gx), flat(T * gy)]))
    gxx, gxy, gyy = sums[0], sums[1], sums[2]
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0)))
    trackable = _true_div(eig_min, float(win * win)) > min_eig
    return T, gx, gy, sums, det, trackable


def lk_level_plain(img_prev, img_cur, pts_prev, guess, valid, *, win: int,
                   iters: int, eps: float, search_r: int = SEARCH_R,
                   min_eig: float = MIN_EIG):
    """Plain torch port of the correlation-volume LK level pass
    (alvaar_tpu/ops/klt.py ``_lk_level``, XLA body).  Point-first layout:
    patches are [N, s, s].  Returns (xy [N, 2], ok [N], err [N])."""
    h, w = img_cur.shape
    R = search_r
    cr = 2 * R + 1
    r = win // 2
    j_size = cr + win - 1
    n = pts_prev.shape[0]

    # ---- template window + gradients from the previous image ----
    T, gx, gy, sums, det, trackable = template_terms(img_prev, pts_prev, win, min_eig)
    gxx, gxy, gyy, cx0, cy0 = sums.unbind(0)
    flat = lambda a: a.reshape(n, win * win)
    det_safe = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    i00 = gyy / det_safe
    i01 = -gxy / det_safe
    i11 = gxx / det_safe

    # ---- current-image search patch + correlation volumes ----
    base_j = torch.floor(guess + 0.5).to(torch.int64)
    margin = R + r + 1
    base_j = torch.stack([base_j[:, 0].clamp(margin, w - margin - 1),
                          base_j[:, 1].clamp(margin, h - margin - 1)], dim=1)
    Jp = gather_patches(img_cur, base_j, j_size, margin - 1)    # [N, S, S]

    d0 = guess - base_j.to(guess.dtype)
    lim = R - 1.001
    frozen = ~(valid & trackable)
    dx0 = d0[:, 0].clamp(-lim, lim)
    dy0 = d0[:, 1].clamp(-lim, lim)

    C_gx = torch.zeros((n, cr, cr), dtype=Jp.dtype, device=Jp.device)
    C_gy = torch.zeros_like(C_gx)
    for wy in range(win):
        for wx in range(win):
            js = Jp[:, wy:wy + cr, wx:wx + cr]
            C_gx = C_gx + js * gx[:, wy, wx, None, None]
            C_gy = C_gy + js * gy[:, wy, wx, None, None]

    # ---- Gauss-Newton on the volumes ----
    dx, dy = dx0, dy0
    for _ in range(iters):
        wx = _tent(dx + R, cr)                                 # [N, cr]
        wy = _tent(dy + R, cr)
        tx = torch.sum(wy[:, :, None] * C_gx, dim=1)           # [N, cr]
        ty = torch.sum(wy[:, :, None] * C_gy, dim=1)
        bx = torch.sum(tx * wx, dim=1) - cx0
        by = torch.sum(ty * wx, dim=1) - cy0
        sx = -(i00 * bx + i01 * by)
        sy = -(i01 * bx + i11 * by)
        sx = torch.where(frozen, 0.0, sx)
        sy = torch.where(frozen, 0.0, sy)
        dx = torch.clamp(dx + sx, -lim, lim)
        dy = torch.clamp(dy + sy, -lim, lim)
        frozen = frozen | (sx * sx + sy * sy < eps * eps)

    # ---- final window L1 error (tent reads of the search patch) ----
    offs = torch.arange(win, device=dx.device, dtype=dx.dtype)
    ey = (dy + R)[:, None] + offs[None, :]                     # [N, win]
    ex = (dx + R)[:, None] + offs[None, :]
    iS = torch.arange(j_size, device=dx.device, dtype=dx.dtype)
    wyr = torch.clamp_min(1.0 - torch.abs(iS[None, None, :] - ey[:, :, None]), 0.0)
    wxc = torch.clamp_min(1.0 - torch.abs(iS[None, None, :] - ex[:, :, None]), 0.0)
    # t1[n, ri, s] = Σ_p Jp[n, p, s] wyr[n, ri, p]; w_val[n, ri, ci] = Σ_s t1 wxc
    t1 = torch.sum(Jp[:, None, :, :] * wyr[:, :, :, None], dim=2)   # [N, win, S]
    w_val = torch.sum(t1[:, :, None, :] * wxc[:, None, :, :], dim=3)  # [N, win, win]
    err = _true_div(_seq_sum(flat(torch.abs(w_val - T))), float(win * win))
    at_edge = (torch.abs(dx) >= lim - 1e-3) | (torch.abs(dy) >= lim - 1e-3)

    xy = base_j.to(dx.dtype) + torch.stack([dx, dy], dim=-1)
    rb = float(r + 1)
    inb = ((xy[:, 0] >= rb) & (xy[:, 0] < w - rb)
           & (xy[:, 1] >= rb) & (xy[:, 1] < h - rb))
    started_edge = (torch.abs(dx0) >= lim - 1e-3) | (torch.abs(dy0) >= lim - 1e-3)
    ok = valid & trackable & inb & (~at_edge | started_edge)
    return xy, ok, err


# ---------------------------------------------------------------------------
# The kernel's schedule, checks and launch
# ---------------------------------------------------------------------------

def klt_schedule(levels: int, search_r: int, iters: int,
                 backward: bool = True) -> list[tuple[int, int, int, bool]]:
    """The level passes of one ``fb_klt_track`` call as the kernel runs
    them, (level, radius, iterations, backward) each: forward from the
    coarsest of ``levels`` (radius ``search_r``, ``min(search_r, 4)`` below
    it) to level 0, then the backward pass at level 0."""
    passes = [(lvl, search_r if lvl == levels - 1 else min(search_r, 4), iters, False)
              for lvl in range(levels - 1, -1, -1)]
    if backward:
        passes.append((0, BACKWARD_R, min(iters, BACKWARD_ITERS_MAX), True))
    return passes


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_track_args(pyr_prev, pyr_cur, pts, prior, valid, schedule, win: int) -> int:
    """Raise unless the kernel takes these inputs: float32 contiguous
    levels of equal shapes on the points' device, either [H, W] (one
    stream) or [B, H, W] (B streams, the same B at every level), [N, 2]
    float32 points and priors grouped by stream (N % B == 0), a [N] bool
    mask, and a schedule within the kernel's limits on levels big enough
    for its window and radii.  Returns B."""
    dev = pts.device
    n = pts.shape[0]
    levels = schedule[0][0] + 1
    if not 1 <= levels <= LEVELS_MAX:
        raise ValueError(f"the kernel takes 1 to {LEVELS_MAX} levels, got {levels}")
    if min(len(pyr_prev), len(pyr_cur)) < levels:
        raise ValueError(f"{levels} levels asked of pyramids with "
                         f"{len(pyr_prev)} and {len(pyr_cur)}")
    if not (3 <= win <= WIN_MAX and win % 2 == 1):
        raise ValueError(f"the kernel takes an odd win from 3 to {WIN_MAX}, got {win}")
    ndim = pyr_cur[0].dim()
    streams = pyr_cur[0].shape[0] if ndim == 3 else 1
    for lvl in range(levels):
        shape = tuple(pyr_cur[lvl].shape)
        if ndim not in (2, 3) or len(shape) != ndim or (ndim == 3 and shape[0] != streams):
            raise ValueError(f"level {lvl} has shape {shape}, expected [H, W], or "
                             f"[B, H, W] with level 0's B")
        _check(f"pyr_prev[{lvl}]", pyr_prev[lvl], torch.float32, shape, dev)
        _check(f"pyr_cur[{lvl}]", pyr_cur[lvl], torch.float32, shape, dev)
    if n % streams != 0:
        raise ValueError(f"{n} points do not split evenly over {streams} streams")
    _check("pts", pts, torch.float32, (n, 2), dev)
    _check("prior", prior, torch.float32, (n, 2), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    r = win // 2
    for lvl, radius, _, _ in schedule:
        if not 1 <= radius <= R_MAX:
            raise ValueError(f"the kernel takes radii 1 to {R_MAX}, got {radius}")
        h, w = pyr_cur[lvl].shape[-2:]
        if min(h, w) < max(2 * r + 6, 2 * (radius + r + 1) + 1):
            raise ValueError(f"level {lvl} ({h}x{w}) too small for win {win}, R {radius}")
    return streams


def launch_klt_track(pyr_prev, pyr_cur, pts, prior, valid, schedule, *, gated: bool,
                     win: int, eps: float, err_max: float = 0.0, fb_dist: float = 0.0,
                     min_eig: float = MIN_EIG):
    """Launch the kernel on CUDA tensors for ``schedule``
    (``klt_schedule``) over one stream ([H, W] levels) or B streams ([B, H,
    W] levels, points grouped by stream); returns (xy [N, 2], status [N],
    err [N])."""
    if pts.device.type != "cuda":
        raise ValueError(f"the KLT kernel runs on CUDA tensors, got {pts.device}")
    streams = check_track_args(pyr_prev, pyr_cur, pts, prior, valid, schedule, win)
    fn = _load()
    dev, n = pts.device, pts.shape[0]
    levels = schedule[0][0] + 1
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    status = torch.empty((n,), dtype=torch.bool, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * LEVELS_MAX)(*[t.data_ptr() for t in ts[:levels]])
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    flat = [int(v) for ps in schedule for v in ps]
    hw = [t.shape[-2:] for t in pyr_cur[:levels]]
    # the kernel's attribute call and launch act on the calling thread's
    # current device: make it the tensors' own
    with torch.cuda.device(dev):
        rc = fn(ptrs(pyr_prev), ptrs(pyr_cur),
                (ctypes.c_longlong * LEVELS_MAX)(*[h * w for h, w in hw]),
                ints([h for h, _ in hw]), ints([w for _, w in hw]), levels,
                max(1, n // streams), ints(flat),
                len(schedule), int(gated), win, float(eps * eps), float(min_eig),
                float(err_max), float(fb_dist), pts.data_ptr(), prior.data_ptr(),
                valid.data_ptr(), n, xy.data_ptr(), status.data_ptr(), err.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"KLT kernel launch failed: cudaError_t {rc}")
    return xy, status, err


def lk_level(img_prev, img_cur, pts_prev, guess, valid, *, win: int,
             iters: int, eps: float, search_r: int = SEARCH_R,
             min_eig: float = MIN_EIG):
    """One LK level pass for all points, dispatched on the tensors' device:
    the kernel with a one-pass schedule and no gates for CUDA tensors,
    ``lk_level_plain`` for CPU tensors.

    img_prev/img_cur: float32 [H, W] (one pyramid level); pts_prev, guess:
    float32 [N, 2] in this level's pixels; valid: bool [N].
    Returns (xy [N, 2], ok [N] bool, err [N])."""
    dev = img_cur.device
    if dev.type == "cpu":
        return lk_level_plain(img_prev, img_cur, pts_prev, guess, valid,
                              win=win, iters=iters, eps=eps,
                              search_r=search_r, min_eig=min_eig)
    if dev.type != "cuda":
        raise ValueError(f"lk_level runs on CPU or CUDA tensors, got {dev}")
    out = launch_klt_track([img_prev], [img_cur], pts_prev, guess, valid,
                           [(0, search_r, iters, False)], gated=False, win=win,
                           eps=eps, min_eig=min_eig)
    count(lk_level, "launches")
    return out


lk_level.launches = 0
