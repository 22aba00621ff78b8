"""One KLT pyramid-level pass: the CUDA kernel, its plain twin, and the
dispatching wrapper.

``lk_level`` is the port of the JAX package's ``_lk_level``
(alvaar_tpu/ops/klt.py) with its Pallas kernel ``lk_level_pallas``
(alvaar_tpu/ops/pallas/lk_kernel.py).  For CUDA tensors it launches the
hand-written kernel in ``csrc/lk_level.cu``; for CPU tensors it runs
``lk_level_plain``, a plain torch port of the XLA body.  There is no
fallback between the two: a CUDA tensor either launches the kernel or
raises.

The kernel is compiled with ``nvcc`` at first use into ``build/`` at the
repository root (one shared library with a plain C entry point, loaded
with ``ctypes``), and rebuilt when the source's hash changes.

The plain twin sums the 81-tap window terms in the kernel's (sequential)
order and takes every other product and sum as its own torch op, so that
the kernel, built with ``--fmad=false``, agrees with it bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from alvaar_tpu_torch.ops.image import gather_patches

SEARCH_R = 8
BACKWARD_R = 2

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "lk_level.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the KLT kernel")
    return path


def build_kernel(verbose: bool = False) -> Path:
    """Compile ``csrc/lk_level.cu`` into ``build/`` unless a library built
    from the same source and flags is already there.  Returns its path."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"liblk_level_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def _load():
    """The built library's launch function and its (win, R) limits."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        fn = lib.lk_level_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        lim = lib.lk_level_limits
        lim.restype = ctypes.c_int
        lim.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        win_max, r_max = ctypes.c_int(), ctypes.c_int()
        lim(ctypes.byref(win_max), ctypes.byref(r_max))
        _lib = (lib, fn, win_max.value, r_max.value)   # keep lib alive
    return _lib[1:]


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------

def _seq_sum(x):
    """Sum over the last axis strictly left to right (the kernel's order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _tent(d, size: int):
    """Bilinear ("tent") weights w[n, i] = max(0, 1 - |i - d_n|)."""
    i = torch.arange(size, device=d.device, dtype=d.dtype)
    return torch.clamp_min(1.0 - torch.abs(i[None, :] - d[:, None]), 0.0)


def lk_level_plain(img_prev, img_cur, pts_prev, guess, valid, *, win: int,
                   iters: int, eps: float, search_r: int = SEARCH_R,
                   min_eig: float = 1e-4):
    """Plain torch port of the correlation-volume LK level pass
    (alvaar_tpu/ops/klt.py ``_lk_level``, XLA body).  Point-first layout:
    patches are [N, s, s].  Returns (xy [N, 2], ok [N], err [N])."""
    h, w = img_cur.shape
    R = search_r
    cr = 2 * R + 1
    r = win // 2
    tpl_size = win + 3
    j_size = cr + win - 1
    n = pts_prev.shape[0]

    # ---- template window + gradients from the previous image ----
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
    gxx, gxy, gyy, cx0, cy0 = sums.unbind(0)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0)))
    trackable = eig_min / float(win * win) > min_eig
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
    err = _seq_sum(flat(torch.abs(w_val - T))) / float(win * win)
    at_edge = (torch.abs(dx) >= lim - 1e-3) | (torch.abs(dy) >= lim - 1e-3)

    xy = base_j.to(dx.dtype) + torch.stack([dx, dy], dim=-1)
    rb = float(r + 1)
    inb = ((xy[:, 0] >= rb) & (xy[:, 0] < w - rb)
           & (xy[:, 1] >= rb) & (xy[:, 1] < h - rb))
    started_edge = (torch.abs(dx0) >= lim - 1e-3) | (torch.abs(dy0) >= lim - 1e-3)
    ok = valid & trackable & inb & (~at_edge | started_edge)
    return xy, ok, err


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lk_level(img_prev, img_cur, pts_prev, guess, valid, *, win: int,
             iters: int, eps: float, search_r: int = SEARCH_R,
             min_eig: float = 1e-4):
    """One LK level pass for all points, dispatched on the tensors' device:
    the CUDA kernel for CUDA tensors, ``lk_level_plain`` for CPU tensors.

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

    h, w = img_cur.shape
    n = pts_prev.shape[0]
    _check("img_prev", img_prev, torch.float32, (h, w), dev)
    _check("img_cur", img_cur, torch.float32, (h, w), dev)
    _check("pts_prev", pts_prev, torch.float32, (n, 2), dev)
    _check("guess", guess, torch.float32, (n, 2), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    launch, win_max, r_max = _load()
    if not (1 <= win <= win_max and 1 <= search_r <= r_max):
        raise ValueError(f"kernel takes win <= {win_max} and "
                         f"search_r <= {r_max}, got {win}, {search_r}")
    r = win // 2
    margin = search_r + r + 1
    if min(h, w) < max(2 * r + 6, 2 * margin + 1):
        raise ValueError(f"level {h}x{w} too small for win {win}, R {search_r}")

    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return xy, ok, err
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = launch(
        img_prev.data_ptr(), img_cur.data_ptr(), h, w, pts_prev.data_ptr(),
        guess.data_ptr(), valid.data_ptr(), n, win, search_r, iters,
        float(eps * eps), float(min_eig), xy.data_ptr(), ok.data_ptr(),
        err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lk_level kernel launch failed: cudaError_t {rc}")
    lk_level.launches += 1
    return xy, ok, err


lk_level.launches = 0
