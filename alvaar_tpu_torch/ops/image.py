"""Image preprocessing ops: grayscale, separable stencils, pyramid, CLAHE,
patches.

Port of alvaar_tpu/ops/image.py.  Images are float32 ``[H, W]`` in the
0..255 range.  The stencils are shift-adds in the same tap order as the
JAX package's ``_sep_conv``, not cuDNN convolutions (which would run in
TF32 on the card by default).  Patch extraction is a direct gather: the
JAX package's one-hot matmul is exact, so the gather returns the same
values.  CLAHE counts its per-tile histograms with ``scatter_add_``
where the JAX package sums a one-hot tensor; the counts are exact
integers either way, and its CDF takes the prefix in float64 (as a CPU
torch's float32 ``cumsum`` does inside), so that the card's plain version
rounds as the kernel does.

``rgba_to_gray``, ``build_pyramid``, ``pyr_down`` and ``clahe`` dispatch
on the device: CUDA tensors launch K7 and K8 (csrc/image_kernels.cu,
ops/image_kernels.py) straight from the wrapper, one launch per
conversion, per 3-level pyramid (per two levels below level 0) and per
``pyr_down``, two per ``clahe`` call on one image or a stack, bit-equal
to the plain versions; CPU tensors run the plain versions; any other
device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from alvaar_tpu_torch.ops import image_kernels
from alvaar_tpu_torch.utils.custom_ops import dispatch as _dispatch
from alvaar_tpu_torch.utils.stats import count


def _rgba_to_gray_plain(frame):
    f = frame.to(torch.float32)
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


def rgba_to_gray(frame):
    """[..., H, W, 4] (or [..., H, W, 3]) → [..., H, W] float32 luma
    (BT.601): K7's gray kernel in one launch on CUDA tensors (u8 and
    float32 as they are, other dtypes converted to float32 first), the
    plain version on CPU tensors."""
    if not _dispatch(frame, "rgba_to_gray"):
        return _rgba_to_gray_plain(frame)
    if frame.dtype not in (torch.uint8, torch.float32):
        frame = frame.to(torch.float32)
    out = image_kernels.launch_gray(frame.contiguous())
    if out.numel():
        count(rgba_to_gray, "launches")
    return out


def _edge_index(n: int, r: int, device):
    return torch.arange(-r, n + r, device=device).clamp_(0, n - 1)


def _sep_conv(img, kernel_1d):
    """Separable 2D convolution with edge padding over the last two axes of
    [..., H, W] float32 — one shifted multiply-add per tap, rows first,
    then columns."""
    k = [float(v) for v in kernel_1d]
    r = len(k) // 2
    h, w = img.shape[-2:]
    xp = img.index_select(-2, _edge_index(h, r, img.device))
    x = sum(kk * xp[..., i:i + h, :] for i, kk in enumerate(k))
    xp = x.index_select(-1, _edge_index(w, r, img.device))
    return sum(kk * xp[..., i:i + w] for i, kk in enumerate(k))


def gaussian_blur3(img):
    """3x3 Gaussian, the detector's pre-blur."""
    return _sep_conv(img, [0.25, 0.5, 0.25])


def _pyr_down_plain(img):
    blurred = _sep_conv(img, [0.0625, 0.25, 0.375, 0.25, 0.0625])
    return blurred[..., ::2, ::2].contiguous()   # the KLT kernel reads it densely


def pyr_down(img):
    """5-tap binomial blur [1, 4, 6, 4, 1] / 16 + 2x decimation of float32
    [H, W] or [B, H, W]: K7's pyramid kernel in one launch on CUDA tensors,
    the plain version on CPU tensors.  The result is contiguous."""
    if not _dispatch(img, "pyr_down"):
        return _pyr_down_plain(img)
    out = image_kernels.launch_pyr_down(img.contiguous())
    if out.numel():
        count(pyr_down, "launches")
    return out


def build_pyramid(img, levels: int) -> Tuple[torch.Tensor, ...]:
    """Image pyramid of float32 [H, W] or a stack [B, H, W], level 0 = full
    resolution: on CUDA tensors K7's pyramid kernel, one launch per two
    levels below level 0 (levels 1 on contiguous views of one buffer), on
    CPU tensors ``pyr_down``'s plain version level by level."""
    if levels > 1 and _dispatch(img, "build_pyramid"):
        pyr, launches = image_kernels.launch_pyramid(
            img if img.is_contiguous() else img.contiguous(), levels)
        count(build_pyramid, "calls", launches=launches)
        return pyr
    count(build_pyramid, "calls")
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_pyr_down_plain(pyr[-1]))
    return tuple(pyr)


rgba_to_gray.launches = 0
pyr_down.launches = 0
build_pyramid.calls = build_pyramid.launches = 0


def sobel_gradients(img):
    """3x3 Sobel dx, dy with edge padding: the [-1, 0, 1] central
    difference first, then the [1, 2, 1] smoothing across it.  Taking the
    difference first keeps the rounding at the scale of the gradient
    rather than of the intensities (well under the JAX package's own
    convolution rounding)."""
    h, w = img.shape
    xp = img.index_select(0, _edge_index(h, 1, img.device))
    xp = xp.index_select(1, _edge_index(w, 1, img.device))       # [h+2, w+2]
    d = xp[:, 2:w + 2] - xp[:, 0:w]                              # [h+2, w]
    dx = d[0:h] + 2.0 * d[1:h + 1] + d[2:h + 2]
    e = xp[2:h + 2] - xp[0:h]                                    # [h, w+2]
    dy = e[:, 0:w] + 2.0 * e[:, 1:w + 1] + e[:, 2:w + 2]
    return dx, dy


def _check_clahe_shape(shape, tiles: int):
    """Raise unless CLAHE takes an image of ``shape`` ([H, W] or [B, H,
    W]) with ``tiles`` x ``tiles`` tiles: H and W positive multiples of
    ``tiles``.  Nothing is padded."""
    if not isinstance(tiles, int) or isinstance(tiles, bool) or tiles < 1:
        raise ValueError(f"tiles must be a positive int, got {tiles!r}")
    if len(shape) not in (2, 3):
        raise ValueError(f"clahe takes [H, W] or [B, H, W], got shape {tuple(shape)}")
    h, w = shape[-2:]
    if h < tiles or w < tiles or h % tiles or w % tiles:
        raise ValueError(f"clahe needs H and W divisible by tiles = {tiles}, got {h} x {w}")


def _clahe_luts_plain(img, clip: float = 3.0, tiles: int = 8):
    """The per-tile lookup tables of float32 [..., H, W]: [..., tiles *
    tiles, 256] float32, tile ty * tiles + tx.  Each tile's 256-bin
    histogram of its rounded pixels, clipped at max(clip th tw / 256, 1)
    with the excess spread over every bin, its CDF (the prefix in float64,
    rounded once) normalised to 0..255."""
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    th, tw = h // tiles, w // tiles
    x = img.reshape(*lead, tiles, th, tiles, tw).transpose(-3, -2)
    x = x.reshape(*lead, tiles * tiles, th * tw)
    q = torch.clamp(torch.round(x), 0, 255).to(torch.int64)          # [..., T, P]
    hist = torch.zeros(*lead, tiles * tiles, 256, dtype=torch.float32, device=img.device)
    hist.scatter_add_(-1, q, torch.ones_like(x, dtype=torch.float32))

    clip_limit = max(clip * (th * tw) / 256.0, 1.0)
    excess = torch.clamp_min(hist - clip_limit, 0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp_max(hist, clip_limit) + excess / 256.0
    cdf = torch.cumsum(hist.double(), dim=-1).float()
    return (cdf - cdf[..., :1]) / (cdf[..., -1:] - cdf[..., :1]).clamp_min(1.0) * 255.0


def _clahe_apply_plain(img, lut, tiles: int = 8):
    """Each pixel of float32 [..., H, W] through the four nearest tiles'
    tables ``lut`` [..., tiles * tiles, 256] at its rounded value, blended
    bilinearly between the tiles' centres."""
    h, w = img.shape[-2:]
    th, tw = h // tiles, w // tiles
    dev = img.device
    # the tile sides as tensors on the device: on CUDA torch divides by a
    # Python number as a product with its float32 reciprocal, which rounds
    # otherwise than the division the CPU (and the kernel) takes
    side = torch.tensor([float(th), float(tw)], device=dev)
    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / side[0] - 0.5
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / side[1] - 0.5
    y0 = torch.clamp(torch.floor(yy), 0, tiles - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xx), 0, tiles - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    qimg = torch.clamp(torch.round(img), 0, 255).to(torch.int64)
    flat = lut.reshape(*lut.shape[:-2], -1)                          # [..., T 256]

    def sample(ty, tx):
        idx = (ty[:, None] * tiles + tx[None, :]) * 256 + qimg
        return flat.gather(-1, idx.reshape(*idx.shape[:-2], -1)).reshape(idx.shape)

    return (sample(y0, x0) * (1 - fy) * (1 - fx) + sample(y0, x1) * (1 - fy) * fx
            + sample(y1, x0) * fy * (1 - fx) + sample(y1, x1) * fy * fx)


def _clahe_plain(img, clip: float = 3.0, tiles: int = 8):
    """CLAHE of float32 [H, W] or [B, H, W] as eager torch."""
    _check_clahe_shape(img.shape, tiles)
    return _clahe_apply_plain(img, _clahe_luts_plain(img, clip, tiles), tiles)


def clahe(img, clip: float = 3.0, tiles: int = 8):
    """Contrast-limited adaptive histogram equalization of float32 [H, W]
    or a stack [B, H, W], 0..255: per-tile 256-bin histograms, clip and
    redistribute, per-tile CDF lookup tables, then bilinear interpolation
    between the four nearest tiles' tables.  H and W must be multiples of
    ``tiles`` (ValueError otherwise).  On CUDA tensors K8 in two launches
    whatever B (the tables, then every pixel), bit-equal to the plain
    version; on CPU tensors the plain version."""
    if not _dispatch(img, "clahe"):
        return _clahe_plain(img, clip, tiles)
    out, _ = image_kernels.launch_clahe(img.contiguous(), clip, tiles)
    if out.numel():
        count(clahe, "launches", image_kernels.CLAHE_LAUNCHES)
    return out


clahe.launches = 0


def gather_patches(img, base_xy, size: int, lo: int):
    """[N, size, size] patches at integer bases:
    patch[n, p, q] = img[base_y + p - lo, base_x + q - lo].

    ``base_xy`` int [N, 2] must be pre-clipped so patches stay in bounds."""
    s = torch.arange(size, device=img.device)
    ys = (base_xy[:, 1] - lo)[:, None] + s[None, :]          # [N, size]
    xs = (base_xy[:, 0] - lo)[:, None] + s[None, :]
    return img[ys[:, :, None], xs[:, None, :]]


def bilinear_sample(img, xy):
    """Bilinear interpolation of [H, W] at xy [..., 2] (x, y), clamped to
    the border."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    idx = y0 * w + x0
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + w]
    v11 = flat[idx + w + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)
