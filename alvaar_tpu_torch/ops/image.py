"""Image preprocessing ops: grayscale, separable stencils, pyramid, CLAHE,
patches.

Port of alvaar_tpu/ops/image.py.  Images are float32 ``[H, W]`` in the
0..255 range.  The stencils are shift-adds in the same tap order as the
JAX package's ``_sep_conv``, not cuDNN convolutions (which would run in
TF32 on the card by default).  Patch extraction is a direct gather: the
JAX package's one-hot matmul is exact, so the gather returns the same
values.  CLAHE counts its per-tile histograms with ``scatter_add_``
where the JAX package sums a one-hot tensor; the counts are exact
integers either way.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rgba_to_gray(frame):
    """[H, W, 4] (or [H, W, 3]) → [H, W] float32 luma (BT.601)."""
    f = frame.to(torch.float32)
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


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


def pyr_down(img):
    """5-tap binomial blur [1, 4, 6, 4, 1] / 16 + 2x decimation of
    [..., H, W]."""
    blurred = _sep_conv(img, [0.0625, 0.25, 0.375, 0.25, 0.0625])
    return blurred[..., ::2, ::2].contiguous()   # the KLT kernel reads it densely


def build_pyramid(img, levels: int) -> Tuple[torch.Tensor, ...]:
    """Image pyramid of [H, W] or a stack [B, H, W], level 0 = full
    resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return tuple(pyr)


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


def clahe(img, clip: float = 3.0, tiles: int = 8):
    """Contrast-limited adaptive histogram equalization of [H, W] float32
    0..255: per-tile 256-bin histograms, clip and redistribute, per-tile
    CDF lookup tables, then bilinear interpolation between the four
    nearest tiles' tables.  H and W must be divisible by ``tiles``."""
    h, w = img.shape
    th, tw = h // tiles, w // tiles
    dev = img.device
    x = img.reshape(tiles, th, tiles, tw).permute(0, 2, 1, 3).reshape(tiles * tiles, th * tw)
    q = torch.clamp(torch.round(x), 0, 255).to(torch.int64)          # [T, P]
    hist = torch.zeros(tiles * tiles, 256, dtype=torch.float32, device=dev)
    hist.scatter_add_(1, q, torch.ones_like(x, dtype=torch.float32))

    clip_limit = max(clip * (th * tw) / 256.0, 1.0)
    excess = torch.clamp_min(hist - clip_limit, 0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp_max(hist, clip_limit) + excess / 256.0
    cdf = torch.cumsum(hist, dim=-1)
    cdf = (cdf - cdf[..., :1]) / (cdf[..., -1:] - cdf[..., :1]).clamp_min(1.0) * 255.0
    lut = cdf.reshape(tiles, tiles, 256)

    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy), 0, tiles - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xx), 0, tiles - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    qimg = torch.clamp(torch.round(img), 0, 255).to(torch.int64)

    def sample(ty, tx):
        return lut[ty[:, None], tx[None, :], qimg]

    return (sample(y0, x0) * (1 - fy) * (1 - fx) + sample(y0, x1) * (1 - fy) * fx
            + sample(y1, x0) * fy * (1 - fx) + sample(y1, x1) * fy * fx)


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
