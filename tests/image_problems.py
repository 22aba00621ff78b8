"""Seeded inputs and bars for the image kernels K7, K5, K3 and K8
(csrc/image_kernels.cu), in numpy and the port only (no JAX): the CPU
tests (tests/test_torch_image_kernels.py), the card's tests
(tests/test_torch_image_kernels_card.py) and chip_smoke.py phase 2e use
them.

``frame`` renders the synthetic two-plane scene (tests/render_scene_np.py)
at any size, ``image_of`` it or another kind of image (a constant, blocks,
non-finite pixels); ``rgba`` makes u8 RGBA frames of it; ``keypoints`` places
keypoints inside an image, on its edges and past them; ``existing`` makes
the live keypoints that detection's occupancy and proximity gates read;
``clahe_image`` makes CLAHE's inputs, ``CLAHE_CASES`` and
``CLAHE_LAYOUT_CASES`` list them and ``clahe_input`` places one at an
offset from a 16-byte boundary.

``ieee_sqrt`` is the plain versions' reference on the CPU.  A CPU build of
torch with MKL takes ``torch.sqrt`` of float32 through MKL's vector math,
which is not correctly rounded (the root of 204692.25 comes out
452.42926, one ulp under IEEE's 452.42929); on the card ``torch.sqrt`` is
IEEE's, as the kernels' ``sqrtf`` is.  Within the context a CPU float32
``torch.sqrt`` is numpy's, which is IEEE's, so the plain versions
compute on the CPU what they compute on the card; on CUDA tensors it
changes nothing.

K3's bar: angles within ``ANGLE_BAR`` rad of the plain version's (which
sums its 961-term moments with ``torch.sum`` in an order no kernel
reproduces), and the words bit-equal at every keypoint whose plain angle
lies more than ``BIN_MARGIN`` rad from a steering bin's edge
(``bin_margin``).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

ANGLE_BAR = 2e-5
# K8's clips: the default's (3.0), whose clip limits th tw 3 / 256 are
# dyadic (every excess term and partial sum exact in float32: K8
# bit-equal to its plain version), and one whose limits are not (2.7: the
# excess summed in another order, within CLAHE_ATOL of 0..255)
CLAHE_CLIP = 3.0
CLAHE_ODD_CLIP = 2.7
CLAHE_ATOL = 1e-3
# (W, H, tiles, kind) of ``clahe_image``: both tile counts at two sizes, a
# constant image, and zeros in tiles of 1 and 2 pixels (a table whose
# cdfN - cdf0 is 0, and 255 / 256: the clamp to 1 applies)
CLAHE_CASES = [(128, 96, 8, "band"), (128, 96, 4, "band"), (160, 120, 8, "band"),
               (160, 120, 4, "band"), (128, 96, 8, "constant"), (8, 8, 8, "zeros"),
               (16, 8, 8, "zeros")]
# K8's layouts (W, H, tiles, kind of ``clahe_image``, offset): a tile side
# that is not a multiple of 4 (W = 40 with 8 tiles: both kernels' scalar
# path), inputs starting 1 and 3 floats past a 16-byte boundary (the
# scalar path at tile sides of 16 and 40), a constant 640x480 at 4 tiles a
# side (every pixel of a 160 x 120 tile counted into one bin), and one
# 8192 x 2 tile (the pixel kernel's threads walk 8 column groups of a row)
CLAHE_LAYOUT_CASES = [(40, 24, 8, "band", 0), (128, 96, 8, "band", 1),
                      (160, 120, 4, "band", 3), (640, 480, 4, "constant", 0),
                      (8192, 2, 1, "band", 0)]
BIN_MARGIN = 1e-4
ANGLE_BINS = 30


@functools.lru_cache(maxsize=None)
def _scene(w: int, h: int, seed: int):
    from render_scene_np import TwoPlaneScene
    return TwoPlaneScene(np.random.default_rng(seed), w, h, fov=60.0)


def frame(w: int, h: int, seed: int = 42, index: int = 1) -> np.ndarray:
    """[h, w] float32 0..255: the two-plane scene at pose ``index`` of the
    golden trajectory (the scene's texture from ``seed``)."""
    from render_scene_np import trajectory
    pose = trajectory(index + 2, step=0.04)[index]
    return _scene(w, h, seed).render(pose).astype(np.float32)


def image_of(kind: str, w: int, h: int) -> np.ndarray:
    """[h, w] float32 of one kind: the rendered scene, a constant, 8 x 8
    blocks of 40 and 215, or the scene with 6 pixels each NaN, inf and -inf
    at seeded places."""
    if kind == "scene":
        return frame(w, h)
    if kind == "constant":
        return np.full((h, w), 77.0, np.float32)
    if kind == "nonfinite":
        img = frame(w, h).copy()
        rng = np.random.default_rng(w * h)
        for v in (np.nan, np.inf, -np.inf):
            img.reshape(-1)[rng.integers(0, h * w, 6)] = v
        return img
    y, x = np.mgrid[:h, :w]
    return np.where((y // 8 + x // 8) % 2 == 0, 40.0, 215.0).astype(np.float32)


def clahe_image(kind: str, w: int, h: int) -> np.ndarray:
    """[h, w] float32 for CLAHE: "band", the scene with its left 40%
    darkened to 0.3 (clipping engages) and its first row's first pixels at
    0, 255, the ties 0.5, 1.5, 2.5 and 254.5 (rounded half to even) and
    -3 and 300 (clamped); "constant", 77; "zeros", 0."""
    if kind == "constant":
        return np.full((h, w), 77.0, np.float32)
    if kind == "zeros":
        return np.zeros((h, w), np.float32)
    img = frame(w, h).copy()
    img[:, :int(0.4 * w)] *= np.float32(0.3)
    ties = np.array([0, 255, 0.5, 1.5, 2.5, 254.5, -3, 300], np.float32)
    img[0, :min(w, len(ties))] = ties[:w]
    return img


def clahe_input(kind: str, w: int, h: int, offset: int, dev) -> torch.Tensor:
    """``clahe_image(kind, w, h)`` as a contiguous [h, w] float32 tensor on
    ``dev`` that starts ``offset`` floats into a fresh allocation (whose
    start is 16-byte aligned): at an offset that is not a multiple of 4 the
    image is not 16-byte aligned."""
    buf = torch.zeros(h * w + offset, device=dev)
    buf[offset:] = torch.as_tensor(clahe_image(kind, w, h).reshape(-1), device=dev)
    return buf[offset:].view(h, w)


def rgba(gray: np.ndarray) -> np.ndarray:
    """[..., h, w, 4] u8 RGBA whose channels differ: gray, 0.9 gray, 0.7
    gray + 20, 255."""
    g = np.asarray(gray, np.float32)
    ch = [g, 0.9 * g, 0.7 * g + 20.0, np.full_like(g, 255.0)]
    return np.clip(np.rint(np.stack(ch, -1)), 0, 255).astype(np.uint8)


def keypoints(rng, n: int, w: int, h: int) -> np.ndarray:
    """[n, 2] float32 (x, y): the image's corners and edge midpoints, a few
    points past the edges and at half-pixel ties, the rest uniform inside."""
    edge = np.array([[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1], [w / 2, 0], [0, h / 2],
                     [-2.5, h + 1.0], [w + 3.0, -1.0], [17.5, 17.5], [w - 18.5, h - 19.5]],
                    np.float32)
    inside = rng.uniform([0, 0], [w - 1, h - 1], size=(max(n - len(edge), 0), 2))
    return np.concatenate([edge, inside.astype(np.float32)])[:n]


def existing(rng, n: int, w: int, h: int):
    """Live keypoints for detection's gates: (xy [max(n, 1), 2] float32,
    valid [max(n, 1)] bool, n of them valid; one invalid slot sits past the
    image, whose cell must not count)."""
    xy = rng.uniform([2, 2], [w - 2, h - 2], size=(max(n, 1) + 1, 2)).astype(np.float32)
    valid = np.arange(len(xy)) < n
    xy[-1] = [w + 50.0, -30.0]
    return xy, valid


def same(a, b) -> bool:
    """Tensors bit-equal but that NaN equals NaN (at the same places)."""
    zero = lambda x: torch.where(x.isnan(), 0.0, x)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(zero(a), zero(b))


@contextlib.contextmanager
def ieee_sqrt():
    """Within: ``torch.sqrt`` of a CPU float32 tensor is correctly rounded
    (numpy's), as the card's is."""
    orig = torch.sqrt

    def sqrt(x, *args, **kwargs):
        if (isinstance(x, torch.Tensor) and x.device.type == "cpu" and x.dtype == torch.float32
                and not args and not kwargs):
            return torch.from_numpy(np.sqrt(x.detach().numpy()))
        return orig(x, *args, **kwargs)

    torch.sqrt = sqrt
    try:
        yield
    finally:
        torch.sqrt = orig


def bin_margin(angle) -> np.ndarray:
    """Each angle's distance in rad from the nearest edge of ``describe``'s
    30 steering bins (bin floor(a / (2 pi) 30 + 0.5) mod 30, in float64)."""
    a = np.mod(np.asarray(angle, np.float64), 2 * math.pi) / (2 * math.pi) * ANGLE_BINS + 0.5
    return np.abs(a - np.rint(a)) * (2 * math.pi / ANGLE_BINS)


def words_outside_margin(desc, plain_desc, plain_angle):
    """(keypoints inside the margin, words differing outside it, words
    differing inside it) of K3's descriptors against the plain version's."""
    inside = bin_margin(plain_angle.detach().cpu().numpy().reshape(-1)) <= BIN_MARGIN
    diff = (desc != plain_desc).reshape(len(inside), -1).any(-1).cpu().numpy()
    return int(inside.sum()), int((diff & ~inside).sum()), int((diff & inside).sum())


def float64_angles(img, xy, blur: bool = True) -> np.ndarray:
    """The intensity-centroid angles of ``describe``'s definition, computed
    here in numpy alone: the image blurred by the 5-tap 0.2 box with edge
    padding (rows first, float32), each keypoint rounded to a pixel and
    clamped so its 36 x 36 patch (centre offset 17) stays inside, the
    float32 terms of the radius-15 disc's moments summed in float64, each
    sum rounded once to float32, then a float32 atan2.  K3 computes these by
    design; where the moments nearly cancel, a float32 sum (the plain
    version's, the JAX package's) lies farther from them than K3's bar."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    if blur:
        fifth = np.float32(0.2)
        p = np.pad(img, ((2, 2), (0, 0)), mode="edge")
        img = sum(fifth * p[i:i + h] for i in range(5))
        p = np.pad(img, ((0, 0), (2, 2)), mode="edge")
        img = sum(fifth * p[:, i:i + w] for i in range(5))
    c = np.floor(np.asarray(xy, np.float32) + np.float32(0.5)).astype(np.int64)
    cx = np.clip(c[:, 0], 17, w - 19)
    cy = np.clip(c[:, 1], 17, h - 19)
    d = np.arange(-15, 16)
    patches = img[(cy[:, None] + d)[:, :, None], (cx[:, None] + d)[:, None, :]]  # [N, 31, 31]
    disc = d[:, None] ** 2 + d[None, :] ** 2 <= 15 * 15
    mx = np.where(disc, d[None, :], 0).astype(np.float32)
    my = np.where(disc, d[:, None], 0).astype(np.float32)
    m10 = (patches * mx).astype(np.float64).sum(axis=(1, 2)).astype(np.float32)
    m01 = (patches * my).astype(np.float64).sum(axis=(1, 2)).astype(np.float32)
    return np.arctan2(m01, m10)
