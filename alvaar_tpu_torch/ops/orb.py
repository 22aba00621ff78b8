"""Oriented binary descriptors (ORB-style) — batched over keypoints.

Port of alvaar_tpu/ops/orb.py: intensity-centroid orientation over a
31-diameter circle at the rounded keypoint, then 256 steered pixel
comparisons on the blurred image packed into 8 words.  The comparison
pattern is the JAX package's own (``_make_pattern(12345)``), steered by
the same 30 angle bins with nearest-pixel taps.

The JAX package takes the comparisons as bf16 ±1 matmuls, so a pixel pair
compares as ``bf16(v1) - bf16(v0) > 0`` (the f32 accumulation of two bf16
values is exact).  Here each pair is a direct gather, with the two values
rounded to bf16 first, which gives the same bits.  Descriptor words are
int32 tensors holding the uint32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from alvaar_tpu_torch.ops.image import _sep_conv, gather_patches

PATCH_RADIUS = 15
DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32
NUM_ANGLE_BINS = 30
_PSZ = 36          # extracted patch size
_PLO = 17          # patch centre offset: the patch covers [-17, +18]


def _make_pattern(seed: int = 12345) -> np.ndarray:
    """Deterministic BRIEF pattern [256, 2, 2] (pair, point, xy): Gaussian
    sigma = patch/5, clipped to the patch circle (the JAX package's)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(DESC_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    too_far = norm > (PATCH_RADIUS - 1)
    pts = np.where(too_far, pts * (PATCH_RADIUS - 1) / np.maximum(norm, 1e-9), pts)
    return pts.astype(np.float32)


def _make_tap_luts() -> np.ndarray:
    """[NUM_ANGLE_BINS, 256, 2] flat in-patch indices of the rotated and
    rounded pattern points (point 0, point 1) for each angle bin."""
    pattern = _make_pattern()
    luts = np.zeros((NUM_ANGLE_BINS, DESC_BITS, 2), np.int64)
    for a in range(NUM_ANGLE_BINS):
        ang = 2.0 * np.pi * a / NUM_ANGLE_BINS
        ca, sa = np.cos(ang), np.sin(ang)
        rx = np.rint(ca * pattern[..., 0] - sa * pattern[..., 1]) + _PLO
        ry = np.rint(sa * pattern[..., 0] + ca * pattern[..., 1]) + _PLO
        luts[a] = ry.astype(np.int64) * _PSZ + rx.astype(np.int64)
    return luts


def _circle_masks():
    d = np.arange(-PATCH_RADIUS, PATCH_RADIUS + 1)
    oy, ox = np.meshgrid(d, d, indexing="ij")
    inside = ox * ox + oy * oy <= PATCH_RADIUS * PATCH_RADIUS
    return (np.where(inside, ox, 0).astype(np.float32),
            np.where(inside, oy, 0).astype(np.float32))


_TAP_LUTS = _make_tap_luts()          # [30, 256, 2] int64
_MASK_X, _MASK_Y = _circle_masks()    # [31, 31] float32


def _patch_centers(img, xy):
    h, w = img.shape
    c = torch.floor(xy + 0.5).to(torch.int64)
    return torch.stack([c[:, 0].clamp(_PLO, w - (_PSZ - _PLO)),
                        c[:, 1].clamp(_PLO, h - (_PSZ - _PLO))], dim=1)


def _moment_angle(patches):
    """Intensity-centroid angle from [N, 36, 36] patches."""
    lo = _PLO - PATCH_RADIUS
    win = patches[:, lo:lo + 31, lo:lo + 31]
    mx = torch.as_tensor(_MASK_X, device=patches.device)
    my = torch.as_tensor(_MASK_Y, device=patches.device)
    m10 = torch.sum(win * mx, dim=(1, 2))
    m01 = torch.sum(win * my, dim=(1, 2))
    return torch.atan2(m01, m10)


def ic_angle(img, xy):
    """Orientation [N] in radians at the rounded keypoint centres."""
    return _moment_angle(gather_patches(img, _patch_centers(img, xy), _PSZ, _PLO))


def pack_bits(bits):
    """[N, 256] bool → [N, 8] int32 words holding the uint32 bits (bit b of
    word k is comparison 32 k + b)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, DESC_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def describe(img, xy, valid, *, blur: bool = True):
    """Oriented 256-bit descriptors at keypoints.
    Returns (desc [N, 8] int32 — zeros where invalid, angle [N])."""
    if blur:
        img = _sep_conv(img, [0.2] * 5)
    patches = gather_patches(img, _patch_centers(img, xy), _PSZ, _PLO)
    angle = _moment_angle(patches)
    two_pi = 2.0 * math.pi
    abin = torch.floor(torch.remainder(angle, two_pi) / two_pi * NUM_ANGLE_BINS
                       + 0.5).to(torch.int64) % NUM_ANGLE_BINS

    taps = torch.as_tensor(_TAP_LUTS, device=img.device)[abin]     # [N, 256, 2]
    flat = patches.reshape(patches.shape[0], _PSZ * _PSZ)
    flat = flat.to(torch.bfloat16).to(torch.float32)
    v0 = torch.gather(flat, 1, taps[..., 0])
    v1 = torch.gather(flat, 1, taps[..., 1])
    desc = pack_bits(v1 - v0 > 0)
    return torch.where(valid[:, None], desc, 0), angle
