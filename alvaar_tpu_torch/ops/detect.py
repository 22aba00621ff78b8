"""Grid-based Shi-Tomasi corner detection with subpixel refinement.

Port of alvaar_tpu/ops/detect.py: one min-eigenvalue response pass over
the image, the best and second peak of every grid cell, occupancy and
quality gates with the 5-rung adaptive threshold ladder, a priority
selection that ranks first peaks before second ones, and a closed-form
quadratic subpixel fit.
"""

from __future__ import annotations

import dataclasses

import torch

from alvaar_tpu_torch.ops.image import (
    _sep_conv,
    gather_patches,
    gaussian_blur3,
    sobel_gradients,
)
from alvaar_tpu_torch.ops.topk import top_k

# cv::cornerMinEigenVal units for 8-bit input (see alvaar_tpu/ops/detect.py)
_CV_NORM = 9.0 / (3060.0 ** 2)


@dataclasses.dataclass
class Detections:
    xy: torch.Tensor           # [num_cells, 2] float32 subpixel positions
    score: torch.Tensor        # [num_cells] min-eig response (cv units)
    valid: torch.Tensor        # [num_cells] bool
    new_quality: torch.Tensor  # 0-d float32 adapted threshold


def shi_tomasi_response(img):
    """Min-eigenvalue corner response (3x3 block, 3x3 Sobel) after a 3x3
    Gaussian pre-blur, in cv::cornerMinEigenVal units."""
    dx, dy = sobel_gradients(gaussian_blur3(img))
    box = [1.0 / 3.0] * 3
    sxx = _sep_conv(dx * dx, box)
    syy = _sep_conv(dy * dy, box)
    sxy = _sep_conv(dx * dy, box)
    half_trace = 0.5 * (sxx + syy)
    disc = torch.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return (half_trace - disc) * _CV_NORM


def _tiles(resp, cell: int):
    h, w = resp.shape
    ph, pw = (-h) % cell, (-w) % cell
    if ph or pw:
        resp = torch.nn.functional.pad(resp, (0, pw, 0, ph), value=-torch.inf)
    gh, gw = resp.shape[0] // cell, resp.shape[1] // cell
    t = resp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
    return t.reshape(gh, gw, cell * cell), gh, gw


def _peak_xy(flat_idx, gh, gw, cell: int):
    dev = flat_idx.device
    cy = torch.arange(gh, device=dev)[:, None] * cell + flat_idx // cell
    cx = torch.arange(gw, device=dev)[None, :] * cell + flat_idx % cell
    return torch.stack([cx, cy], dim=-1).reshape(-1, 2)


def grid_argmax2(resp, cell: int):
    """Per-cell best and second peak (the second is the cell's max outside
    a cell/4-radius disc around the best).
    Returns (xy1 [C, 2], s1 [C], xy2 [C, 2], s2 [C])."""
    tiles, gh, gw = _tiles(resp, cell)
    i1 = torch.argmax(tiles, dim=-1)
    s1 = torch.gather(tiles, -1, i1[..., None])[..., 0]
    ar = torch.arange(cell * cell, device=resp.device)
    d2 = ((ar // cell - (i1 // cell)[..., None]) ** 2
          + (ar % cell - (i1 % cell)[..., None]) ** 2)
    r = cell // 4
    masked = torch.where(d2 <= r * r, -torch.inf, tiles)
    i2 = torch.argmax(masked, dim=-1)
    s2 = torch.gather(masked, -1, i2[..., None])[..., 0]
    return (_peak_xy(i1, gh, gw, cell), s1.reshape(-1),
            _peak_xy(i2, gh, gw, cell), s2.reshape(-1))


def subpix_refine(resp, xy_int):
    """Quadratic-fit subpixel peak on the 3x3 response neighbourhood.
    xy_int: [N, 2] int; returns [N, 2] float32."""
    h, w = resp.shape
    x = xy_int[:, 0].clamp(1, w - 2)
    y = xy_int[:, 1].clamp(1, h - 2)
    nb = gather_patches(resp, torch.stack([x, y], dim=1), 3, 1)   # [N, 3, 3]
    at = lambda dy, dx: nb[:, 1 + dy, 1 + dx]
    c = at(0, 0)
    dxx = at(0, 1) + at(0, -1) - 2 * c
    dyy = at(1, 0) + at(-1, 0) - 2 * c
    dxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    det = dxx * dyy - dxy * dxy
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    ox = -(dyy * gx - dxy * gy) / det
    oy = -(dxx * gy - dxy * gx) / det
    good = (torch.abs(ox) <= 1.0) & (torch.abs(oy) <= 1.0)
    ox = torch.where(good, ox, 0.0)
    oy = torch.where(good, oy, 0.0)
    return torch.stack([x + ox, y + oy], dim=-1).to(torch.float32)


def detect_grid(img, existing_xy, existing_valid, *, cell: int, border: int,
                quality=0.001) -> Detections:
    """Response → per-cell peaks → occupancy and quality gates →
    deficit-fill priority selection → subpixel positions → threshold
    adaptation.  ``quality`` may be a 0-d tensor (the adaptive threshold
    carried in the map state)."""
    h, w = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    xy1_i, s1, xy2_i, s2 = grid_argmax2(resp, cell)
    C = s1.shape[0]
    score = torch.cat([s1, s2])
    xy = subpix_refine(resp, torch.cat([xy1_i, xy2_i], dim=0))

    gw = -(-w // cell)
    kp_cell = ((existing_xy[:, 1].to(torch.int64).clamp(0, h - 1) // cell) * gw
               + existing_xy[:, 0].to(torch.int64).clamp(0, w - 1) // cell)
    cell_ids = torch.arange(C, device=dev)
    occ_cell = torch.any((cell_ids[:, None] == kp_cell[None, :])
                         & existing_valid[None, :], dim=1)
    occupied = occ_cell.repeat(2)
    d2 = torch.sum((xy[:, None, :] - existing_xy[None, :, :]) ** 2, dim=-1)
    too_close = torch.any((d2 < (cell / 4.0) ** 2) & existing_valid[None, :], dim=1)
    in_border = ((xy[:, 0] >= border) & (xy[:, 0] < w - border)
                 & (xy[:, 1] >= border) & (xy[:, 1] < h - border))
    base_ok = in_border & ~occupied & ~too_close & torch.isfinite(score)

    # 5-rung halving ladder, the accepted rung targets a 90% fill
    empty = (C - torch.sum(occ_cell)).to(torch.float32)
    q0 = torch.as_tensor(quality, dtype=torch.float32, device=dev)
    ladder = q0 * (0.5 ** torch.arange(5, dtype=torch.float32, device=dev))
    valid_r = base_ok[None, :] & (score[None, :] >= ladder[:, None])
    n1_r = torch.sum(valid_r[:, :C], dim=1).to(torch.float32)
    n2_r = torch.sum(valid_r[:, C:], dim=1).to(torch.float32)
    n_eff_r = n1_r + torch.minimum(n2_r, torch.clamp_min(empty - n1_r, 0.0))
    meets = n_eff_r >= 0.9 * empty
    k = torch.where(torch.any(meets), torch.argmax(meets.to(torch.int32)),
                    ladder.shape[0] - 1)
    valid = valid_r[k]
    factor = torch.where(n_eff_r[-1] < 0.33 * empty, 0.5,
                         torch.where(n_eff_r[0] > 0.9 * empty, 1.5, 1.0))
    new_quality = torch.clamp(q0 * factor, 1e-9, 1.0)

    is_first = torch.arange(2 * C, device=dev) < C
    prio = torch.where(valid, torch.where(is_first, 1e3, 0.0)
                       + torch.clamp(score, 0.0, 999.0), -torch.inf)
    _, sel = top_k(prio, C)
    return Detections(xy=xy[sel],
                      score=torch.where(valid[sel], score[sel], 0.0),
                      valid=valid[sel], new_quality=new_quality)
