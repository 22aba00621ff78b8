"""Forward-backward pyramidal Lucas-Kanade tracking.

Port of alvaar_tpu/ops/klt.py: the correlation-volume LK level pass
(``_lk_level`` → ``ops/lk_level.py``), the coarse-to-fine pyramid loop and
the forward-backward round-trip gate.  The level pass is the CUDA kernel
for CUDA tensors and its plain twin for CPU tensors; ``level_fn`` lets a
caller force the plain twin on the card to compare the two.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from alvaar_tpu_torch.ops.lk_level import BACKWARD_R, SEARCH_R, lk_level


@dataclasses.dataclass
class TrackResult:
    xy: torch.Tensor       # [N, 2] tracked positions
    status: torch.Tensor   # [N] bool
    err: torch.Tensor      # [N] mean |residual| over the window


def _lk_level(img_prev, img_cur, pts_prev, guess, valid, *, win: int,
              iters: int, eps: float, search_r: int = SEARCH_R,
              min_eig: float = 1e-4, level_fn=lk_level):
    """One pyramid level for all points (alvaar_tpu/ops/klt.py ``_lk_level``)."""
    return level_fn(img_prev, img_cur, pts_prev.contiguous(),
                    guess.contiguous(), valid.contiguous(), win=win,
                    iters=iters, eps=eps, search_r=search_r, min_eig=min_eig)


def klt_pyramidal(pyr_prev: Sequence[torch.Tensor],
                  pyr_cur: Sequence[torch.Tensor], pts, prior, valid, *,
                  levels: int, win: int = 9, iters: int = 30,
                  eps: float = 0.01, err_max: float = 30.0,
                  search_r: int = SEARCH_R, level_fn=lk_level) -> TrackResult:
    """Forward pyramidal LK from the coarsest of ``levels`` to level 0."""
    scale = 2.0 ** (levels - 1)
    guess = prior / scale
    ok = valid
    err = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        guess_lvl = guess if lvl == levels - 1 else guess * 2.0
        r_lvl = search_r if lvl == levels - 1 else min(search_r, 4)
        xy, ok_lvl, err = _lk_level(
            pyr_prev[lvl], pyr_cur[lvl], pts / s, guess_lvl, valid,
            win=win, iters=iters, eps=eps, search_r=r_lvl, level_fn=level_fn)
        ok = ok & ok_lvl
        guess = xy
    status = ok & (err <= err_max)
    return TrackResult(xy=guess, status=status, err=err)


def fb_klt_track(pyr_prev, pyr_cur, pts, prior, valid, *, levels: int,
                 win: int = 9, iters: int = 30, eps: float = 0.01,
                 err_max: float = 30.0, fb_dist: float = 0.5,
                 search_r: int = SEARCH_R, level_fn=lk_level) -> TrackResult:
    """Forward over ``levels``, backward on level 0 only, round-trip gate
    at ``fb_dist`` pixels."""
    fwd = klt_pyramidal(pyr_prev, pyr_cur, pts, prior, valid,
                        levels=levels, win=win, iters=iters, eps=eps,
                        err_max=err_max, search_r=search_r, level_fn=level_fn)
    bwd = klt_pyramidal(pyr_cur, pyr_prev, fwd.xy, pts, fwd.status,
                        levels=1, win=win, iters=min(iters, 12), eps=eps,
                        err_max=err_max, search_r=BACKWARD_R, level_fn=level_fn)
    rt = torch.linalg.norm(bwd.xy - pts, dim=-1)
    status = fwd.status & bwd.status & (rt <= fb_dist)
    return TrackResult(xy=fwd.xy, status=status, err=fwd.err)
