"""Forward-backward pyramidal Lucas-Kanade tracking.

Port of alvaar_tpu/ops/klt.py: the correlation-volume LK level pass
(``_lk_level`` → ``ops/lk_level.py``), the coarse-to-fine pyramid loop and
the forward-backward round-trip gate.  On CUDA tensors ``fb_klt_track`` and
``klt_pyramidal`` are each one launch of the kernel in ``csrc/klt_track.cu``,
which runs the whole schedule of level passes per point; on CPU tensors
they are the plain composition below (over ``lk_level_plain``), which is
the kernel's plain version.  ``level_fn`` runs the composition over another
level pass on any device (``chip_smoke.py`` uses it to compare the kernel
with the plain version on the card).

Both take one stream (pyramid levels [H, W], points [N, 2]) or B streams
at once (levels [B, H, W], points [B·K, 2] grouped by stream, K per
stream): on CUDA still one launch, whose blocks read their own stream's
images; the plain version runs the composition stream by stream.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from alvaar_tpu_torch.ops.lk_level import (BACKWARD_ITERS_MAX, BACKWARD_R, SEARCH_R,
                                           klt_schedule, launch_klt_track, lk_level_plain)
from alvaar_tpu_torch.utils.stats import count


def _launches_kernel(pts, level_fn, name: str) -> bool:
    """True for CUDA tensors and no ``level_fn``; False for CPU tensors or
    an explicit ``level_fn``; any other device raises."""
    if level_fn is not None or pts.device.type == "cpu":
        return False
    if pts.device.type == "cuda":
        return True
    raise ValueError(f"{name} runs on CPU or CUDA tensors, got {pts.device}")


def _per_stream(fn, pyr_prev, pyr_cur, pts, prior, valid, **kw):
    """``fn`` (the plain composition) over B streams: [B, H, W] levels and
    [B·K, 2] points grouped by stream, one stream at a time."""
    b = pyr_cur[0].shape[0]
    if pts.shape[0] % b:
        raise ValueError(f"{pts.shape[0]} points do not split evenly over {b} streams")
    k = pts.shape[0] // b
    outs = [fn([lv[i] for lv in pyr_prev], [lv[i] for lv in pyr_cur], pts[i * k:(i + 1) * k],
               prior[i * k:(i + 1) * k], valid[i * k:(i + 1) * k], **kw) for i in range(b)]
    return TrackResult(xy=torch.cat([o.xy for o in outs]),
                       status=torch.cat([o.status for o in outs]),
                       err=torch.cat([o.err for o in outs]))


@dataclasses.dataclass
class TrackResult:
    xy: torch.Tensor       # [N, 2] tracked positions
    status: torch.Tensor   # [N] bool
    err: torch.Tensor      # [N] mean |residual| over the window


def klt_pyramidal(pyr_prev: Sequence[torch.Tensor],
                  pyr_cur: Sequence[torch.Tensor], pts, prior, valid, *,
                  levels: int, win: int = 9, iters: int = 30,
                  eps: float = 0.01, err_max: float = 30.0,
                  search_r: int = SEARCH_R, level_fn=None) -> TrackResult:
    """Forward pyramidal LK from the coarsest of ``levels`` to level 0.
    One kernel launch for CUDA tensors, the plain composition for CPU
    tensors, the composition over ``level_fn`` when one is given."""
    if pyr_cur[0].dim() == 3 and not _launches_kernel(pts, level_fn, "klt_pyramidal"):
        return _per_stream(klt_pyramidal, pyr_prev, pyr_cur, pts, prior, valid,
                           levels=levels, win=win, iters=iters, eps=eps, err_max=err_max,
                           search_r=search_r, level_fn=level_fn)
    if _launches_kernel(pts, level_fn, "klt_pyramidal"):
        xy, status, err = launch_klt_track(
            pyr_prev, pyr_cur, pts.contiguous(), prior.contiguous(), valid.contiguous(),
            klt_schedule(levels, search_r, iters, backward=False), gated=True, win=win,
            eps=eps, err_max=err_max)
        count(klt_pyramidal, "launches")
        return TrackResult(xy=xy, status=status, err=err)
    level_fn = level_fn or lk_level_plain
    scale = 2.0 ** (levels - 1)
    guess = prior / scale
    ok = valid
    err = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        guess_lvl = guess if lvl == levels - 1 else guess * 2.0
        r_lvl = search_r if lvl == levels - 1 else min(search_r, 4)
        xy, ok_lvl, err = level_fn(
            pyr_prev[lvl], pyr_cur[lvl], (pts / s).contiguous(), guess_lvl.contiguous(),
            valid.contiguous(), win=win, iters=iters, eps=eps, search_r=r_lvl)
        ok = ok & ok_lvl
        guess = xy
    status = ok & (err <= err_max)
    return TrackResult(xy=guess, status=status, err=err)


def fb_klt_track(pyr_prev, pyr_cur, pts, prior, valid, *, levels: int,
                 win: int = 9, iters: int = 30, eps: float = 0.01,
                 err_max: float = 30.0, fb_dist: float = 0.5,
                 search_r: int = SEARCH_R, level_fn=None) -> TrackResult:
    """Forward over ``levels``, backward on level 0 only, round-trip gate
    at ``fb_dist`` pixels.  One kernel launch for CUDA tensors, the plain
    composition for CPU tensors, the composition over ``level_fn`` when one
    is given."""
    if pyr_cur[0].dim() == 3 and not _launches_kernel(pts, level_fn, "fb_klt_track"):
        return _per_stream(fb_klt_track, pyr_prev, pyr_cur, pts, prior, valid,
                           levels=levels, win=win, iters=iters, eps=eps, err_max=err_max,
                           fb_dist=fb_dist, search_r=search_r, level_fn=level_fn)
    if _launches_kernel(pts, level_fn, "fb_klt_track"):
        xy, status, err = launch_klt_track(
            pyr_prev, pyr_cur, pts.contiguous(), prior.contiguous(), valid.contiguous(),
            klt_schedule(levels, search_r, iters), gated=True, win=win, eps=eps,
            err_max=err_max, fb_dist=fb_dist)
        count(fb_klt_track, "launches")
        return TrackResult(xy=xy, status=status, err=err)
    level_fn = level_fn or lk_level_plain
    fwd = klt_pyramidal(pyr_prev, pyr_cur, pts, prior, valid,
                        levels=levels, win=win, iters=iters, eps=eps,
                        err_max=err_max, search_r=search_r, level_fn=level_fn)
    bwd = klt_pyramidal(pyr_cur, pyr_prev, fwd.xy, pts, fwd.status,
                        levels=1, win=win, iters=min(iters, BACKWARD_ITERS_MAX), eps=eps,
                        err_max=err_max, search_r=BACKWARD_R, level_fn=level_fn)
    # sqrt(dx² + dy²) as two products and a sum, as the kernel computes it
    # (torch.linalg.norm's reduction may contract them into FMAs on the card)
    d = bwd.xy - pts
    rt = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    status = fwd.status & bwd.status & (rt <= fb_dist)
    return TrackResult(xy=fwd.xy, status=status, err=fwd.err)


klt_pyramidal.launches = 0
fb_klt_track.launches = 0
