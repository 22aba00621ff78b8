"""Rows and columns at a 0-d index tensor (a keyframe slot, a RANSAC
hypothesis, a ladder rung), without reading it on the host.

``x[i]`` and ``x[i] = v`` with a 0-d integer tensor ``i`` read ``i`` on
the host (``Tensor.item``: a sync on the card).  A one-element gather and
a select by ``arange == i`` do not, and give the same values, under
``torch.func.vmap`` too.
"""

from __future__ import annotations

import torch


def take_row(x, i):
    """``x[i]``."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def take_col(x, i):
    """``x[:, i]``."""
    return x.index_select(1, i.reshape(1)).squeeze(1)


def put_row(x, i, v):
    """``x`` with ``x[i] = v``, out of place."""
    at = torch.arange(x.shape[0], device=x.device) == i
    return torch.where(at.reshape((-1,) + (1,) * (x.dim() - 1)), v, x)


def put_col(x, i, v):
    """``x`` with ``x[:, i] = v`` ([N, W], ``v`` [N] or a scalar), out of
    place."""
    at = torch.arange(x.shape[1], device=x.device) == i
    return torch.where(at[None, :], v[:, None] if isinstance(v, torch.Tensor) else v, x)
