"""``top_k`` with ``jax.lax.top_k``'s tie order.

``jax.lax.top_k`` returns ties in index order (it is a stable descending
sort); ``torch.topk`` promises no order among ties.  Where the order of
tied entries decides which slot gets which keypoint or landmark, the port
needs the JAX order, so it sorts stably."""

from __future__ import annotations

import torch


def top_k(x, k: int):
    """Largest ``k`` entries along the last axis, ties in index order.
    Returns (values, indices) like ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
