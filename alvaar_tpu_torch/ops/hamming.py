"""Hamming distance on packed 256-bit descriptors — the popcount path.

Port of alvaar_tpu/ops/hamming.py (``hamming_matrix_popcount``,
``hamming_rowwise``, ``hamming_min_crossbag``, ``best_two``).  Torch has
no popcount op, so the XOR words are counted by SWAR arithmetic in int32
on their two 16-bit halves: no byte view of the words (which
``torch.func.vmap`` cannot batch) and no int64 widening.  Descriptor words
are int32 tensors holding uint32 bits.

For the loop database's [queries × tens of thousands] passes,
``hamming_matrix_chunked`` takes the database axis a chunk at a time, so
its temporaries stay a few tens of MB.
"""

from __future__ import annotations

import torch

from alvaar_tpu_torch.ops.topk import top_k

DESC_BITS = 256


def popcount_words(x):
    """[..., 8] int32 words → [...] int32 count of set bits, by SWAR on
    each word's two 16-bit halves: every intermediate stays non-negative,
    so int32 arithmetic shifts behave as logical ones."""
    h = torch.stack([x & 0xFFFF, (x >> 16) & 0xFFFF], dim=-1)
    h = h - ((h >> 1) & 0x5555)
    h = (h & 0x3333) + ((h >> 2) & 0x3333)
    h = (h + (h >> 4)) & 0x0F0F
    h = (h + (h >> 8)) & 0x001F
    return h.sum(dim=(-2, -1), dtype=torch.int32)


def hamming_matrix(a, b):
    """[N, 8] x [M, 8] → [N, M] int32 Hamming distances."""
    return popcount_words(a[:, None, :] ^ b[None, :, :])


def hamming_matrix_chunked(a, b, chunk: int = 2048):
    """[N, 8] x [M, 8] → [N, M] int32, equal to ``hamming_matrix``; the M
    axis is taken ``chunk`` rows at a time."""
    return torch.cat([popcount_words(a[:, None, :] ^ b[None, lo:lo + chunk, :])
                      for lo in range(0, b.shape[0], chunk)], dim=1)


def hamming_rowwise(a, b):
    """Paired distances: [N, 8] x [N, 8] → [N]."""
    return popcount_words(a ^ b)


def hamming_min_crossbag(bag_a, filled_a, bag_b, filled_b):
    """Minimum Hamming distance over all (desc_a, desc_b) pairs of two
    descriptor bags.  bag_a [N, G, 8], filled_a [N, G]; bag_b [M, G, 8],
    filled_b [M, G].  Returns [N, M] float32 (257 where either bag is
    empty).  One [N, M] pass per bag-entry pair keeps the temporaries at
    a few [N, M, 8] int32 tensors."""
    n, g, _ = bag_a.shape
    m, gb, _ = bag_b.shape
    big = float(DESC_BITS + 1)
    best = torch.full((n, m), big, dtype=torch.float32, device=bag_a.device)
    for gi in range(g):
        for gj in range(gb):
            d = hamming_matrix(bag_a[:, gi], bag_b[:, gj]).to(torch.float32)
            ok = filled_a[:, gi][:, None] & filled_b[:, gj][None, :]
            best = torch.minimum(best, torch.where(ok, d, big))
    return best


def best_two(dists, valid_cols=None):
    """Best and second-best distances + best index along the last axis
    (the NNDR primitive); invalid columns are masked to a huge distance."""
    if valid_cols is not None:
        dists = torch.where(valid_cols, dists, 10 * DESC_BITS)
    top2, idx2 = top_k(-dists.to(torch.float32), 2)
    return -top2[..., 0], -top2[..., 1], idx2[..., 0]
