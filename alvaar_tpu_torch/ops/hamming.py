"""Hamming distance on packed 256-bit descriptors — the popcount path.

Port of alvaar_tpu/ops/hamming.py (``hamming_matrix_popcount``,
``hamming_rowwise``, ``hamming_min_crossbag``, ``best_two``).  Descriptor
words are int32 tensors holding uint32 bits.

``hamming_min_crossbag`` (local-map matching), ``hamming_best_two`` (the
loop queries: each query row's least and second least masked distance and
the first column of the least, which the JAX package reduces from its
[N, M] matrix) and ``hamming_matrix`` / ``hamming_matrix_chunked`` (the
dense matrix) dispatch on the device: CUDA tensors launch K4
(csrc/hamming.cu, ops/hamming_kernel.py) through the custom ops
``alvaar_tpu_torch::hamming_min_crossbag``, ``::hamming_best_two`` and
``::hamming_matrix``, whose batching rule makes one launch over all the
rows that ``torch.func.vmap`` stacks (a lone ``hamming_min_crossbag`` or
``hamming_best_two`` call, outside any transform, goes straight to the
launcher; the best two's merge across column chunks, where the card needs
several, is a second launch); CPU tensors run the plain versions; any
other device raises.  The
plain versions count the XOR words by SWAR arithmetic in int32 on their
two 16-bit halves: no byte view of the words (which ``torch.func.vmap``
cannot batch) and no int64 widening.  On the CPU ``hamming_matrix_chunked``
and ``hamming_best_two`` take the database axis a chunk at a time, so their
temporaries stay a few tens of MB.
"""

from __future__ import annotations

import torch

from alvaar_tpu_torch.ops import hamming_kernel
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.utils.custom_ops import dispatch as _dispatch, one, rows_rule, wrapped
from alvaar_tpu_torch.utils.stats import count

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


def _hamming_matrix_plain(a, b):
    """[N, 8] x [M, 8] → [N, M] int32 Hamming distances."""
    return popcount_words(a[:, None, :] ^ b[None, :, :])


def _hamming_matrix_chunks(a, b, chunk: int = 2048):
    """``_hamming_matrix_plain`` with the M axis taken ``chunk`` rows at a
    time."""
    return torch.cat([popcount_words(a[:, None, :] ^ b[None, lo:lo + chunk, :])
                      for lo in range(0, b.shape[0], chunk)], dim=1)


def hamming_matrix_chunked(a, b, chunk: int = 2048):
    """[N, 8] x [M, 8] → [N, M] int32, equal to ``hamming_matrix``: one K4
    launch on CUDA tensors; on CPU tensors the M axis is taken ``chunk``
    rows at a time."""
    if _dispatch(a, "hamming_matrix"):
        return hamming_matrix(a, b)
    return _hamming_matrix_chunks(a, b, chunk)


def _top2_min(dist):
    """Row-wise (best, second, best_idx) over a wide [N, M] distance
    matrix; ties resolve to the first index."""
    bi = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, bi[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.min(torch.where(cols[None, :] == bi[:, None], torch.inf, dist), dim=1).values
    return best, second, bi


def _hamming_best_two_plain(a, b, row_ok, col_ok, big: float):
    """The loop queries' composition: [N, 8] x [M, 8] distances (the M axis
    a chunk at a time) as float32, ``big`` where ``row_ok`` [N] or
    ``col_ok`` [M] is off, then each row's (best, second, best_idx) by
    ``_top2_min``."""
    dist = _hamming_matrix_chunks(a, b).to(torch.float32)
    dist = torch.where(col_ok[None, :] & row_ok[:, None], dist, big)
    return _top2_min(dist)


def hamming_rowwise(a, b):
    """Paired distances: [N, 8] x [N, 8] → [N]."""
    return popcount_words(a ^ b)


def _min_crossbag_plain(bag_a, filled_a, bag_b, filled_b):
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
            d = _hamming_matrix_plain(bag_a[:, gi], bag_b[:, gj]).to(torch.float32)
            ok = filled_a[:, gi][:, None] & filled_b[:, gj][None, :]
            best = torch.minimum(best, torch.where(ok, d, big))
    return best


# ---------------------------------------------------------------------------
# K4's custom ops: the plain version row by row on CPU tensors, the kernel on
# CUDA tensors, one launch over all the rows under vmap
# ---------------------------------------------------------------------------

def _min_crossbag_rows(bag_a, filled_a, bag_b, filled_b):
    return torch.stack([_min_crossbag_plain(*(x[i] for x in (bag_a, filled_a, bag_b, filled_b)))
                        for i in range(bag_a.shape[0])])


def _launch_min_crossbag(bag_a, filled_a, bag_b, filled_b):
    out = hamming_kernel.launch_min_crossbag(bag_a, filled_a, bag_b, filled_b)
    if hamming_kernel.launched(out):
        count(hamming_min_crossbag, "launches")
    return out


def _matrix_rows(a, b):
    return torch.stack([_hamming_matrix_plain(a[i], b[i]) for i in range(a.shape[0])])


def _best_two_rows(a, b, row_ok, col_ok, big):
    out = [_hamming_best_two_plain(a[i], b[i], row_ok[i], col_ok[i], big)
           for i in range(a.shape[0])]
    return tuple(torch.stack(x) for x in zip(*out))


def _launch_best_two(a, b, row_ok, col_ok, big):
    out = hamming_kernel.launch_best_two(a, b, row_ok, col_ok, big)
    count(hamming_best_two, "launches",
          hamming_kernel.best_two_kernels(a.shape[0], a.shape[1], b.shape[1], a.device))
    return out


def _launch_matrix(a, b):
    out = hamming_kernel.launch_matrix(a, b)
    if hamming_kernel.launched(out):
        count(hamming_matrix, "launches")
    return out


_MIN_CROSSBAG_OP = torch.library.custom_op(
    "alvaar_tpu_torch::hamming_min_crossbag", _min_crossbag_rows, mutates_args=(),
    device_types="cpu",
    schema="(Tensor bag_a, Tensor filled_a, Tensor bag_b, Tensor filled_b) -> Tensor")
_MIN_CROSSBAG_OP.register_kernel("cuda")(_launch_min_crossbag)
_MIN_CROSSBAG_OP.register_fake(
    lambda bag_a, filled_a, bag_b, filled_b:
    bag_a.new_empty((bag_a.shape[0], bag_a.shape[1], bag_b.shape[1]), dtype=torch.float32))
_MIN_CROSSBAG_OP.register_vmap(rows_rule(_MIN_CROSSBAG_OP))

_BEST_TWO_OP = torch.library.custom_op(
    "alvaar_tpu_torch::hamming_best_two", _best_two_rows, mutates_args=(), device_types="cpu",
    schema="(Tensor a, Tensor b, Tensor row_ok, Tensor col_ok, float big) "
           "-> (Tensor, Tensor, Tensor)")
_BEST_TWO_OP.register_kernel("cuda")(_launch_best_two)
_BEST_TWO_OP.register_fake(
    lambda a, b, row_ok, col_ok, big: (a.new_empty(a.shape[:2], dtype=torch.float32),
                                       a.new_empty(a.shape[:2], dtype=torch.float32),
                                       a.new_empty(a.shape[:2], dtype=torch.int64)))
_BEST_TWO_OP.register_vmap(rows_rule(_BEST_TWO_OP))

_MATRIX_OP = torch.library.custom_op(
    "alvaar_tpu_torch::hamming_matrix", _matrix_rows, mutates_args=(), device_types="cpu",
    schema="(Tensor a, Tensor b) -> Tensor")
_MATRIX_OP.register_kernel("cuda")(_launch_matrix)
_MATRIX_OP.register_fake(lambda a, b: a.new_empty((a.shape[0], a.shape[1], b.shape[1])))
_MATRIX_OP.register_vmap(rows_rule(_MATRIX_OP))


def hamming_matrix(a, b):
    """[N, 8] x [M, 8] → [N, M] int32 Hamming distances: K4 in one launch on
    CUDA tensors, the plain version on CPU tensors."""
    if not _dispatch(a, "hamming_matrix"):
        return _hamming_matrix_plain(a, b)
    return _MATRIX_OP(one(a), one(b))[0]


def hamming_min_crossbag(bag_a, filled_a, bag_b, filled_b):
    """Minimum Hamming distance over all (desc_a, desc_b) pairs of two
    descriptor bags, bag_a [N, G, 8], filled_a [N, G]; bag_b [M, G, 8],
    filled_b [M, G] → [N, M] float32 (257 where either bag is empty): K4
    in one launch on CUDA tensors, the plain version on CPU tensors."""
    if not _dispatch(bag_a, "hamming_min_crossbag"):
        return _min_crossbag_plain(bag_a, filled_a, bag_b, filled_b)
    x = tuple(map(one, (bag_a, filled_a, bag_b, filled_b)))
    if any(map(wrapped, x)):      # under vmap: one launch over the rows, by the op's rule
        return _MIN_CROSSBAG_OP(*x)[0]
    return _launch_min_crossbag(*x)[0]


def hamming_best_two(a, b, row_ok, col_ok, big: float):
    """The loop queries' best two: for query descriptors a [N, 8] and
    database descriptors b [M, 8] (M >= 1), each row's least and second
    least distance as float32 where ``row_ok`` [N] and ``col_ok`` [M] (``big``
    elsewhere) and the first column of the least: (best [N], second [N],
    idx [N] int64), exactly ``_top2_min`` of the masked float32 matrix (a
    masked row (big, big, 0), a lone column's second inf).  K4 on CUDA
    tensors (one launch, a second for the merge across column chunks; under
    vmap one over all the rows), the plain version on CPU tensors.
    ``calls`` counts the query passes, ``launches`` the kernels they start
    (two where the merge runs)."""
    count(hamming_best_two, "calls")
    if b.shape[0] < 1:
        raise ValueError("hamming_best_two needs at least one database descriptor")
    if not _dispatch(a, "hamming_best_two"):
        return _hamming_best_two_plain(a, b, row_ok, col_ok, big)
    x = tuple(map(one, (a, b, row_ok, col_ok)))
    if any(map(wrapped, x)):      # under vmap: one launch over the rows, by the op's rule
        out = _BEST_TWO_OP(*x, float(big))
    else:
        out = _launch_best_two(*x, float(big))
    return tuple(o[0] for o in out)


hamming_matrix.launches = 0
hamming_min_crossbag.launches = 0
hamming_best_two.launches = hamming_best_two.calls = 0


def best_two(dists, valid_cols=None):
    """Best and second-best distances + best index along the last axis
    (the NNDR primitive); invalid columns are masked to a huge distance."""
    if valid_cols is not None:
        dists = torch.where(valid_cols, dists, 10 * DESC_BITS)
    top2, idx2 = top_k(-dists.to(torch.float32), 2)
    return -top2[..., 0], -top2[..., 1], idx2[..., 0]
