"""Descriptor Hamming's kernel K4 on a card against its plain versions
(skipped without one: a CUDA kernel has no CPU mode).  This file imports
neither JAX nor the JAX package, so that it runs where the card is:

    python -m pytest --noconftest tests/test_torch_hamming_kernel_card.py -q

(tests/conftest.py sets JAX up for the CPU tests.)  chip_smoke.py phase 2d
holds the same bars at more shapes; tools/rehearse_hamming_kernel.py runs
these cases on the CPU through the CUDA source.  Every bar is
bit-equality."""

import numpy as np
import pytest
import torch

from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.ops import hamming, hamming_kernel
from alvaar_tpu_torch.worldmap import matching
from hamming_problems import (BEST_TWO_KINDS, bag_problem, best_two_problem,
                              dense_problem, slice_outputs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _zero():
    hamming.hamming_min_crossbag.launches = hamming.hamming_matrix.launches = 0
    hamming.hamming_best_two.launches = hamming.hamming_best_two.calls = 0
    matching.match_to_local_map.calls = 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["matching", "scattered", "all-empty side", "extreme words"])
def test_min_crossbag_on_card(card, kind):
    """One launch at a ragged L x K (neither a multiple of the block's 32),
    bit-equal to the plain version, run to run; three rows under vmap in one
    launch, each bit-equal to its launch alone."""
    a, fa, b, fb = bag_problem(np.random.default_rng(17), 1, 1037, 201, 6, kind, card)
    _zero()
    got = hamming.hamming_min_crossbag(a[0], fa[0], b[0], fb[0])
    assert hamming.hamming_min_crossbag.launches == 1
    assert torch.equal(got, hamming._min_crossbag_plain(a[0], fa[0], b[0], fb[0]))
    assert torch.equal(got, hamming.hamming_min_crossbag(a[0], fa[0], b[0], fb[0]))
    x = bag_problem(np.random.default_rng(18), 3, 300, 130, 6, kind, card)
    _zero()
    rows = torch.func.vmap(hamming.hamming_min_crossbag)(*x)
    assert hamming.hamming_min_crossbag.launches == 1
    for i in range(3):
        assert torch.equal(rows[i], hamming.hamming_min_crossbag(*(c[i] for c in x))), i


def _one_bit_bags(flip: bool, device):
    """256 descriptors, descriptor p with only bit p set (word p // 32, bit
    p % 32), or with every bit but p when ``flip``: [1, 256, 1, 8] int32."""
    w = np.zeros((256, 8), np.uint32)
    p = np.arange(256)
    w[p, p // 32] = np.uint32(1) << (p % 32).astype(np.uint32)
    if flip:
        w = ~w
    return torch.from_numpy(w.view(np.int32).reshape(1, 256, 1, 8).copy()).to(device)


@pytest.mark.cuda
def test_min_crossbag_fragment_layout_on_card(card):
    """Single-bit descriptors pin the tensor cores' k mapping: A's bit p
    against B's bit q is 0 apart where p = q and 2 apart elsewhere, and 256
    or 254 against B's complements; a row or column read from the wrong
    fragment register, or a bit taken for another, moves a 0 or a 256."""
    a = _one_bit_bags(False, card)
    filled = torch.ones((1, 256, 1), dtype=torch.bool, device=card)
    eye = torch.eye(256, device=card)
    for flip, want in ((False, 2 - 2 * eye), (True, 254 + 2 * eye)):
        b = _one_bit_bags(flip, card)
        got = hamming.hamming_min_crossbag(a[0], filled[0], b[0], filled[0])
        assert torch.equal(got, want), flip
        assert torch.equal(got, hamming._min_crossbag_plain(a[0], filled[0], b[0], filled[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("G", range(1, 9))
def test_min_crossbag_bag_sizes_on_card(card, G):
    """Every bag size the kernel has an instance for, bit-equal to the plain
    version, alone and as two rows under vmap in one launch."""
    x = bag_problem(np.random.default_rng(30 + G), 2, 300, 77, G, "matching", card)
    _zero()
    rows = torch.func.vmap(hamming.hamming_min_crossbag)(*x)
    assert hamming.hamming_min_crossbag.launches == 1
    for i in range(2):
        row = [c[i] for c in x]
        assert torch.equal(rows[i], hamming._min_crossbag_plain(*row)), i
        assert torch.equal(rows[i], hamming.hamming_min_crossbag(*row)), i


@pytest.mark.cuda
@pytest.mark.parametrize("N, M", [(1, 1), (15, 7), (17, 9), (1037, 201), (4099, 130)])
def test_min_crossbag_ragged_on_card(card, N, M):
    """N off the 16-row tile and M off the warp's 8 columns and the block's
    32, with an A bag and a B bag that have no filled slot (257 along their
    row and column), bit-equal to the plain version."""
    a, fa, b, fb = bag_problem(np.random.default_rng(N + M), 1, N, M, 6, "scattered", card)
    fa[0, N // 2] = False
    fb[0, M - 1] = False
    got = hamming.hamming_min_crossbag(a[0], fa[0], b[0], fb[0])
    assert torch.equal(got, hamming._min_crossbag_plain(a[0], fa[0], b[0], fb[0]))
    assert bool((got[N // 2] == 257).all()) and bool((got[:, M - 1] == 257).all())


@pytest.mark.cuda
def test_loop_queries_on_card(card):
    """The loop queries' dense pass over a 256-keyframe database (49 152
    descriptors, 24 chunks on the plain path) in one launch, bit-equal to
    the plain version; four rows under vmap in one launch."""
    a, b = dense_problem(np.random.default_rng(19), 1, 192, 49152, card)
    _zero()
    got = hamming.hamming_matrix_chunked(a[0], b[0])
    assert hamming.hamming_matrix.launches == 1
    assert torch.equal(got, hamming._hamming_matrix_plain(a[0], b[0]))
    a, b = dense_problem(np.random.default_rng(20), 4, 192, 3072, card)
    _zero()
    rows = torch.func.vmap(hamming.hamming_matrix_chunked)(a, b)
    assert hamming.hamming_matrix.launches == 1
    for i in range(4):
        assert torch.equal(rows[i], hamming._hamming_matrix_plain(a[i], b[i])), i


@pytest.mark.cuda
@pytest.mark.parametrize("kind", BEST_TWO_KINDS)
@pytest.mark.parametrize("S, N, M", [(1, 192, 192), (1, 192, 3072), (1, 192, 49152),
                                     (4, 192, 3072), (1, 37, 1), (3, 352, 1037)])
def test_best_two_on_card(card, kind, S, N, M):
    """The loop queries' best two at their shapes (one entry, 16, 256
    keyframes; four rows under vmap), a lone column, ACCURATE's 352 query
    rows (two row blocks) against a ragged M: one call (one launch, two
    with the merge), bit-equal to the plain composition row by row and run
    to run."""
    x = best_two_problem(np.random.default_rng(N + M + S), S, N, M, kind, card)
    big = detector._BIG
    _zero()
    call = lambda: torch.func.vmap(hamming.hamming_best_two, in_dims=(0, 0, 0, 0, None))(
        *x, big)
    got = call()
    assert hamming.hamming_best_two.calls == 1
    assert hamming.hamming_best_two.launches == hamming_kernel.best_two_kernels(S, N, M, card)
    for i in range(S):
        want = hamming._hamming_best_two_plain(*(c[i] for c in x), big)
        for g, w in zip(got, want):
            assert g[i].dtype == w.dtype and torch.equal(g[i], w), i
    assert all(torch.equal(g, h) for g, h in zip(got, call()))


@pytest.mark.cuda
def test_slice_on_card(card):
    """``match_to_local_map``, ``detect_loop``, ``verify_loop`` and
    ``relocalize_topk`` on seeded states (tests/hamming_problems.py): the
    same outputs bit for bit with the kernel as with the plain versions, one
    launch per matching call and per loop query's best two."""
    _zero()
    got = slice_outputs(card)
    c = (hamming.hamming_min_crossbag.launches, matching.match_to_local_map.calls,
         hamming.hamming_best_two.launches, hamming.hamming_best_two.calls,
         hamming.hamming_matrix.launches)
    assert c[0] == c[1] == 2 and 0 < c[3] <= c[2] <= 2 * c[3] and c[4] == 0, c
    dispatch = hamming._dispatch
    hamming._dispatch = lambda x, name: False          # the plain versions on the card
    try:
        plain = slice_outputs(card)
    finally:
        hamming._dispatch = dispatch
    assert got.keys() == plain.keys()
    for name in got:
        assert torch.equal(got[name], plain[name]), name
