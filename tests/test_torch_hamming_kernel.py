"""Descriptor Hamming's kernel K4 (csrc/hamming.cu, ops/hamming_kernel.py):
its CUDA source run on the CPU through tools/cpu_cuda_shim.h, bit-equal to
the plain versions (ops/hamming.py) and to the JAX package's
``hamming_min_crossbag`` and ``hamming_matrix_popcount`` /
``hamming_matrix_matmul``: L and K off the tiles (16 and 32 rows, 8 and
32 columns), bags of 1 to 8 descriptors, empty bags and an all-empty side,
all-ones and all-zero words, S rows in one launch each equal to its row
alone, the persistent blocks' schedules at several multiprocessor counts;
local-map matching and the loop queries through the source, equal to the
plain path.  The loop queries' best two (the dense pass's reduction) on N
and M off the tiles, M = 1, ties at the best and the second, rows and
columns all masked, S rows in one launch, and its merge across column
chunks at 1, 3 and 200 multiprocessors, bit-equal to
``_hamming_best_two_plain``.  The tensor cores' arithmetic: both kernels'
words as ``mma.sync m16n8k256 .b1 .and.popc`` fragments, laid out by the
PTX ISA, give the Hamming distance (in numpy), and the shim's emulation of
that ``mma`` equals an int64 product of the bits.  Without building: the
custom ops' CPU implementation (the plain version), fake shapes and
batching rule, the CPU path's independence of the library, the launchers'
argument checks, and the slice's outputs on the CPU unchanged from commit
9a69178's (before K4).
tests/test_torch_hamming_kernel_card.py holds the kernel to its plain
versions on a card.

Every bar is bit-equality: a distance is an exact integer (a minimum of
popcounts, or 257 where no pair of the two bags is filled; the best two's
float32 values are such integers or the callers' 1e9)."""

import ctypes
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvaar_tpu.ops import hamming as jham
from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.ops import hamming, hamming_kernel
from alvaar_tpu_torch.utils import custom_ops
from alvaar_tpu_torch.worldmap import matching
from alvaar_tpu_torch.worldmap.state import map_rows, stack_states
import hamming_problems as hp

# hamming_problems.slice_outputs on the CPU by the port of commit 9a69178,
# whose local-map matching and loop queries ran the plain Hamming passes
SLICE_DIGEST_9A69178 = "65c4e520d4dcf281"


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    """tools/rehearse_hamming_kernel.py, and csrc/hamming.cu built with it
    for the CPU (every CUDA thread a fiber)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "rehearse_hamming_kernel.py"
    spec = importlib.util.spec_from_file_location("rehearse_hamming_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build(str(tmp_path_factory.mktemp("hamming_cpu")))


def _zero():
    hamming.hamming_min_crossbag.launches = hamming.hamming_matrix.launches = 0
    hamming.hamming_best_two.launches = hamming.hamming_best_two.calls = 0
    matching.match_to_local_map.calls = 0


def _u32(x):
    return jnp.asarray(x.numpy().view(np.uint32))


@pytest.mark.parametrize("S, N, M, G", [(1, 70, 45, 6), (1, 33, 97, 1), (3, 41, 29, 6),
                                        (1, 64, 32, 6), (2, 5, 1, 8), (1, 1, 40, 6),
                                        (1, 37, 13, 7), (2, 23, 50, 8)])
@pytest.mark.parametrize("kind", hp.KINDS)
def test_min_crossbag_source_matches_plain_and_jax(k4, S, N, M, G, kind):
    """The source's min cross-bag pass on S rows in one launch, bit-equal to
    the plain version and to the JAX package's function row by row."""
    mod, lib = k4
    x = hp.bag_problem(np.random.default_rng(N * M + G), S, N, M, G, kind)
    with mod.on_cpu(lib):
        got = hamming_kernel.launch_min_crossbag(*x)
    assert got.shape == (S, N, M) and got.dtype == torch.float32
    for i in range(S):
        row = [c[i] for c in x]
        assert torch.equal(got[i], hamming._min_crossbag_plain(*row)), i
        j = jham.hamming_min_crossbag(_u32(row[0]), jnp.asarray(row[1].numpy()), _u32(row[2]),
                                      jnp.asarray(row[3].numpy()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(j))
    if kind == "all-empty side":
        assert bool((got == 257).all())
    if kind == "extreme words" and M >= 4:
        d = got[0]
        assert float(d.min()) == 0.0 and 256.0 in d


@pytest.mark.parametrize("sms", [1, 3, 200])
def test_min_crossbag_schedules_and_empty_bags(k4, sms):
    """The persistent blocks' schedule at 1, 3 and 200 multiprocessors (a
    block's run of stages crossing from one row s to the next, or one stage
    a block): S = 3 rows with N off the 16-row tile and the 64-row stage and
    M off the warp's 8 columns, bit-equal to the plain version; an A bag
    and a B bag with no filled slot give 257 along their whole row and
    column."""
    mod, lib = k4
    a, fa, b, fb = hp.bag_problem(np.random.default_rng(sms), 3, 53, 21, 6)
    fa[1, 17] = False
    fb[2, 4] = False
    fb[0, 20] = False
    set_sms = ctypes.CDLL(lib).cpu_cuda_set_sm_count
    set_sms(sms)
    try:
        with mod.on_cpu(lib):
            got = hamming_kernel.launch_min_crossbag(a, fa, b, fb)
    finally:
        set_sms(2)
    for i in range(3):
        assert torch.equal(got[i], hamming._min_crossbag_plain(a[i], fa[i], b[i], fb[i])), i
    assert bool((got[1, 17] == 257).all()) and bool((got[2, :, 4] == 257).all())
    assert bool((got[0, :, 20] == 257).all()) and float(got.min()) < 100


@pytest.mark.parametrize("S, N, M", [(1, 37, 301), (3, 19, 70), (1, 192, 2100), (1, 1, 1)])
def test_dense_matrix_source_matches_plain_and_jax(k4, S, N, M):
    """The source's dense matrix, bit-equal to the plain version and to the
    JAX package's popcount and ±1 matrix-product formulations."""
    mod, lib = k4
    a, b = hp.dense_problem(np.random.default_rng(N + M), S, N, M)
    with mod.on_cpu(lib):
        got = hamming_kernel.launch_matrix(a, b)
    assert got.shape == (S, N, M) and got.dtype == torch.int32
    for i in range(S):
        assert torch.equal(got[i], hamming._hamming_matrix_plain(a[i], b[i])), i
        for jfn in (jham.hamming_matrix_popcount, jham.hamming_matrix_matmul):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(jfn(_u32(a[i]), _u32(b[i]))))
    if M > 1:
        assert int(got[:, 0, 0].max()) == 256    # an all-ones row against an all-zero one


def _best_two_equal(got, a, b, row_ok, col_ok, i):
    want = hamming._hamming_best_two_plain(a[i], b[i], row_ok[i], col_ok[i], detector._BIG)
    for name, g, w in zip(("best", "second", "idx"), got, want):
        assert g[i].dtype == w.dtype and torch.equal(g[i], w), (i, name)
    return want


@pytest.mark.parametrize("S, N, M, kind", [(1, 37, 301, "random"), (3, 19, 70, "random"),
                                           (1, 192, 2100, "ties"), (1, 17, 9, "ties"),
                                           (2, 33, 1, "random"), (1, 50, 40, "masked"),
                                           (3, 23, 130, "masked"), (1, 1, 1, "masked")])
def test_best_two_source_matches_plain(k4, S, N, M, kind):
    """The source's best two (the dense pass's reduction) on S rows in one
    call, bit-equal to ``_hamming_best_two_plain`` row by row: N off the
    16-row tile, M off the 8-column tile, M = 1 (a lone column's second is
    inf), ties at the best and at the second (the first column of the best
    wins), a row and all columns masked (1e9, index 0)."""
    mod, lib = k4
    x = hp.best_two_problem(np.random.default_rng(N * M + S), S, N, M, kind)
    with mod.on_cpu(lib):
        got = hamming_kernel.launch_best_two(*x, detector._BIG)
    assert [g.shape for g in got] == [(S, N)] * 3
    wants = [_best_two_equal(got, *x, i) for i in range(S)]
    if kind == "ties":
        assert any(bool((w[0] == w[1]).any()) for w in wants)
    if kind == "masked":
        assert bool((got[0][:, 0] == detector._BIG).all()) and bool((got[2][0] == 0).all())
    if M == 1:
        assert bool(torch.isinf(got[1]).all())


@pytest.mark.parametrize("sms", [1, 3, 200])
def test_best_two_merge_across_chunks(k4, sms):
    """The best two's column chunks and their merge (the second launch) at
    1, 3 and 200 multiprocessors: S = 3 rows of 53 x 1100 with ties and
    masks (2, 4 and 8 chunks with the committed tiling), and one of 5 x 20
    in one chunk, bit-equal to the plain version and to each row's call
    alone."""
    mod, lib = k4
    set_sms = ctypes.CDLL(lib).cpu_cuda_set_sm_count
    set_sms(sms)
    hamming_kernel._CHUNKS.clear()
    try:
        with mod.on_cpu(lib):
            for S, N, M, kind in ((3, 53, 1100, "ties"), (1, 5, 20, "masked")):
                x = hp.best_two_problem(np.random.default_rng(sms + M), S, N, M, kind)
                got = hamming_kernel.launch_best_two(*x, detector._BIG)
                chunks = hamming_kernel._CHUNKS[(S, N, M, None)]
                assert chunks > 1 if S == 3 and sms > 1 else chunks >= 1, chunks
                assert chunks == 1 or S == 3, chunks
                for i in range(S):
                    _best_two_equal(got, *x, i)
                    alone = hamming_kernel.launch_best_two(*(c[i:i + 1] for c in x),
                                                           detector._BIG)
                    assert all(torch.equal(g[i], o[0]) for g, o in zip(got, alone)), i
    finally:
        set_sms(2)
        hamming_kernel._CHUNKS.clear()


def test_best_two_rows_under_vmap(k4):
    """``hamming_best_two`` under ``torch.func.vmap`` on S = 3 rows: one
    launch (the op's batching rule; ``calls`` one), each row bit-equal to its
    call alone and to the plain version; a shared database (an unbatched
    argument) repeated for every row."""
    mod, lib = k4
    a, b, row_ok, col_ok = hp.best_two_problem(np.random.default_rng(12), 3, 40, 700, "ties")
    with mod.on_cpu(lib):
        _zero()
        got = torch.func.vmap(hamming.hamming_best_two, in_dims=(0, 0, 0, 0, None))(
            a, b, row_ok, col_ok, detector._BIG)
        shared = torch.func.vmap(hamming.hamming_best_two, in_dims=(0, None, 0, None, None))(
            a, b[0], row_ok, col_ok[0], detector._BIG)
        # each call is the main kernel and the merge across its column chunks
        assert hamming_kernel.best_two_kernels(3, 40, 700, a.device) == 2
        assert hamming.hamming_best_two.launches == 4 and hamming.hamming_best_two.calls == 2
        for i in range(3):
            _best_two_equal(got, a, b, row_ok, col_ok, i)
            alone = hamming.hamming_best_two(a[i], b[i], row_ok[i], col_ok[i], detector._BIG)
            assert all(torch.equal(g[i], o) for g, o in zip(got, alone)), i
            one = hamming.hamming_best_two(a[i], b[0], row_ok[i], col_ok[0], detector._BIG)
            assert all(torch.equal(g[i], o) for g, o in zip(shared, one)), i


def test_rows_in_one_launch_equal_rows_alone(k4):
    """The wrappers under ``torch.func.vmap`` on S = 3 rows: one launch each
    (the op's batching rule), each row bit-equal to its launch alone, an
    unbatched argument repeated for every row; bits equal run to run."""
    mod, lib = k4
    x = hp.bag_problem(np.random.default_rng(5), 3, 70, 45, 6)
    a, b = hp.dense_problem(np.random.default_rng(6), 3, 40, 2200)
    with mod.on_cpu(lib):
        _zero()
        got = torch.func.vmap(hamming.hamming_min_crossbag)(*x)
        dense = torch.func.vmap(hamming.hamming_matrix_chunked)(a, b)
        shared = torch.func.vmap(hamming.hamming_matrix, in_dims=(0, None))(a, b[0])
        assert hamming.hamming_min_crossbag.launches == 1
        assert hamming.hamming_matrix.launches == 2
        again = torch.func.vmap(hamming.hamming_min_crossbag)(*x)
        for i in range(3):
            assert torch.equal(got[i], hamming.hamming_min_crossbag(*(c[i] for c in x))), i
            assert torch.equal(dense[i], hamming.hamming_matrix_chunked(a[i], b[i])), i
            assert torch.equal(shared[i], hamming.hamming_matrix(a[i], b[0])), i
    assert torch.equal(got, again)


def test_slice_through_the_source_equals_the_plain_path(k4):
    """Local-map matching and the loop queries (tests/hamming_problems.py's
    seeded states) with K4's source launched on CPU tensors: every output
    bit-equal to the plain path's, one launch per matching call and per
    loop query's best two; two maps under ``map_rows`` (the batched
    keyframe phase's vmap) in one launch, each row equal to its call
    alone."""
    mod, lib = k4
    plain = hp.slice_outputs()
    with mod.on_cpu(lib):
        _zero()
        got = hp.slice_outputs()
        assert hamming.hamming_min_crossbag.launches == matching.match_to_local_map.calls == 2
        calls = hamming.hamming_best_two.calls
        assert 0 < calls <= hamming.hamming_best_two.launches <= 2 * calls
        assert hamming.hamming_matrix.launches == 0
        maps = [hp.seeded_map(seed) for seed in (0, 1)]
        cam, cfg = maps[0][1], maps[0][2]
        _zero()
        rows = map_rows(lambda s: matching.match_to_local_map(s, cam, cfg),
                        stack_states([m[0] for m in maps]))
        assert hamming.hamming_min_crossbag.launches == 1
    assert got.keys() == plain.keys()
    for name in got:
        assert torch.equal(got[name], plain[name]), name
    for i in range(2):
        for name, x in rows.tensors():
            assert torch.equal(x[i], plain[f"match {i} {name}"]), (i, name)


def test_knockouts_find_their_text(k4, tmp_path):
    """tools/hamming_knockouts.py finds each text it knocks out in the
    committed source exactly once, and every knocked-out copy still builds
    through the CPU shim, so that the card run does not fail on a moved
    line."""
    path = Path(__file__).resolve().parents[1] / "tools" / "hamming_knockouts.py"
    spec = importlib.util.spec_from_file_location("hamming_knockouts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = hamming_kernel._SRC.read_text()
    assert [name for name, _ in mod.KNOCKOUTS] == ["as committed", "no mma", "one op a key",
                                                  "neither"]
    copy = tmp_path / "neither.cu"
    copy.write_text(mod.knocked_out(src, mod.KNOCKOUTS[-1][1]))
    k4[0].cuda_on_cpu.build(str(copy), str(tmp_path))
    with pytest.raises(ValueError, match="once"):
        mod.knocked_out(src, ((mod.MMA + mod.MMA, ""),))


def test_dense_variants_through_the_source(k4, tmp_path):
    """tools/hamming_dense_variants.py's two designs of the dense pass (B
    staged by cp.async; the merge in the last block to arrive), together in
    one copy of the source through the CPU shim: the best two over several
    column chunks and stages (S = 3 rows of 53 x 1100 at 3 multiprocessors,
    2 of 19 x 3001 at one) and the dense int32 form bit-equal to the plain
    versions, so that the card's timing of them does not fail on a moved
    marker; a missing marker raises."""
    path = Path(__file__).resolve().parents[1] / "tools" / "hamming_dense_variants.py"
    spec = importlib.util.spec_from_file_location("hamming_dense_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = hamming_kernel._SRC.read_text()
    assert sorted(mod.VARIANTS) == ["staged b", "ticket"]
    copy = tmp_path / "variants.cu"
    copy.write_text(mod.edited(src, ["staged b", "ticket"]))
    lib = k4[0].cuda_on_cpu.build(str(copy), str(tmp_path))
    set_sms = ctypes.CDLL(lib).cpu_cuda_set_sm_count
    try:
        with k4[0].on_cpu(lib):
            for sms, (S, N, M) in ((3, (3, 53, 1100)), (1, (2, 19, 3001))):
                set_sms(sms)
                hamming_kernel._CHUNKS.clear()
                x = hp.best_two_problem(np.random.default_rng(sms + M), S, N, M, "ties")
                got = hamming_kernel.launch_best_two(*x, detector._BIG)
                assert hamming_kernel._CHUNKS[(S, N, M, None)] > 1
                dense = hamming_kernel.launch_matrix(x[0], x[1])
                for i in range(S):
                    _best_two_equal(got, *x, i)
                    assert torch.equal(dense[i], hamming._hamming_matrix_plain(x[0][i], x[1][i]))
    finally:
        set_sms(2)
        hamming_kernel._CHUNKS.clear()
    with pytest.raises(ValueError, match="once"):
        mod.edited(src.replace(mod.LOOP_END, ""), ["staged b"])


def test_c_entries_refuse_bad_shapes(k4):
    """The C entries take 1 to 8 descriptors a bag, 1 to 65535 rows and
    16-byte aligned bags (the dense pass: 8-byte aligned words, the best
    two M >= 1 and the scratch its chunks need), and refuse anything else
    before they launch; ``bind`` checks the library's limits against the
    wrapper's."""
    lib = hamming_kernel.bind(ctypes.CDLL(k4[1]))
    for S, G in ((1, 0), (1, 9), (0, 6), (65536, 6)):
        assert lib.hamming_min_crossbag_launch(None, None, None, None, S, 4, 4, G, None,
                                               None) != 0
    words = torch.zeros(64, dtype=torch.int32)
    p = words.data_ptr()
    assert p % 16 == 0
    for off_a, off_b in ((4, 0), (0, 8), (4, 12)):
        assert lib.hamming_min_crossbag_launch(p + off_a, None, p + off_b, None, 1, 1, 1, 1,
                                               None, None) != 0
    assert lib.hamming_min_crossbag_launch(None, None, None, None, 1, 0, 4, 6, None, None) == 0
    assert lib.hamming_matrix_launch(None, None, 0, 4, 4, None, None) != 0
    assert lib.hamming_matrix_launch(None, None, 1, 0, 4, None, None) == 0      # nothing to do
    assert lib.hamming_matrix_launch(None, None, 1, hamming_kernel.MAX_N_MATRIX + 1, 4, None,
                                     None) != 0
    assert lib.hamming_matrix_launch(p + 4, p, 1, 1, 1, p, None) != 0          # 4-byte aligned
    bt = lambda a, b, S, N, M, key=None, chunks=0: lib.hamming_best_two_launch(
        a, b, None, None, S, N, M, 1e9, None, None, None, key, key, chunks, None)
    assert bt(None, None, 1, 4, 0) != 0                                        # M = 0
    assert bt(None, None, 0, 4, 4) != 0 and bt(None, None, 1, 0, 4) == 0
    assert bt(p + 4, p, 1, 1, 1) != 0 and bt(p, p + 12, 1, 1, 1) != 0
    c = ctypes.c_int()
    assert lib.hamming_best_two_chunks(1, 192, 49152, ctypes.byref(c)) == 0 and c.value > 1
    assert bt(p, p, 1, 192, 49152) != 0                     # several chunks and no scratch
    assert bt(p, p, 1, 192, 49152, p, c.value - 1) != 0     # too little scratch


def test_bind_refuses_other_limits(k4, monkeypatch):
    """A library whose limits differ from the wrapper's is refused."""
    for name in ("MAX_BAG", "MAX_ROWS", "MAX_N_CROSSBAG", "MAX_N_MATRIX"):
        with monkeypatch.context() as m:
            m.setattr(hamming_kernel, name, getattr(hamming_kernel, name) - 1)
            with pytest.raises(RuntimeError, match="limit"):
                hamming_kernel.bind(ctypes.CDLL(k4[1]))


# ---------------------------------------------------------------------------
# The tensor cores' arithmetic: the fragments of mma.sync m16n8k256 .b1
# .and.popc and the shim's emulation of it
# ---------------------------------------------------------------------------

def _tiles(frags):
    """The PTX ISA's m16n8k256 .b1 layout of one warp's fragments:
    ``frags`` [32, 6] uint32 (a0-a3, b0, b1 of each lane, lane = 4 groupID
    + t) → A [16, 256] and B [256, 8] as their bits (int64)."""
    bits = lambda w: (int(w) >> np.arange(32)) & 1
    A = np.zeros((16, 256), np.int64)
    B = np.zeros((256, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):          # a0 / a1: rows g / g + 8 at k = 32t..; a2 / a3 at k + 128
            k = 32 * t + 128 * (r // 2)
            A[g + 8 * (r % 2), k:k + 32] = bits(frags[lane, r])
        for r in range(2):          # b0 / b1: column g at k = 32t.. and k + 128
            k = 32 * t + 128 * r
            B[k:k + 32, g] = bits(frags[lane, 4 + r])
    return A, B


def _lane_d(D):
    """[16, 8] → [32, 4]: each lane's c0-c3 (row groupID at columns 2t, 2t
    + 1, then row groupID + 8)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]], 1)


def _kernel_frags(a, b, pass_="min cross-bag"):
    """The fragments csrc/hamming.cu gives each lane for rows a [16, 8] and
    columns b [8, 8] (uint32 words), as they are: the min cross-bag pass's
    words t and t + 4 of rows groupID and groupID + 8 and of column groupID;
    the dense pass's words 2t and 2t + 1 (one 8-byte load a lane)."""
    frags = np.zeros((32, 6), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        w0, w1 = (t, t + 4) if pass_ == "min cross-bag" else (2 * t, 2 * t + 1)
        frags[lane] = [a[g, w0], a[g + 8, w0], a[g, w1], a[g + 8, w1], b[g, w0], b[g, w1]]
    return frags


@pytest.mark.parametrize("pass_", ["min cross-bag", "dense"])
def test_fragment_layout_gives_the_hamming_distance(pass_):
    """Each kernel's fragments of random words, laid out by the PTX ISA's
    m16n8k256 .b1 layout: A B counts popc(a & b) of every row and column,
    and popc(a) + popc(b) - 2 A B equals popc(a ^ b) and the JAX package's
    ``hamming_matrix_matmul``."""
    rng = np.random.default_rng(31)
    a = hp.words(rng, 16, 8).view(np.uint32)
    b = hp.words(rng, 8, 8).view(np.uint32)
    a[3] = 0xFFFFFFFF
    b[5] = a[7]
    popc = lambda w: np.unpackbits(w.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    A, B = _tiles(_kernel_frags(a, b, pass_))
    dot = A @ B
    np.testing.assert_array_equal(dot, popc(a[:, None, :] & b[None, :, :]))
    got = popc(a)[:, None] + popc(b)[None, :] - 2 * dot
    np.testing.assert_array_equal(got, popc(a[:, None, :] ^ b[None, :, :]))
    jax_d = jham.hamming_matrix_matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(jax_d), got)
    assert got[3].max() <= 256 and got[7, 5] == 0


MMA_PROBE = r"""
#include <cuda_runtime.h>

// One m16n8k256 .b1 .and.popc product a warp: lane l's a0-a3, b0, b1 at
// frags[6 l ..], its c0-c3 at c[4 l ..], its d0-d3 to d[4 l ..]; in place
// (d = c) when `alias`.
__global__ void mma_kernel(const unsigned* frags, const int* c, int* d, int alias) {
  const unsigned* f = frags + 6 * threadIdx.x;
  const unsigned a[4] = {f[0], f[1], f[2], f[3]};
  const unsigned b[2] = {f[4], f[5]};
  int acc[4] = {c[4 * threadIdx.x], c[4 * threadIdx.x + 1], c[4 * threadIdx.x + 2],
                c[4 * threadIdx.x + 3]};
  int out[4];
  if (alias) {
    cpu_cuda::mma_m16n8k256_and_popc(acc, a, b, acc);
    for (int i = 0; i < 4; ++i) out[i] = acc[i];
  } else {
    cpu_cuda::mma_m16n8k256_and_popc(out, a, b, acc);
  }
  for (int i = 0; i < 4; ++i) d[4 * threadIdx.x + i] = out[i];
}

extern "C" void run_mma(const unsigned* frags, const int* c, int* d, int warps, int alias) {
  for (int w = 0; w < warps; ++w)
    mma_kernel<<<1, 32>>>(frags + 6 * 32 * w, c + 4 * 32 * w, d + 4 * 32 * w, alias);
}
"""


@pytest.fixture(scope="module")
def mma_probe(k4, tmp_path_factory):
    out = tmp_path_factory.mktemp("mma_probe")
    src = out / "mma_probe.cu"
    src.write_text(MMA_PROBE)
    mod = k4[0]
    lib = ctypes.CDLL(mod.cuda_on_cpu.build(str(src), str(out)))
    lib.run_mma.restype = None
    lib.run_mma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return lib


@pytest.mark.parametrize("kind", ["random", "aliased", "all ones"])
def test_shim_mma_matches_an_int64_product(mma_probe, kind):
    """The shim's ``mma.sync m16n8k256 .b1 .and.popc``
    (tools/cpu_cuda_shim.h) on the fragments of three warps: each lane's d
    equals c + A B by an int64 product of the bits the PTX ISA's layout puts
    in A and B (random words; d in c's registers; every bit set, 256)."""
    rng = np.random.default_rng(41 + len(kind))
    frags = rng.integers(0, 2 ** 32, size=(3, 32, 6), dtype=np.uint64).astype(np.uint32)
    if kind == "all ones":
        frags[:] = 0xFFFFFFFF
    c = rng.integers(-2 ** 20, 2 ** 20, size=(3, 32, 4)).astype(np.int32)
    d = np.zeros((3, 32, 4), np.int32)
    mma_probe.run_mma(frags.ctypes.data, c.ctypes.data, d.ctypes.data, 3, int(kind == "aliased"))
    for w in range(3):
        A, B = _tiles(frags[w])
        np.testing.assert_array_equal(d[w], _lane_d(A @ B) + c[w])
    if kind == "all ones":
        assert bool((d == c + 256).all())


# ---------------------------------------------------------------------------
# Without building anything
# ---------------------------------------------------------------------------

def test_slice_on_the_cpu_is_unchanged():
    """On CPU tensors local-map matching and the loop queries take the plain
    versions, whose outputs on the seeded states are commit 9a69178's bit
    for bit (the digest of everything they return), and the wrappers never
    load the library or count a launch."""
    _zero()
    lib, load = hamming_kernel._lib, hamming_kernel._load
    hamming_kernel._load = lambda: pytest.fail("the CPU path loaded the kernel's library")
    try:
        out = hp.slice_outputs()
    finally:
        hamming_kernel._load = load
    assert hamming_kernel._lib is lib is None
    assert hp.digest(out) == SLICE_DIGEST_9A69178
    assert hamming.hamming_min_crossbag.launches == hamming.hamming_matrix.launches == 0
    assert hamming.hamming_best_two.launches == 0
    assert matching.match_to_local_map.calls == 2 and hamming.hamming_best_two.calls > 0


def test_op_cpu_implementation_is_the_plain_version():
    """The custom ops on CPU tensors equal the plain versions row by row,
    and the wrappers on CPU tensors are the plain versions."""
    x = hp.bag_problem(np.random.default_rng(1), 2, 50, 37, 6)
    a, b = hp.dense_problem(np.random.default_rng(2), 2, 30, 41)
    op = hamming._MIN_CROSSBAG_OP(*x)
    dense = hamming._MATRIX_OP(a, b)
    for i in range(2):
        row = [c[i] for c in x]
        assert torch.equal(op[i], hamming._min_crossbag_plain(*row))
        assert torch.equal(op[i], hamming.hamming_min_crossbag(*row))
        assert torch.equal(dense[i], hamming._hamming_matrix_plain(a[i], b[i]))
        assert torch.equal(dense[i], hamming.hamming_matrix(a[i], b[i]))
        assert torch.equal(dense[i], hamming.hamming_matrix_chunked(a[i], b[i], 16))


def test_best_two_op_cpu_fake_shapes_and_vmap_rule():
    """The best-two op on CPU tensors equals the plain version row by row
    (and the wrapper on CPU tensors is the plain version), its fake outputs
    have the real ones' shapes and dtypes, and under ``torch.func.vmap`` it
    runs once over the rows, equal to single calls bit for bit."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = hp.best_two_problem(np.random.default_rng(13), 3, 21, 37, "ties")
    big = detector._BIG
    op = hamming._BEST_TWO_OP(*x, big)
    for i in range(3):
        row = [c[i] for c in x]
        want = hamming._hamming_best_two_plain(*row, big)
        for got in ([o[i] for o in op], hamming.hamming_best_two(*row, big)):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), i
    mode = FakeTensorMode()
    with mode:
        fake = hamming._BEST_TWO_OP(*(mode.from_tensor(t) for t in x), big)
    assert [(tuple(f.shape), f.dtype) for f in fake] == [(tuple(o.shape), o.dtype) for o in op]

    def one_row(a, b, row_ok, col_ok):
        return tuple(o[0] for o in hamming._BEST_TWO_OP(a[None], b[None], row_ok[None],
                                                        col_ok[None], big))

    got = torch.func.vmap(one_row, in_dims=(0, None, 0, None))(x[0], x[1][0], x[2], x[3][0])
    for i in range(3):
        alone = one_row(x[0][i], x[1][0], x[2][i], x[3][0])
        assert all(torch.equal(g[i], o) for g, o in zip(got, alone)), i


def test_op_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = hp.bag_problem(np.random.default_rng(3), 2, 20, 11, 6)
    a, b = hp.dense_problem(np.random.default_rng(4), 2, 9, 13)
    mode = FakeTensorMode()
    for op, args in ((hamming._MIN_CROSSBAG_OP, x), (hamming._MATRIX_OP, (a, b))):
        real = op(*args)
        with mode:
            got = op(*(mode.from_tensor(t) for t in args))
        assert (tuple(got.shape), got.dtype) == (tuple(real.shape), real.dtype)


def test_op_vmap_rule_equals_rows():
    """Under ``torch.func.vmap`` the ops run once over the rows (their
    batching rule); the result equals single calls bit for bit, an unbatched
    argument (B's bags shared by every row) included."""
    x = hp.bag_problem(np.random.default_rng(7), 3, 25, 19, 6)
    a, b = hp.dense_problem(np.random.default_rng(8), 3, 12, 17)

    def crossbag(bag_a, filled_a, bag_b, filled_b):
        return hamming._MIN_CROSSBAG_OP(*(t[None] for t in (bag_a, filled_a, bag_b,
                                                             filled_b)))[0]

    def dense(p, q):
        return hamming._MATRIX_OP(p[None], q[None])[0]

    got = torch.func.vmap(crossbag, in_dims=(0, 0, None, None))(x[0], x[1], x[2][0], x[3][0])
    got_d = torch.func.vmap(dense)(a, b)
    for i in range(3):
        assert torch.equal(got[i], crossbag(x[0][i], x[1][i], x[2][0], x[3][0])), i
        assert torch.equal(got_d[i], dense(a[i], b[i])), i


def test_launchers_refuse_cpu_tensors_and_bad_arguments():
    """The launchers run on CUDA tensors only and check dtypes, shapes,
    contiguity, devices, the bag size and the bags' 16-byte alignment
    before anything is built."""
    a, fa, b, fb = (t[0] for t in hp.bag_problem(np.random.default_rng(9), 1, 8, 6, 6))
    one = custom_ops.one
    with pytest.raises(ValueError, match="CUDA"):
        hamming_kernel.launch_min_crossbag(one(a), one(fa), one(b), one(fb))
    with pytest.raises(ValueError, match="CUDA"):
        hamming_kernel.launch_matrix(one(a[:, 0]), one(b[:, 0]))
    bad = [
        ((one(a).long(), one(fa), one(b), one(fb)), TypeError),                 # int64 words
        ((one(a), one(fa).int(), one(b), one(fb)), TypeError),                  # int masks
        ((one(a[..., :7].contiguous()), one(fa), one(b), one(fb)), ValueError), # 7 words
        ((one(a), one(fa), one(b[:, :5]), one(fb[:, :5])), ValueError),         # G differs
        ((one(a), one(fa), one(b).transpose(1, 2).contiguous().transpose(1, 2), one(fb)),
         ValueError),                                                           # strided
        ((one(a), one(fa), one(b).to("meta"), one(fb)), ValueError),            # two devices
        ((a, fa, b, fb), ValueError),                                           # no S
        ((a.new_zeros(0, 8, 6, 8), fa.new_zeros(0, 8, 6), b.new_zeros(0, 6, 6, 8),
          fb.new_zeros(0, 6, 6)), ValueError),                                  # S = 0
        ((one(a.repeat(1, 2, 1)[:, :9]), one(fa.repeat(1, 2)[:, :9]), one(b.repeat(1, 2, 1)[:, :9]),
          one(fb.repeat(1, 2)[:, :9])), ValueError),                            # G = 9
        ((a.new_zeros(a.numel() + 1)[1:].view(1, *a.shape), one(fa), one(b), one(fb)),
         ValueError),                                                           # 4-byte aligned
    ]
    for args, err in bad:
        with pytest.raises(err):
            hamming_kernel.launch_min_crossbag(*args)
    for args, err in (((one(a[:, 0]).long(), one(b[:, 0])), TypeError),
                      ((one(a[:, 0]), b[:, 0]), ValueError),
                      ((one(a[:, 0]), one(b[:, 0, :4].contiguous())), ValueError)):
        with pytest.raises(err):
            hamming_kernel.launch_matrix(*args)
    qa, qb, ro, co = (one(t[0]) for t in hp.best_two_problem(np.random.default_rng(9), 1, 8, 6))
    with pytest.raises(ValueError, match="CUDA"):
        hamming_kernel.launch_best_two(qa, qb, ro, co, 1e9)
    for args, err in (((qa, qb, ro.int(), co), TypeError),                     # int mask
                      ((qa, qb, ro, co[:, :5]), ValueError),                   # col_ok short
                      ((qa, qb[:, :0], ro, co[:, :0]), ValueError),            # M = 0
                      ((qa, qb.new_zeros(qb.numel() + 1)[1:].view(qb.shape), ro, co),
                       ValueError)):                                           # 4-byte aligned
        with pytest.raises(err):
            hamming_kernel.launch_best_two(*args, 1e9)
    with pytest.raises(ValueError, match="at least one"):
        hamming.hamming_best_two(qa[0], qb[0, :0], ro[0], co[0, :0], 1e9)
    assert hamming_kernel._lib is None


def test_dispatch_raises_on_other_devices():
    a, fa, b, fb = (t[0].to("meta") for t in hp.bag_problem(np.random.default_rng(10), 1, 4, 3,
                                                              6))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hamming.hamming_min_crossbag(a, fa, b, fb)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hamming.hamming_matrix_chunked(a[:, 0], b[:, 0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hamming.hamming_best_two(a[:, 0], b[:, 0], fa[:, 0], fb[:, 0], 1e9)
