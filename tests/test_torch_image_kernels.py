"""The image kernels K7 (gray conversion, pyramid), K5 (grid Shi-Tomasi
detection), K3 (ORB describe) and K8 (CLAHE) of csrc/image_kernels.cu
(ops/image_kernels.py): the CUDA source run on the CPU through
tools/cpu_cuda_shim.h, held to the plain versions (ops/image.py,
ops/detect.py, ops/orb.py) and to the JAX package's functions at
tests/test_torch_features.py's and tests/test_torch_geom_image.py's bars:
96x128, 97x121 and 240x320 frames, cells 24 / 40 / 50 with partial cells
(a one-pixel corner cell whose second peak is -inf), 0 and 40 live
keypoints, a constant image and 8 x 8 blocks (ties), keypoints on and past
the image's edges, S rows in one launch each equal to its row alone,
``describe_and_detect`` on a seeded keyframe through the source; K7's
pyramid kernel at 641x481, 7x5, 3x3, 1x1 and a stack of 3, 3 and 4
levels; K5's traps (a one-pixel last column of cells and a two-pixel last
row, hd_serving()'s cell 96, a response tile in global scratch, NaN and
+-inf pixels, more live keypoints than threads); K3 at both of its widths
(4 or 1 warps a keypoint) with a last block part full and all-invalid
rows, and the keyframe pass's one ``describe`` call equal to its two; K8
at ``ip.CLAHE_CASES`` (96x128 and 120x160, 8 and 4 tiles, a dark band with
pixels at 0, 255 and half-integer ties, a constant image, zeros in tiles of
1 and 2 pixels) at clips 3.0 and 2.7, a stack of 3 equal row by row to its
lone calls, both versions against the JAX package's ``clahe``; K8 at
``ip.CLAHE_LAYOUT_CASES`` (a tile side that is not a multiple of 4,
inputs not 16-byte aligned, a constant 640x480, an 8192 x 2 tile), and at
every case on a device of 132 multiprocessors (more bands of rows a tile
in the pixel kernel); the shim's ``__ballot_sync``, ``__any_sync``, bf16
rounding and the warp primitives K3 and K8 use.  Without building: the custom
ops' CPU implementation (the plain version), fake shapes and batching
rule, the CPU path's independence of the library (the golden run's first
16 frames, tests/golden/torch_step_320.npz, unchanged), the launchers'
argument checks.  tests/test_torch_image_kernels_card.py holds the kernels
to their plain versions on a card.

The bars: K7 and K5 bit-equal to their plain versions, K5's response too
(on the CPU with IEEE's square root, tests/image_problems.py ``ieee_sqrt``:
a CPU torch with MKL rounds ``torch.sqrt`` otherwise, the card does not);
K3's angles within 2e-5 rad and its words bit-equal at every keypoint
whose plain angle lies more than 1e-4 rad from a steering bin's edge; K8's
tables and output bit-equal at clip 3.0, within ``ip.CLAHE_ATOL`` at 2.7,
and both within it of the JAX package's ``clahe``."""

import ctypes
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_problems as ip
import test_torch_image_kernels_card as card_tests
from alvaar_tpu.ops import detect as jdet
from alvaar_tpu.ops import image as jimg
from alvaar_tpu.ops import orb as jorb
from alvaar_tpu_torch.ops import detect, image, image_kernels, orb
from alvaar_tpu_torch.utils import custom_ops

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def k357(tmp_path_factory):
    """tools/rehearse_image_kernels.py, and csrc/image_kernels.cu built with
    it for the CPU (every CUDA thread a fiber)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "rehearse_image_kernels.py"
    spec = importlib.util.spec_from_file_location("rehearse_image_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build(str(tmp_path_factory.mktemp("image_cpu")))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(desc):
    return desc.numpy().view(np.uint32)


# (W, H, cell, live keypoints, image, against JAX too):
# tests/test_torch_image_kernels_card.py's ``image_of`` kinds; the JAX
# package's detect_grid compiles op by op for each shape (~7 s), so two
# shapes with partial cells are held to it
DETECT_CASES = [(128, 96, 24, 0, "scene", False), (128, 96, 24, 40, "scene", False),
                (121, 97, 24, 10, "scene", True), (128, 96, 40, 40, "scene", False),
                (320, 240, 40, 0, "scene", False), (320, 240, 50, 40, "scene", True),
                (320, 240, 24, 40, "scene", False), (128, 96, 40, 0, "constant", False),
                (121, 97, 24, 10, "blocks", False)]


@pytest.mark.parametrize("W, H, cell, n_live, kind, against_jax", DETECT_CASES)
def test_detect_source_matches_plain_and_jax(k357, W, H, cell, n_live, kind, against_jax):
    """The source's two launches bit-equal to the plain version (xy,
    score, valid, new quality and the response); where marked, the JAX
    package's ``detect_grid`` at tests/test_torch_features.py's bars."""
    mod, lib = k357
    img = card_tests.image_of(kind, W, H)
    ex, exv = ip.existing(np.random.default_rng(W + n_live), n_live, W, H)
    args = dict(cell=cell, border=8, quality=0.001)
    with mod.on_cpu(lib):
        xy, score, valid, nq, resp = image_kernels.launch_detect(
            _t(img)[None], _t(ex)[None], _t(exv)[None], 0.001, cell, 8)
    with ip.ieee_sqrt():
        plain = detect._detect_grid_plain(_t(img), _t(ex), _t(exv), **args)
        plain_resp = detect.shi_tomasi_response(_t(img))
    C = -(-H // cell) * -(-W // cell)
    assert xy.shape == (1, C, 2) and valid.dtype == torch.bool and nq.shape == (1,)
    for got, want in ((xy, plain.xy), (score, plain.score), (valid, plain.valid),
                      (nq[0], plain.new_quality), (resp[0], plain_resp)):
        assert torch.equal(got[0] if got.dim() > want.dim() else got, want)
    if kind == "constant":
        assert not bool(valid.any())            # every response 0: no corner passes
    if not against_jax:
        return
    j = jdet.detect_grid(jnp.asarray(img), jnp.asarray(ex), jnp.asarray(exv), **args)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(valid[0].numpy(), jv)
    np.testing.assert_allclose(xy[0].numpy()[jv], np.asarray(j.xy)[jv], atol=1e-4, rtol=0)
    np.testing.assert_allclose(score[0].numpy(), np.asarray(j.score), rtol=1e-4, atol=1e-9)
    assert float(nq[0]) == pytest.approx(float(j.new_quality), rel=1e-6)


@pytest.mark.parametrize("W, H", [(128, 96), (320, 240), (121, 97)])
@pytest.mark.parametrize("blur", [True, False])
def test_describe_source_matches_plain_and_jax(k357, W, H, blur):
    """The source in one launch at the frame's detections and at keypoints
    on, near and past its edges: K3's bar against the plain version, and
    the JAX package's ``describe``: words bit-equal outside the bin margin,
    angles within 1e-4 (tests/test_torch_features.py's bar for the plain
    version) or, where the plain version itself is farther from JAX's (its
    moments summed in another order: 1.1e-4 rad at one unblurred keypoint
    of the 121x97 frame, moments ~1e3), within the plain version's
    distance plus K3's bar."""
    mod, lib = k357
    img = ip.frame(W, H, seed=5)
    d = detect._detect_grid_plain(_t(img), torch.zeros(0, 2), torch.zeros(0, dtype=torch.bool),
                                  cell=24, border=8)
    rng = np.random.default_rng(W)
    xy = np.concatenate([d.xy[d.valid].numpy(), ip.keypoints(rng, 40, W, H)])
    valid = rng.random(len(xy)) < 0.9
    with mod.on_cpu(lib):
        desc, angle = image_kernels.launch_describe(
            _t(img)[None], _t(xy)[None], _t(valid)[None],
            _t(orb._TAP_PAIRS), blur)
    pd, pa = orb._describe_plain(_t(img), _t(xy), _t(valid), blur=blur)
    assert float((angle[0] - pa).abs().max()) <= ip.ANGLE_BAR
    inside, off, _ = ip.words_outside_margin(desc[0], pd, pa)
    assert off == 0
    assert bool((desc[0][~_t(valid)] == 0).all())
    jd, ja = jorb.describe(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid), blur=blur)
    ja = np.asarray(ja)
    bar = np.maximum(1e-4, np.abs(pa.numpy() - ja) + ip.ANGLE_BAR)
    assert (np.abs(angle[0].numpy() - ja) <= bar).all()
    far = ip.bin_margin(pa.numpy()) > ip.BIN_MARGIN
    np.testing.assert_array_equal(_u32(desc[0])[far], np.asarray(jd)[far])


# (N, blur) of test_describe_keypoint_counts_through_the_source → the
# keypoints whose float32 moment sums lie farther from the float64 angle
# than a bar (the moments summed in float64 beside): at N = 513 with blur,
# keypoint 273 at (119.75, 50.24), moments (154.72, -50.25), which nearly
# cancel: the plain version's angle lies 2.4e-5 rad from the float64 one,
# the JAX package's 1.5e-3; and keypoint 402 at (75.34, 64.13), moments
# (-919.75, -1193.43), where the JAX package's lies 1.1e-4 rad off (the
# plain version's 2.8e-6).  K3 lies within 5e-7 rad of the float64 angles
# at both.
PLAIN_ANGLE_OFF = {(513, True): [273]}
JAX_ANGLE_OFF = {(513, True): [273, 402]}


@pytest.mark.parametrize("N", [0, 1, 33, 385, 513])
def test_describe_keypoint_counts_through_the_source(k357, N):
    """The source at keypoint counts that leave a last block part full, in
    one launch over two rows of a 121x97 frame, so at both of K3's widths
    (2 N keypoints: 4 warps a keypoint up to 1024, one keypoint a block,
    N = 1, 33, 385; 1 warp past it, four a block, N = 513 with one keypoint
    in its last block): row 0 with 90% valid keypoints (the image's
    corners, edge midpoints, points past the edges and at half-pixel ties
    among them), row 1 the same keypoints all invalid; blur on and off.
    The angles within ``ANGLE_BAR`` of the float64 angles computed in numpy
    from the image (``image_problems.float64_angles``, what K3 computes by
    design) at every keypoint, within ``ANGLE_BAR`` of the plain version's
    and within 1e-4 of the JAX package's (the bar of
    ``test_describe_source_matches_plain_and_jax``) but at the keypoints
    ``PLAIN_ANGLE_OFF`` and ``JAX_ANGLE_OFF`` name; the words bit-equal to
    the plain version's outside the bin margin and to the JAX package's
    there too; row 1's words all zero and its angles bit-equal to row 0's
    (validity only zeroes words)."""
    mod, lib = k357
    W, H = 121, 97
    img = ip.frame(W, H, seed=3)
    rng = np.random.default_rng(N)
    xy = ip.keypoints(rng, N, W, H)
    valid = np.stack([rng.random(N) < 0.9, np.zeros(N, bool)])
    for blur in (True, False):
        with mod.on_cpu(lib):
            desc, angle = image_kernels.launch_describe(
                _t(np.stack([img, img])), _t(np.stack([xy, xy])), _t(valid),
                _t(orb._TAP_PAIRS), blur)
        assert desc.shape == (2, N, 8) and angle.shape == (2, N)
        if N == 0:
            continue
        pd, pa = orb._describe_plain(_t(img), _t(xy), _t(valid[0]), blur=blur)
        got, pa = angle[0].numpy(), pa.numpy()
        assert (np.abs(got - ip.float64_angles(img, xy, blur)) <= ip.ANGLE_BAR).all()
        held = np.ones(N, bool)
        held[PLAIN_ANGLE_OFF.get((N, blur), [])] = False
        assert (np.abs(got - pa)[held] <= ip.ANGLE_BAR).all()
        inside, off, _ = ip.words_outside_margin(desc[0], pd, _t(pa))
        assert off == 0
        assert bool((desc[0][~_t(valid[0])] == 0).all()) and bool((desc[1] == 0).all())
        assert torch.equal(angle[1], angle[0])
        jd, ja = jorb.describe(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid[0]),
                               blur=blur)
        held = np.ones(N, bool)
        held[JAX_ANGLE_OFF.get((N, blur), [])] = False
        assert (np.abs(got - np.asarray(ja))[held] <= 1e-4).all()
        far = ip.bin_margin(pa) > ip.BIN_MARGIN
        np.testing.assert_array_equal(_u32(desc[0])[far], np.asarray(jd)[far])


@pytest.mark.parametrize("path", ["source", "plain"])
@pytest.mark.parametrize("blur", [True, False])
def test_describe_one_call_equals_two(k357, path, blur):
    """The keyframe pass's one call over the tracked keypoints and the new
    detections equals its two calls (the JAX package's) bit for bit, words
    and angles: through the source (one launch against two) and through
    ``_describe_plain`` (one blur of the image, each keypoint's moments
    summed in an order that does not depend on N), at 320x240 with 40
    tracked keypoints (edges among them) and a cell-24 detection's 130."""
    mod, lib = k357
    W, H = 320, 240
    img = _t(ip.frame(W, H, index=2))
    d = detect._detect_grid_plain(img, torch.zeros(0, 2), torch.zeros(0, dtype=torch.bool),
                                  cell=24, border=8)
    rng = np.random.default_rng(11)
    tracked = _t(ip.keypoints(rng, 40, W, H))
    tracked_valid = _t(rng.random(40) < 0.8)
    xy = torch.cat([tracked, d.xy])
    valid = torch.cat([tracked_valid, d.valid])
    if path == "source":
        with mod.on_cpu(lib):
            card_tests._zero()
            one = orb.describe(img, xy, valid, blur=blur)
            two = [orb.describe(img, tracked, tracked_valid, blur=blur),
                   orb.describe(img, d.xy, d.valid, blur=blur)]
            assert orb.describe.launches == 3
    else:
        one = orb._describe_plain(img, xy, valid, blur=blur)
        two = [orb._describe_plain(img, tracked, tracked_valid, blur=blur),
               orb._describe_plain(img, d.xy, d.valid, blur=blur)]
    for k in range(2):
        assert torch.equal(one[k], torch.cat([two[0][k], two[1][k]])), k


@pytest.mark.parametrize("shape", [(120, 160), (61, 83), (1, 5)])
def test_pyramid_and_gray_source_match_plain_and_jax(k357, shape):
    """K7's one pyramid launch and its gray conversion (u8 RGBA, u8 RGB,
    float32 RGBA) bit-equal to the plain versions, and to the JAX
    package's ``build_pyramid`` and ``rgba_to_gray`` at
    tests/test_torch_geom_image.py's bar (1e-4)."""
    mod, lib = k357
    rng = np.random.default_rng(shape[1])
    img = rng.uniform(0, 255, shape).astype(np.float32)
    rgba = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
    with mod.on_cpu(lib):
        card_tests._zero()
        pyr = image.build_pyramid(_t(img), 3)
        grays = [image.rgba_to_gray(x) for x in (_t(rgba), _t(rgba[..., :3]),
                                                  _t(rgba).float() + 0.5)]
        assert image.build_pyramid.launches == 1 and image.pyr_down.launches == 0
        assert image.rgba_to_gray.launches == 3
    want = [_t(img)]
    for _ in range(2):
        want.append(image._pyr_down_plain(want[-1]))
    for a, b, j in zip(pyr, want, jimg.build_pyramid(jnp.asarray(img), 3)):
        assert a.shape == b.shape == j.shape and torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=1e-4, rtol=0)
    for g, x in zip(grays, (_t(rgba), _t(rgba[..., :3]), _t(rgba).float() + 0.5)):
        assert torch.equal(g, image._rgba_to_gray_plain(x))
    np.testing.assert_allclose(grays[0].numpy(), np.asarray(jimg.rgba_to_gray(jnp.asarray(rgba))),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("dtype, channels", [(torch.uint8, 4), (torch.uint8, 3),
                                             (torch.float32, 3), (torch.float32, 4)])
def test_gray_wide_loads_and_tails_through_the_source(k357, dtype, channels, offset):
    """K7's gray conversion, four pixels a thread from whole words, at pixel
    counts off the four (1, 3, 5, 1023: the last pixels % 4 by the kernel's
    own scalar path), a stack of 3 frames, and 128 x 161 (more groups of
    four than the shim's grid of 16 blocks covers in one stride), with the
    frame's first byte at a 16-byte boundary or 4 bytes past one (the
    frame's loads then a channel at a time, but u8 RGB's 4-byte words):
    bit-equal to ``_rgba_to_gray_plain``."""
    mod, lib = k357
    rng = np.random.default_rng(channels + offset)
    size = torch.tensor([], dtype=dtype).element_size()
    with mod.on_cpu(lib):
        for shape in ((1, 1), (1, 3), (1, 5), (31, 33), (3, 29, 37), (128, 161)):
            n = int(np.prod(shape)) * channels
            vals = (rng.integers(0, 256, n) if dtype == torch.uint8
                    else rng.uniform(-10.0, 300.0, n)).astype(np.float32)
            buf = torch.zeros(n + offset // size, dtype=dtype)
            x = buf[offset // size:].view(shape + (channels,))
            x.copy_(torch.from_numpy(vals).view(shape + (channels,)).to(dtype))
            assert x.data_ptr() % 16 == offset
            card_tests._zero()
            got = image.rgba_to_gray(x)
            assert image.rgba_to_gray.launches == 1
            assert torch.equal(got, image._rgba_to_gray_plain(x)), shape


@pytest.mark.parametrize("name", list(card_tests.CARD_CASES))
def test_card_cases_through_the_source(k357, name):
    """The card tests' cases with the source launched on CPU tensors:
    ``detect_grid``, ``describe`` (blurred and not) through the wrappers,
    lone calls straight to the launcher."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.test_detect_and_describe_on_card(CPU, name)


def test_rows_in_one_launch_equal_rows_alone(k357):
    """The wrappers under ``torch.func.vmap`` on S = 3 rows: K5's two
    launches and K3's one for all the rows (the ops' batching rule), each
    row bit-equal to its call alone, an unbatched argument repeated; and
    K7 on stacks."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.test_rows_under_vmap_on_card(CPU)
        card_tests.test_pyramid_and_gray_on_card(CPU)


def test_describe_and_detect_through_the_source(k357):
    """``describe_and_detect`` (the keyframe pass's detection and its one
    description of the tracked and the new keypoints) on a seeded keyframe
    (tests/hamming_problems.py's map over a rendered 320x240 frame's
    pyramid) with the sources launched: one K3 launch a pass, every field
    of the state bit-equal to the plain path's; two maps under ``map_rows``
    (the batched keyframe pass's vmap) in one launch of each kernel, each
    row equal to its call alone."""
    import hamming_problems as hp
    from alvaar_tpu_torch.worldmap.keyframe import describe_and_detect
    from alvaar_tpu_torch.worldmap.state import map_rows, stack_states
    mod, lib = k357
    maps = [hp.seeded_map(seed) for seed in (0, 1)]
    cam, cfg = maps[0][1], maps[0][2]
    pyrs = [image.build_pyramid(_t(ip.frame(320, 240, index=i)), cfg.pyramid_levels)
            for i in (1, 2)]
    with ip.ieee_sqrt():
        plain = [describe_and_detect(m[0], p, cam, cfg) for m, p in zip(maps, pyrs)]
    with mod.on_cpu(lib):
        card_tests._zero()
        got = [describe_and_detect(m[0], p, cam, cfg) for m, p in zip(maps, pyrs)]
        assert detect.detect_grid.launches == 2 * 2
        assert orb.describe.launches == 2
        card_tests._zero()
        stack = torch.stack(pyrs[0][0:1] + pyrs[1][0:1])
        rows = map_rows(lambda s, img: describe_and_detect(s, (img,), cam, cfg),
                        stack_states([m[0] for m in maps]), stack)
        assert detect.detect_grid.launches == 2
        assert orb.describe.launches == 1
    for g, p in zip(got, plain):
        for (name, x), (_, y) in zip(g.tensors(), p.tensors()):
            assert torch.equal(x, y), name
    for i in range(2):
        for (name, x), (_, y) in zip(rows.tensors(), got[i].tensors()):
            assert torch.equal(x[i], y), (i, name)


@pytest.mark.parametrize("name, shape, levels", card_tests.PYRAMID_CASES)
def test_fused_pyramid_source_matches_plain_and_jax(k357, name, shape, levels):
    """K7's pyramid kernel through the source: one launch per two levels
    below level 0 (3 levels in one, 4 in two), each level contiguous and
    bit-equal to ``_pyr_down_plain`` applied level by level and to the JAX
    package's ``build_pyramid`` row by row (op by op on the CPU, equal to
    the bit); ``pyr_down`` alone in one launch."""
    mod, lib = k357
    with mod.on_cpu(lib):
        x, pyr = card_tests.check_pyramid(shape, levels, CPU)
    rows = x[None] if x.dim() == 2 else x
    for b in range(rows.shape[0]):
        jp = jimg.build_pyramid(jnp.asarray(rows[b].numpy()), levels)
        for a, j in zip(pyr, jp):
            np.testing.assert_array_equal((a if x.dim() == 2 else a[b]).numpy(), np.asarray(j))


@pytest.mark.parametrize("name", list(card_tests.TRAP_CASES))
def test_detect_traps_through_the_source(k357, name):
    """K5's traps (tests/test_torch_image_kernels_card.py ``TRAP_CASES``)
    through the source, bit-equal to the plain version with a float and a
    tensor threshold; the finite ones against the JAX package's
    ``detect_grid`` at tests/test_torch_features.py's bars where the JAX
    side compiles quickly (the one-pixel column and cell 96)."""
    mod, lib = k357
    with mod.on_cpu(lib):
        got = card_tests.check_detect_trap(name, CPU)
    W, H, cell, n_live, kind = card_tests.TRAP_CASES[name]
    if kind != "scene" or cell > 96:
        return
    img, ex, exv, _ = card_tests.detect_case(name, CPU)
    j = jdet.detect_grid(jnp.asarray(img.numpy()), jnp.asarray(ex.numpy()),
                         jnp.asarray(exv.numpy()), cell=cell, border=8, quality=0.001)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_allclose(got.xy.numpy()[jv], np.asarray(j.xy)[jv], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(j.score), rtol=1e-4, atol=1e-9)


PROBE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Lane l of a warp of `lanes` votes pred[l]; lanes past `early` return
// before the vote's result is read by the others.
__global__ void ballot_kernel(const int* pred, unsigned* out) {
  const unsigned v = __ballot_sync(0xFFFFFFFFu, pred[threadIdx.x] != 0);
  out[threadIdx.x] = v;
}

// Lane l votes pred[l] in __any_sync; each lane returns right after it.
__global__ void any_kernel(const int* pred, int* out) {
  out[threadIdx.x] = __any_sync(0xFFFFFFFFu, pred[threadIdx.x] != 0);
}

__global__ void bf16_kernel(const float* x, float* y, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = __bfloat162float(__float2bfloat16_rn(x[i]));
}

extern "C" void run_ballot(const int* pred, unsigned* out, int lanes) {
  ballot_kernel<<<1, lanes>>>(pred, out);
}

extern "C" void run_any(const int* pred, int* out, int lanes) { any_kernel<<<1, lanes>>>(pred, out); }

extern "C" void run_bf16(const float* x, float* y, int n) { bf16_kernel<<<1, 64>>>(x, y, n); }

// kind 0: a float64 xor butterfly of x[lane] (every lane its warp's sum);
// 1: __shfl_sync broadcast of lane 5's x; 2: lanes write shared memory,
// __syncwarp, then read their neighbour's; 3: __ldg of x[lane]; 4: a
// float64 inclusive scan by __shfl_up_sync.
__global__ void warp_kernel(int kind, const double* x, double* out) {
  __shared__ double s[64];
  const int lane = threadIdx.x % 32;
  double v = x[threadIdx.x];
  if (kind == 0) {
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, m);
  } else if (kind == 1) {
    v = __shfl_sync(0xFFFFFFFFu, v, 5);
  } else if (kind == 2) {
    s[threadIdx.x] = v * 2.0;
    __syncwarp();
    v = s[threadIdx.x - lane + (lane + 1) % 32];
  } else if (kind == 3) {
    v = __ldg(x + threadIdx.x);
  } else {
    for (int d = 1; d < 32; d <<= 1) {
      const double y = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d) v += y;
    }
  }
  out[threadIdx.x] = v;
}

extern "C" void run_warp(int kind, const double* x, double* out, int lanes) {
  warp_kernel<<<1, lanes>>>(kind, x, out);
}

"""


@pytest.fixture(scope="module")
def probe(k357, tmp_path_factory):
    out = tmp_path_factory.mktemp("image_probe")
    src = out / "image_probe.cu"
    src.write_text(PROBE)
    lib = ctypes.CDLL(k357[0].cuda_on_cpu.build(str(src), str(out)))
    lib.run_ballot.restype = lib.run_bf16.restype = lib.run_any.restype = None
    lib.run_ballot.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.run_any.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.run_bf16.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.run_warp.restype = None
    lib.run_warp.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


@pytest.mark.parametrize("lanes", [32, 64, 48])
def test_shim_ballot(probe, lanes):
    """The shim's ``__ballot_sync``: every lane of a warp gets the warp's
    votes, bit l from lane l (a partial last warp: its lanes only), though
    lanes return as soon as they have voted."""
    rng = np.random.default_rng(lanes)
    pred = (rng.random(lanes) < 0.5).astype(np.int32)
    out = np.zeros(lanes, np.uint32)
    probe.run_ballot(pred.ctypes.data, out.ctypes.data, lanes)
    for w in range(0, lanes, 32):
        p = pred[w:w + 32]
        want = sum(int(b) << i for i, b in enumerate(p))
        assert (out[w:w + 32] == want).all(), w


@pytest.mark.parametrize("lanes", [32, 64, 48])
def test_shim_any_sync(probe, lanes):
    """The shim's ``__any_sync``: every lane of a warp gets whether any of
    its lanes voted true, the last lane's vote included, though lanes
    return as soon as they have voted (a vote by lane 31 alone, by lane 0
    alone, by none)."""
    for which in (31, 0, None):
        pred = np.zeros(lanes, np.int32)
        if which is not None:
            pred[which::32] = 1
        out = np.full(lanes, -1, np.int32)
        probe.run_any(pred.ctypes.data, out.ctypes.data, lanes)
        for w in range(0, lanes, 32):
            want = int(which is not None and which < min(32, lanes - w))
            assert (out[w:w + 32] == want).all(), (which, w)


@pytest.mark.parametrize("kind", ["float64 xor butterfly", "shfl broadcast", "syncwarp",
                                  "ldg"])
def test_shim_warp_primitives(probe, kind):
    """The shim's warp primitives that K3 relies on, against CUDA's
    semantics, over two warps: a float64 ``__shfl_xor_sync`` butterfly
    leaves every lane its warp's sum, bit-equal across the lanes (the
    angle and bin each lane computes); ``__shfl_sync`` broadcasts lane 5;
    ``__syncwarp`` orders the lanes' shared-memory writes before their
    reads; ``__ldg`` loads."""
    k = ["float64 xor butterfly", "shfl broadcast", "syncwarp", "ldg"].index(kind)
    x = np.random.default_rng(k).normal(0, 1e3, 64)
    out = np.zeros(64)
    probe.run_warp(k, x.ctypes.data, out.ctypes.data, 64)
    for w in (0, 32):
        xs = x[w:w + 32]
        if k == 0:
            vals = xs.copy()
            for m in (16, 8, 4, 2, 1):
                vals = vals + vals[np.arange(32) ^ m]
            want = vals
            assert len(set(out[w:w + 32].tolist())) == 1
        elif k == 1:
            want = np.full(32, xs[5])
        elif k == 2:
            want = 2.0 * xs[(np.arange(32) + 1) % 32]
        else:
            want = xs
        np.testing.assert_array_equal(out[w:w + 32], want)


def test_shim_shfl_up_scan(probe):
    """The shim's ``__shfl_up_sync`` (K8's prefix): a float64 inclusive
    scan by shuffles up over two warps, each warp's own cumulative sums in
    the scan's order (a lane below the distance keeps its value)."""
    x = np.random.default_rng(4).normal(0, 1e3, 64)
    out = np.zeros(64)
    probe.run_warp(4, x.ctypes.data, out.ctypes.data, 64)
    for w in (0, 32):
        want = x[w:w + 32].copy()
        for d in (1, 2, 4, 8, 16):
            want[d:] = want[d:] + want[:-d].copy()
        np.testing.assert_array_equal(out[w:w + 32], want)


def test_shim_bf16_rounding_is_torchs(probe):
    """The shim's ``__float2bfloat16_rn``: torch's bf16 rounding (nearest,
    ties to even) on random floats, exact ties, the largest finite floats,
    infinities and subnormals; NaN stays NaN."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(-300, 300, 2000), rng.normal(0, 1e-3, 500)]).astype(np.float32)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16) | 0x8000
    special = np.array([np.inf, -np.inf, 3.3895314e38, -3.4028235e38, 1e-40, -1e-42, 0.0, -0.0],
                       np.float32)
    x = np.concatenate([x, ties.view(np.float32), special, [np.nan]]).astype(np.float32)
    y = np.zeros_like(x)
    probe.run_bf16(x.ctypes.data, y.ctypes.data, len(x))
    want = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(y[:-1].view(np.uint32), want[:-1].view(np.uint32))
    assert np.isnan(y[-1])


def test_timeline_patches_every_stage():
    """tools/image_kernel_timeline.py finds every anchor it stamps in the
    committed source (the cell kernel's five stages, sub-tiles, two argmaxes
    and scan; the pyramid's five; K3's barriers, its angle's store and its
    end: at least the two warp barriers of its blur, its patch's barrier
    and the store; K8's table kernel's four barriers and end, its pixel
    kernel's start, two barriers and end), so that the card run does not
    fail on a moved line."""
    path = Path(__file__).resolve().parents[1] / "tools" / "image_kernel_timeline.py"
    spec = importlib.util.spec_from_file_location("image_kernel_timeline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = image_kernels._SRC.read_text()
    timed = mod.timed_source(src)
    stamped = sorted(int(k) for k in re.findall(r"g_stamps\[b_ \* 16 \+ (\d+)\] = t_", timed))
    labels = mod.describe_labels(src)
    assert len(labels) >= 5 and mod.DESC_FIRST + len(labels) <= 15    # slot 15: the SM
    desc = [0, *range(mod.DESC_FIRST, mod.DESC_FIRST + len(labels))]
    clahe = [*range(6), *range(8, 12)]        # K8's table kernel 0-5, its pixel kernel 8-11
    assert stamped == sorted([*set(mod.CELL_STAGES) | {0}, *set(mod.PYR_STAGES) | {0, 3}, *desc,
                              *clahe])


@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles, kind", ip.CLAHE_CASES)
def test_clahe_source_matches_plain(k357, W, H, tiles, kind, clip):
    """K8's two launches through ``clahe``: tables and output bit-equal to
    the plain version at clip 3.0, within CLAHE_ATOL at 2.7."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.check_clahe(W, H, tiles, kind, clip, CPU)


def test_clahe_stack_through_the_source(k357):
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.check_clahe_stack(CPU)


@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles", [(128, 96, 8), (160, 120, 4)])
def test_clahe_source_and_plain_against_jax(k357, W, H, tiles, clip):
    """K8 and the plain version within CLAHE_ATOL of the JAX package's
    ``clahe`` (tests/test_torch_bootstrap.py's bar)."""
    mod, lib = k357
    img = ip.clahe_image("band", W, H)
    want = np.asarray(jimg.clahe(jnp.asarray(img), clip=clip, tiles=tiles))
    with mod.on_cpu(lib):
        got = image.clahe(_t(img), clip=clip, tiles=tiles)
    plain = image._clahe_plain(_t(img), clip=clip, tiles=tiles)
    for x in (got, plain):
        np.testing.assert_allclose(x.numpy(), want, atol=ip.CLAHE_ATOL, rtol=0)


def test_clahe_c_entry_refuses_bad_shapes(k357):
    lib = image_kernels.bind(ctypes.CDLL(k357[1]))
    for B, H, W, tiles in ((0, 8, 8, 8), (65536, 8, 8, 8), (1, 12, 16, 8), (1, 16, 12, 8),
                           (1, 8, 8, 0), (1, 4, 8, 8), (1, 514, 514, 257)):
        assert lib.image_clahe_launch(None, B, H, W, tiles, 1.0, None, None, None) != 0, \
            (B, H, W, tiles)


@pytest.fixture
def h100_sms(k357):
    """The CPU build's device given an H100's 132 multiprocessors for the
    test (2 again after): K8's pixel kernel then splits a frame's tiles
    into more bands, over a grid of 396 blocks."""
    lib = ctypes.CDLL(k357[1])
    lib.cpu_cuda_set_sm_count(132)
    yield
    lib.cpu_cuda_set_sm_count(2)


@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles, kind, offset", ip.CLAHE_LAYOUT_CASES)
def test_clahe_layouts_through_the_source(k357, W, H, tiles, kind, offset, clip):
    """K8 at a tile side that is not a multiple of 4, on inputs that are
    not 16-byte aligned (both kernels' scalar paths), on a constant
    640x480 and on one 8192 x 2 tile: ``check_clahe``'s bars."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.check_clahe(W, H, tiles, kind, clip, CPU, offset)


@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles, kind, offset",
                         [(*c, 0) for c in ip.CLAHE_CASES] + ip.CLAHE_LAYOUT_CASES)
def test_clahe_on_132_multiprocessors_through_the_source(k357, h100_sms, W, H, tiles, kind,
                                                         offset, clip):
    """K8 on a device of 132 multiprocessors: the pixels in more bands a
    tile: ``check_clahe``'s bars."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.check_clahe(W, H, tiles, kind, clip, CPU, offset)


def test_clahe_stack_on_132_multiprocessors_through_the_source(k357, h100_sms):
    """A stack of 3 on 132 multiprocessors (the pixels in 2 bands a tile,
    1 band in each lone call): each row equal to its lone call, the stack
    to the plain version."""
    mod, lib = k357
    with mod.on_cpu(lib):
        card_tests.check_clahe_stack(CPU)


def test_c_entries_refuse_bad_shapes(k357):
    """The C entries refuse what the kernels do not take before they
    launch; ``bind`` checks the library's limits against the wrapper's."""
    lib = image_kernels.bind(ctypes.CDLL(k357[1]))
    assert lib.image_gray_launch(None, 0, 2, 4, None, None) != 0
    assert lib.image_gray_launch(None, 0, 4, 0, None, None) == 0           # nothing to do
    for B, H, W, levels in ((1, 0, 4, 2), (1, 4, 0, 1), (1, 4, 4, 3), (1, 4, 4, 0), (-1, 4, 4, 1)):
        assert lib.image_pyramid_launch(None, B, H, W, levels, None, None, None) != 0
    assert lib.image_pyramid_launch(None, 1, 4, 4, 2, None, None, None) != 0   # no second level
    assert lib.image_pyramid_launch(None, 0, 4, 4, 1, None, None, None) == 0
    # the response tiles: in shared memory at the main path's cells, in
    # global scratch (and then refused without it) where they do not fit
    for H, W, cell in ((480, 640, 40), (1080, 1920, 96), (480, 640, 30), (200, 300, 160)):
        assert lib.detect_tile_floats(H, W, cell) == 0, cell
    assert lib.detect_tile_floats(200, 300, 250) == 204 * 254
    assert lib.detect_tile_floats(0, 300, 250) == -1
    assert lib.detect_grid_launch(None, None, None, None, 0.0, 1, 200, 300, 0, 250, 0,
                                  *[None] * 9) != 0
    bad = [(0, 10, 10, 4), (65536, 10, 10, 4), (1, 2, 10, 4), (1, 10, 10, 0),
           (1, 10, 10, 46341)]
    for S, H, W, cell in bad:
        assert lib.detect_grid_launch(None, None, None, None, 0.0, S, H, W, 0, cell, 0,
                                      *[None] * 9) != 0, (S, H, W, cell)
    for S, H, W, N in ((0, 40, 40, 1), (1, 35, 40, 1), (1, 40, 35, 1), (1, 40, 40, -1)):
        assert lib.describe_launch(None, None, None, None, S, H, W, N, 1, None, None,
                                   None) != 0
    assert lib.describe_launch(None, None, None, None, 1, 40, 40, 0, 1, None, None, None) == 0


def test_bind_refuses_other_limits(k357, monkeypatch):
    for name in ("MAX_ROWS", "PATCH", "BITS", "ANGLE_BINS", "SCRATCH_F", "SCRATCH_I",
                 "MAX_TILES"):
        with monkeypatch.context() as m:
            m.setattr(image_kernels, name, getattr(image_kernels, name) - 1)
            with pytest.raises(RuntimeError, match="limit"):
                image_kernels.bind(ctypes.CDLL(k357[1]))


# ---------------------------------------------------------------------------
# Without building anything
# ---------------------------------------------------------------------------

def test_cpu_path_is_the_plain_version_and_loads_nothing():
    """On CPU tensors the wrappers are the plain versions, count no launch
    and never load the library; the golden run's first 16 frames (the
    first keyframe and the bootstrap keyframe at frame 15) through
    ``slam_step`` are tests/golden/torch_step_320.npz's bit for bit."""
    import test_torch_async as ta
    from alvaar_tpu_torch.frontend import step as tstep
    from alvaar_tpu_torch.worldmap.state import init_map_state
    card_tests._zero()
    lib, load = image_kernels._lib, image_kernels._load
    image_kernels._load = lambda: pytest.fail("the CPU path loaded the kernels' library")
    try:
        frames = ta.render_frames(16)
        golden = np.load(ta.GOLDEN)
        state, cam = init_map_state(ta.CFG, "cpu"), ta.camera()
        for i, f in enumerate(frames):
            state, out = tstep.slam_step(state, torch.from_numpy(f), cam, ta.CFG)
            assert int(out.status) == golden["status"][i], i
            assert ta.state_digests(state)[0] == golden["digest"][i], i
        img = torch.from_numpy(frames[0])
        rgba = torch.from_numpy(ip.rgba(frames[0]))
        assert torch.equal(image.rgba_to_gray(rgba), image._rgba_to_gray_plain(rgba))
        assert torch.equal(image.pyr_down(img), image._pyr_down_plain(img))
    finally:
        image_kernels._load = load
    assert image_kernels._lib is lib is None
    assert image.rgba_to_gray.launches == image.pyr_down.launches == 0
    assert detect.detect_grid.launches == orb.describe.launches == 0
    assert detect.detect_grid.calls == orb.describe.calls == 0   # counted on the card only


def test_op_cpu_implementation_is_the_plain_version():
    """The custom ops on CPU tensors equal the plain versions row by row."""
    imgs = torch.stack([_t(ip.frame(128, 96, index=i)) for i in (1, 2)])
    ex, exv = (_t(a) for a in ip.existing(np.random.default_rng(1), 10, 128, 96))
    q = torch.tensor([0.001, 0.002])
    out = detect._DETECT_OP(imgs, ex.expand(2, -1, -1).contiguous(),
                            exv.expand(2, -1).contiguous(), q, 24, 8)
    xy = _t(ip.keypoints(np.random.default_rng(2), 30, 128, 96))
    valid = torch.ones(30, dtype=torch.bool)
    desc, angle = orb._DESCRIBE_OP(imgs, torch.stack([xy, xy]), torch.stack([valid, valid]),
                                   True)
    for i in range(2):
        d = detect.detect_grid(imgs[i], ex, exv, cell=24, border=8, quality=q[i])
        for k, f in enumerate(("xy", "score", "valid", "new_quality")):
            assert torch.equal(out[k][i], getattr(d, f)), (i, f)
        pd, pa = orb.describe(imgs[i], xy, valid)
        assert torch.equal(desc[i], pd) and torch.equal(angle[i], pa)


def test_op_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    imgs = torch.stack([_t(ip.frame(121, 97, index=i)) for i in (1, 2)])
    ex = torch.zeros(2, 3, 2)
    exv = torch.zeros(2, 3, dtype=torch.bool)
    q = torch.full((2,), 0.001)
    xy = torch.rand(2, 7, 2) * 90
    valid = torch.ones(2, 7, dtype=torch.bool)
    mode = FakeTensorMode()
    for op, args in ((detect._DETECT_OP, (imgs, ex, exv, q, 24, 8)),
                     (orb._DESCRIBE_OP, (imgs, xy, valid, True))):
        real = op(*args)
        with mode:
            got = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
        for r, g in zip(real, got):
            assert (tuple(g.shape), g.dtype) == (tuple(r.shape), r.dtype)


def test_op_vmap_rule_equals_rows():
    """Under ``torch.func.vmap`` the ops run once over the rows (their
    batching rule); the result equals single calls bit for bit, an
    unbatched argument (one live-keypoint table for every row) included."""
    imgs = torch.stack([_t(ip.frame(128, 96, index=i)) for i in (1, 2, 3)])
    ex, exv = (_t(a) for a in ip.existing(np.random.default_rng(3), 6, 128, 96))
    q = torch.tensor([0.001, 0.0005, 0.002])

    def det(i, x, v, qq):
        return detect._DETECT_OP(i[None], x[None], v[None], qq[None], 24, 8)

    def desc(i, p, v):
        return orb._DESCRIBE_OP(i[None], p[None], v[None], True)

    got = torch.func.vmap(det, in_dims=(0, None, None, 0))(imgs, ex, exv, q)
    xy = got[0][:, 0].contiguous()
    got_d = torch.func.vmap(desc)(imgs, xy, got[2][:, 0])
    for i in range(3):
        one = det(imgs[i], ex, exv, q[i])
        for a, b in zip(got, one):
            assert torch.equal(a[i], b), i
        for a, b in zip(got_d, desc(imgs[i], xy[i], got[2][i, 0])):
            assert torch.equal(a[i], b), i


def test_launchers_refuse_cpu_tensors_and_bad_arguments():
    """The launchers run on CUDA tensors only and check dtypes, shapes,
    contiguity, devices and sizes before anything is built."""
    img = torch.zeros(1, 48, 64)
    ex, exv, q = torch.zeros(1, 3, 2), torch.zeros(1, 3, dtype=torch.bool), torch.zeros(1)
    xy, valid = torch.zeros(1, 5, 2), torch.zeros(1, 5, dtype=torch.bool)
    taps = _t(orb._TAP_PAIRS)
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_gray(torch.zeros(4, 4, 4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_pyr_down(img[0])
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_detect(img, ex, exv, q, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_describe(img, xy, valid, taps)
    gray_bad = [(torch.zeros(4, 4, 2, dtype=torch.uint8), ValueError),      # 2 channels
                (torch.zeros(4, 4, 4, dtype=torch.int32), TypeError),
                (torch.zeros(4, 4, 4, dtype=torch.uint8).transpose(0, 1), ValueError),
                (torch.zeros(4, 4), ValueError)]
    for x, err in gray_bad:
        with pytest.raises(err):
            image_kernels.launch_gray(x)
    for x, err in ((img[0].double(), TypeError), (img[0].t(), ValueError),
                   (torch.zeros(2, 2, 4, 4), ValueError)):
        with pytest.raises(err):
            image_kernels.launch_pyr_down(x)
    detect_bad = [
        ((img[0], ex, exv, q, 16, 4), ValueError),                       # no S
        ((img.double(), ex, exv, q, 16, 4), TypeError),
        ((img, ex[:, :2], exv, q, 16, 4), ValueError),                   # K differs
        ((img, ex.double(), exv, q, 16, 4), TypeError),
        ((img, ex, exv.int(), q, 16, 4), TypeError),
        ((img, ex, exv, q.repeat(2), 16, 4), ValueError),                # S differs
        ((img, ex, exv, "0.1", 16, 4), TypeError),
        ((img, ex, exv, q, 16.0, 4), TypeError),
        ((img, ex, exv, q, 0, 4), ValueError),
        ((img, ex.to("meta"), exv, q, 16, 4), ValueError),               # two devices
        ((img[:, :2], ex, exv, q, 16, 4), ValueError),                   # H < 3
        ((img.new_zeros(0, 48, 64), ex[:0], exv[:0], q[:0], 16, 4), ValueError),   # S = 0
    ]
    for args, err in detect_bad:
        with pytest.raises(err):
            image_kernels.launch_detect(*args)
    describe_bad = [
        ((img[:, :30], xy, valid, taps), ValueError),                    # under 36 rows
        ((img, xy.double(), valid, taps), TypeError),
        ((img, xy, valid[:, :4], taps), ValueError),
        ((img, xy, valid, taps.long()), TypeError),
        ((img, xy, valid, taps[:29]), ValueError),
        ((img, xy.transpose(1, 2).contiguous().transpose(1, 2), valid, taps), ValueError),
    ]
    for args, err in describe_bad:
        with pytest.raises(err):
            image_kernels.launch_describe(*args)
    assert image_kernels._lib is None


def test_clahe_launcher_and_wrapper_refuse_bad_arguments():
    """K8's launcher runs on CUDA tensors only and checks its arguments
    before anything is built; ``clahe`` refuses sizes that are not
    multiples of the tiles, and devices other than the CPU and CUDA."""
    card_tests._zero()
    img = torch.zeros(48, 64)
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_clahe(img)
    with pytest.raises(ValueError, match="CUDA"):
        image_kernels.launch_clahe(img.to("meta"))
    bad = [((torch.zeros(50, 64),), ValueError),                       # H % 8
           ((torch.zeros(48, 60),), ValueError),                       # W % 8
           ((torch.zeros(48, 64, dtype=torch.float64),), TypeError),
           ((torch.zeros(64, 48).t(),), ValueError),                   # not contiguous
           ((torch.zeros(2, 2, 48, 64),), ValueError),
           ((torch.zeros(0, 48, 64),), ValueError),                    # B = 0
           ((img, 3.0, 0), ValueError), ((img, 3.0, 257), ValueError),
           ((img, 3.0, 8.0), ValueError), ((img, float("nan")), ValueError),
           ((img.numpy(),), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            image_kernels.launch_clahe(*args)
    with pytest.raises(ValueError, match="divisible"):
        image.clahe(torch.zeros(50, 64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        image.clahe(torch.zeros(48, 64, device="meta"))
    assert image_kernels._lib is None and image.clahe.launches == 0


def test_dispatch_raises_on_other_devices():
    img = torch.zeros(48, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        image.rgba_to_gray(torch.zeros(4, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        image.pyr_down(img)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        detect.detect_grid(img, img.new_zeros(1, 2), img.new_zeros(1, dtype=torch.bool), cell=16,
                           border=4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        orb.describe(img, img.new_zeros(3, 2), img.new_zeros(3, dtype=torch.bool))
    assert custom_ops.dispatch(torch.zeros(1), "x") is False
