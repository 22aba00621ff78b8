"""The image kernels K7, K5, K3 and K8 on a card against their plain versions
(skipped without one: a CUDA kernel has no CPU mode).  This file imports
neither JAX nor the JAX package, so that it runs where the card is:

    python -m pytest --noconftest tests/test_torch_image_kernels_card.py -q

(tests/conftest.py sets JAX up for the CPU tests.)  chip_smoke.py phase 2e
holds the same bars at the main path's shapes;
tools/rehearse_image_kernels.py runs these cases on the CPU through the
CUDA source.  K7 and K5 are bit-equal to their plain versions (on the CPU
with IEEE's square root, tests/image_problems.py ``ieee_sqrt``); K3's
angles are within 2e-5 rad of the plain ones and its words bit-equal at
every keypoint whose plain angle lies more than 1e-4 rad from a steering
bin's edge.  K7 takes one launch per 3-level pyramid (two for 4 levels),
K5 two per call.  K8 (CLAHE) takes two launches per call on one image or a
stack, its tables and output bit-equal to the plain version at the
default clip, within ``CLAHE_ATOL`` at clip 2.7, and each row of a stack
equal to its lone call; also at ``CLAHE_LAYOUT_CASES`` (a tile side that
is not a multiple of 4, inputs not 16-byte aligned, a constant 640x480, an
8192 x 2 tile)."""

import numpy as np
import pytest
import torch

import image_problems as ip
from alvaar_tpu_torch.ops import detect, image, image_kernels, orb

# name → (W, H, cell, live keypoints, image): cells off the image's size
# (partial cells; at 121 x 97 a one-pixel corner cell whose second peak
# has nothing outside its disc: -inf, index 0), a constant image (every
# response 0: ties to the first index), 8 x 8 blocks (repeated equal
# corners: ties across cells)
CARD_CASES = {
    "scene 128x96 cell 24": (128, 96, 24, 0, "scene"),
    "scene 121x97 cell 24, 10 live": (121, 97, 24, 10, "scene"),
    "scene 320x240 cell 50, 40 live": (320, 240, 50, 40, "scene"),
    "constant 128x96 cell 40": (128, 96, 40, 0, "constant"),
    "blocks 121x97 cell 24, 10 live": (121, 97, 24, 10, "blocks"),
}
# K5's traps (name → (W, H, cell, live keypoints, image)): a last column
# of cells one pixel wide and a last row two (the subpixel fit's clamp to
# [1, W - 2] reaches into the previous cell's pixels), hd_serving()'s cell
# 96 (a response tile of 100 x 100, computed in 2 x 2 sub-tiles), a cell
# whose response tile does not fit in shared memory (global scratch), NaN
# and +-inf pixels, more live keypoints than the cell kernel's threads
TRAP_CASES = {
    "scene 121x98 cell 24 (W = 5 cell + 1, H = 4 cell + 2), 10 live": (121, 98, 24, 10, "scene"),
    "scene 290x200 cell 96, 12 live": (290, 200, 96, 12, "scene"),
    "scene 300x200 cell 250 (its tile in global scratch), 3 live": (300, 200, 250, 3, "scene"),
    "NaN and inf pixels 121x98 cell 24, 10 live": (121, 98, 24, 10, "nonfinite"),
    "scene 160x120 cell 24, 600 live (more than the cell kernel's threads)":
        (160, 120, 24, 600, "scene"),
}
# K7's pyramids: (name, [B,] H, W shape, levels)
PYRAMID_CASES = [("641x481", (481, 641), 3), ("641x481", (481, 641), 4), ("7x5", (5, 7), 3),
                 ("3x3", (3, 3), 4), ("1x1", (1, 1), 3), ("3 x 83x61", (3, 61, 83), 3),
                 ("3 x 83x61", (3, 61, 83), 4)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


image_of = ip.image_of


def _zero():
    image.rgba_to_gray.launches = image.pyr_down.launches = image.build_pyramid.calls = 0
    image.clahe.launches = 0
    image.build_pyramid.launches = 0
    detect.detect_grid.launches = detect.detect_grid.calls = 0
    orb.describe.launches = orb.describe.calls = 0


def detect_case(name, dev):
    """(img, live xy, live flags, cell) of a case of ``CARD_CASES`` or
    ``TRAP_CASES`` on ``dev``."""
    W, H, cell, n_live, kind = {**CARD_CASES, **TRAP_CASES}[name]
    rng = np.random.default_rng(W * H + n_live)
    ex, exv = ip.existing(rng, n_live, W, H)
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(image_of(kind, W, H)), t(ex), t(exv), cell


def assert_detection_equal(got, plain):
    for f in ("xy", "score", "valid", "new_quality"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def check_detect_trap(name, dev):
    """K5 on a case of ``TRAP_CASES`` through ``detect_grid`` (two launches)
    and the launcher: every output bit-equal to the plain version, the
    response too (NaN where the plain one is NaN), with a float and with a
    tensor threshold."""
    img, ex, exv, cell = detect_case(name, dev)
    args = dict(cell=cell, border=8)
    q = torch.tensor(0.002, device=dev)
    _zero()
    got = detect.detect_grid(img, ex, exv, quality=0.001, **args)
    got_q = detect.detect_grid(img, ex, exv, quality=q, **args)
    assert detect.detect_grid.launches == 4
    *_, resp = image_kernels.launch_detect(img[None], ex[None], exv[None], 0.001, cell, 8)
    with ip.ieee_sqrt(), np.errstate(invalid="ignore"):
        plain = detect._detect_grid_plain(img, ex, exv, quality=0.001, **args)
        plain_q = detect._detect_grid_plain(img, ex, exv, quality=q, **args)
        plain_resp = detect.shi_tomasi_response(img)
    assert_detection_equal(got, plain)
    assert_detection_equal(got_q, plain_q)
    assert ip.same(resp[0], plain_resp)
    return got


def assert_describe_close(desc, angle, plain_desc, plain_angle):
    """K3's bar: angles within ANGLE_BAR, words bit-equal outside the bin
    margin.  Returns the keypoints inside the margin."""
    assert float((angle - plain_angle).abs().max()) <= ip.ANGLE_BAR
    inside, off, _ = ip.words_outside_margin(desc, plain_desc, plain_angle)
    assert off == 0
    return inside


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_detect_and_describe_on_card(card, name):
    """K5 in two launches bit-equal to the plain version (its response
    too) with a float and a tensor threshold; K3 in one launch at the
    detections and at keypoints on and past the image's edges, at its
    bar, invalid keypoints zero."""
    img, ex, exv, cell = detect_case(name, card)
    args = dict(cell=cell, border=8)
    _zero()
    got = detect.detect_grid(img, ex, exv, quality=0.001, **args)
    assert detect.detect_grid.launches == 2
    q = torch.tensor(0.004, device=card)
    got_q = detect.detect_grid(img, ex, exv, quality=q, **args)
    *_, resp = image_kernels.launch_detect(img[None], ex[None], exv[None], 0.001, cell, 8)
    with ip.ieee_sqrt():
        plain = detect._detect_grid_plain(img, ex, exv, quality=0.001, **args)
        plain_q = detect._detect_grid_plain(img, ex, exv, quality=q, **args)
        plain_resp = detect.shi_tomasi_response(img)
    assert_detection_equal(got, plain)
    assert_detection_equal(got_q, plain_q)
    assert torch.equal(resp[0], plain_resp)
    rng = np.random.default_rng(len(name))
    H, W = img.shape
    xy = torch.cat([got.xy, torch.as_tensor(ip.keypoints(rng, 30, W, H), device=card)])
    valid = torch.cat([got.valid, torch.as_tensor(rng.random(30) < 0.8, device=card)])
    _zero()
    desc, angle = orb.describe(img, xy, valid)
    assert orb.describe.launches == 1
    plain_desc, plain_angle = orb._describe_plain(img, xy, valid)
    assert_describe_close(desc, angle, plain_desc, plain_angle)
    assert bool((desc[~valid] == 0).all())
    raw, raw_angle = orb.describe(img, xy, valid, blur=False)
    plain_raw, plain_raw_angle = orb._describe_plain(img, xy, valid, blur=False)
    assert_describe_close(raw, raw_angle, plain_raw, plain_raw_angle)


@pytest.mark.cuda
def test_pyramid_and_gray_on_card(card):
    """K7 bit-equal to its plain versions: the gray conversion of u8 RGBA,
    u8 RGB and float32 RGBA (one launch each, a stack of 3 included) and
    3-level pyramids of odd sizes (one launch), alone and stacked."""
    rng = np.random.default_rng(3)
    g = ip.frame(83, 61)
    rgba = torch.as_tensor(ip.rgba(np.stack([g, g[::-1].copy(), 255 - g])), device=card)
    for x in (rgba[0], rgba[0, ..., :3].contiguous(), rgba, rgba[0].float() + 0.5):
        _zero()
        got = image.rgba_to_gray(x)
        assert image.rgba_to_gray.launches == 1
        assert torch.equal(got, image._rgba_to_gray_plain(x))
    noise = torch.as_tensor(rng.uniform(0, 255, (3, 61, 83)).astype(np.float32), device=card)
    for x in (noise[0], noise, noise[:, :1, :1].contiguous(), noise[:, :2, :37].contiguous()):
        _zero()
        pyr = image.build_pyramid(x, 3)
        assert image.build_pyramid.launches == 1 and image.pyr_down.launches == 0
        want = [x]
        for _ in range(2):
            want.append(image._pyr_down_plain(want[-1]))
        for a, b in zip(pyr, want):
            assert a.shape == b.shape and a.is_contiguous() and torch.equal(a, b)


@pytest.mark.cuda
def test_rows_under_vmap_on_card(card):
    """S = 3 rows under ``torch.func.vmap``: K5's two launches and K3's
    one for all of them, each row bit-equal to its call alone (per-row
    thresholds; a live-keypoint table shared by every row)."""
    imgs = torch.as_tensor(np.stack([ip.frame(160, 120, index=i) for i in range(3)]),
                           device=card)
    rng = np.random.default_rng(5)
    ex, exv = (torch.as_tensor(a, device=card) for a in ip.existing(rng, 12, 160, 120))
    q = torch.tensor([0.001, 0.0005, 0.003], device=card)
    fields = ("xy", "score", "valid", "new_quality")

    def call(i, x, v, qq):
        d = detect.detect_grid(i, x, v, cell=24, border=8, quality=qq)
        return tuple(getattr(d, f) for f in fields)

    _zero()
    rows = torch.func.vmap(call, in_dims=(0, None, None, 0))(imgs, ex, exv, q)
    assert detect.detect_grid.launches == 2
    xy, valid = rows[0].contiguous(), rows[2]
    desc, angle = torch.func.vmap(orb.describe)(imgs, xy, valid)
    assert orb.describe.launches == 1
    for s in range(3):
        alone = call(imgs[s], ex, exv, q[s])
        for k, f in enumerate(fields):
            assert torch.equal(rows[k][s], alone[k]), (s, f)
        d, a = orb.describe(imgs[s], xy[s], valid[s])
        assert torch.equal(desc[s], d) and torch.equal(angle[s], a), s


def check_pyramid(shape, levels: int, dev):
    """K7's pyramid of a seeded [B,] H, W image on ``dev``: one launch per
    two levels below level 0, every level contiguous and bit-equal to
    ``_pyr_down_plain`` level by level; ``pyr_down`` alone one launch.
    Returns the image and the pyramid."""
    x = torch.as_tensor(np.random.default_rng(sum(shape)).uniform(0, 255, shape)
                        .astype(np.float32), device=dev)
    _zero()
    pyr = image.build_pyramid(x, levels)
    assert image.build_pyramid.launches == levels // 2 and image.pyr_down.launches == 0
    want = [x]
    for _ in range(levels - 1):
        want.append(image._pyr_down_plain(want[-1]))
    assert len(pyr) == levels
    for a, b in zip(pyr, want):
        assert a.shape == b.shape and a.is_contiguous() and torch.equal(a, b)
    assert torch.equal(image.pyr_down(x), want[1]) and image.pyr_down.launches == 1
    return x, pyr


@pytest.mark.cuda
@pytest.mark.parametrize("name, shape, levels", PYRAMID_CASES)
def test_fused_pyramid_on_card(card, name, shape, levels):
    """K7's pyramid kernel at odd sizes, alone and stacked, at 3 and 4
    levels: bit-equal to the plain version, one launch per two levels."""
    check_pyramid(shape, levels, card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAP_CASES))
def test_detect_traps_on_card(card, name):
    """K5 on its traps (``TRAP_CASES``), bit-equal to the plain version."""
    check_detect_trap(name, card)


@pytest.mark.cuda
def test_detect_65535_rows_on_card(card):
    """K5 on S = 65 535 rows (its grid's limit) of one 40 x 24 image at
    three thresholds in turn: each row bit-equal to the plain version at
    its threshold."""
    img = torch.as_tensor(ip.frame(40, 24), device=card)
    S = image_kernels.MAX_ROWS
    q = torch.tensor([0.004, 0.001, 0.0002], device=card)
    ex = torch.zeros((S, 1, 2), device=card)
    exv = torch.zeros((S, 1), dtype=torch.bool, device=card)
    got = image_kernels.launch_detect(img.expand(S, -1, -1).contiguous(), ex, exv,
                                      q.repeat(S // 3), 8, 4)
    with ip.ieee_sqrt():
        plain = [detect._detect_grid_plain(img, ex[0], exv[0], cell=8, border=4, quality=q[k])
                 for k in range(3)]
    for k, p in enumerate(plain):
        for o, f in zip(got, ("xy", "score", "valid", "new_quality")):
            want = getattr(p, f)
            assert torch.equal(o[k::3], want.expand((S // 3,) + want.shape)), (k, f)


def check_clahe(W, H, tiles, kind, clip, dev, offset=0):
    """K8 on one case of ``ip.CLAHE_CASES`` (or, with ``offset``, of
    ``ip.CLAHE_LAYOUT_CASES``) at ``clip`` on
    ``dev``: two launches through ``clahe``; the tables and the output
    bit-equal to the plain version at ``ip.CLAHE_CLIP``, within
    ``ip.CLAHE_ATOL`` at any other clip.  Returns the output's largest
    distance."""
    x = ip.clahe_input(kind, W, H, offset, dev)
    _zero()
    got = image.clahe(x, clip=clip, tiles=tiles)
    assert image.clahe.launches == image_kernels.CLAHE_LAUNCHES
    out, lut = image_kernels.launch_clahe(x, clip, tiles)
    plain_lut = image._clahe_luts_plain(x, clip, tiles)
    plain = image._clahe_apply_plain(x, plain_lut, tiles)
    assert got.shape == x.shape and lut.shape == (1, tiles * tiles, 256)
    assert torch.equal(got, out)
    err = float((out - plain).abs().max())
    if clip == ip.CLAHE_CLIP:
        assert torch.equal(lut[0], plain_lut) and torch.equal(out, plain)
    else:
        assert float((lut[0] - plain_lut).abs().max()) <= ip.CLAHE_ATOL
        assert err <= ip.CLAHE_ATOL
    return err


def check_clahe_stack(dev):
    """K8 on a stack of 3 (the dark band, the band at half its contrast
    rolled, a constant) in two launches: each row equal to its lone call,
    the stack to the plain version."""
    band = ip.clahe_image("band", 128, 96)
    x = torch.as_tensor(np.stack([band, np.roll(0.5 * band, (7, 11), (0, 1)),
                                  ip.clahe_image("constant", 128, 96)]), device=dev)
    _zero()
    got = image.clahe(x)
    assert image.clahe.launches == image_kernels.CLAHE_LAUNCHES
    for b in range(3):
        assert torch.equal(got[b], image.clahe(x[b])), b
    assert torch.equal(got, image._clahe_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles, kind", ip.CLAHE_CASES)
def test_clahe_on_card(card, W, H, tiles, kind, clip):
    check_clahe(W, H, tiles, kind, clip, card)


@pytest.mark.cuda
def test_clahe_stack_on_card(card):
    check_clahe_stack(card)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [ip.CLAHE_CLIP, ip.CLAHE_ODD_CLIP])
@pytest.mark.parametrize("W, H, tiles, kind, offset",
                         ip.CLAHE_LAYOUT_CASES)
def test_clahe_layouts_on_card(card, W, H, tiles, kind, offset, clip):
    check_clahe(W, H, tiles, kind, clip, card, offset)
