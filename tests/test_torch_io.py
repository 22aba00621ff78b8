"""The port's host ingest layer (alvaar_tpu_torch/io: frame_ring, video,
capture, camera, imu) against the JAX package's modules, on the CPU.

* Frame ring: the same push/front/release sequence through the port's
  ring (built from native/frame_ring.cpp into build/) and the JAX
  package's (built by its own Makefile, in a scratch directory): gray
  slots bit-equal, RGBA slots within the rounding of the Makefile's
  ``-march=native`` build (which lets the compiler fuse the weighted sum
  into FMAs) and bit-equal to the port's ``ops/image.rgba_to_gray``; a
  full ring refuses a push; ``capacity`` and ``len``.
* Video: the decoder library loads (built where the libav headers are,
  else the repository's prebuilt copy) or the error says why; the reader
  and ``VideoCapture`` on the reference's demo video skip when it is
  absent, as tests/test_video.py does.
* V4L2: ioctl numbers and fourcc codes equal to the JAX module's and to
  the kernel values pinned in tests/test_v4l2.py.
* IMU: ``ImuCapture`` against JAX's on the same pushes; the wire buffer
  from JAX unpacked by the port and back; ``find_camera_pose_with_imu``
  on the CPU fed from a snapshot.
"""

import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from alvaar_tpu.io import camera as jcam
from alvaar_tpu.io import frame_ring as jfr
from alvaar_tpu.io import imu as jimu
from alvaar_tpu_torch import AlvaAR, SlamConfig
from alvaar_tpu_torch.io import FrameRing
from alvaar_tpu_torch.io import camera as tcam
from alvaar_tpu_torch.io import imu as timu
from alvaar_tpu_torch.io import video as tvideo
from alvaar_tpu_torch.ops.image import rgba_to_gray
from alvaar_tpu_torch.utils.build import BUILD_DIR
from tests.test_video import REF_VIDEO   # the reference's demo video, where present

ROOT = Path(__file__).resolve().parents[1]
H, W = 48, 64


@pytest.fixture(scope="module")
def jax_ring_lib(tmp_path_factory):
    """The JAX package's ring library, built by its Makefile in a scratch
    copy of native/ (never in native/ itself, which tests/test_frame_ring.py
    may be building at the same time)."""
    d = tmp_path_factory.mktemp("native")
    for f in ("Makefile", "frame_ring.cpp"):
        shutil.copy(ROOT / "native" / f, d / f)
    subprocess.run(["make", "-s", "libframering.so"], cwd=d, check=True)
    return d / "libframering.so"


@pytest.fixture
def jax_ring(jax_ring_lib, monkeypatch):
    monkeypatch.setattr(jfr, "_LIB_PATH", jax_ring_lib)
    monkeypatch.setattr(jfr, "_lib", None)
    return jfr.FrameRing


def test_ring_library_builds_into_build_dir():
    ring = FrameRing(W, H, capacity=2)
    built = sorted(BUILD_DIR.glob("libframe_ring_*.so"))
    assert built and ring.capacity == 2
    assert not (ROOT / "native" / "libframe_ring.so").exists()


def test_ring_matches_jax_ring(jax_ring, rng):
    port, ref = FrameRing(W, H, capacity=3), jax_ring(W, H, capacity=3)
    assert port.capacity == ref.capacity == 3
    grays = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(5)]
    rgbas = [rng.integers(0, 256, (H, W, 4), dtype=np.uint8) for _ in range(2)]
    pushes = [("gray", grays[0], 0.5), ("rgba", rgbas[0], 1.0), ("gray", grays[1], 1.5),
              ("rgba", rgbas[1], 2.0), ("gray", grays[2], 2.5), ("gray", grays[3], 3.0),
              ("gray", grays[4], 3.5)]
    for kind, img, ts in pushes:
        push = lambda r: getattr(r, "push_" + kind)(img, ts)
        seq_p, seq_r = push(port), push(ref)
        assert seq_p == seq_r
        assert len(port) == len(ref)
        if len(port) == 3:                               # full: both refuse one more
            assert port.push_gray(grays[0]) == ref.push_gray(grays[0]) == -1
            assert len(port) == len(ref) == 3
        if seq_p >= 0 and (seq_p % 2 == 1 or len(port) == 3):
            # consume one: the oldest slot of each ring
            (a, ta), (b, tb) = port.front(), ref.front()
            assert ta == tb
            old = pushes[[p[2] for p in pushes].index(ta)]
            if old[0] == "gray":
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, old[1].astype(np.float32))
            else:
                expect = rgba_to_gray(torch.from_numpy(old[1])).numpy()
                np.testing.assert_array_equal(a, expect)
                np.testing.assert_allclose(a, b, rtol=0, atol=4 * np.spacing(np.float32(255)))
            assert port.release() and ref.release()
    while port.front() is not None:
        (a, ta), (b, tb) = port.front(), ref.front()
        assert ta == tb
        np.testing.assert_array_equal(a, b)
        port.release(), ref.release()
    assert ref.front() is None and len(port) == len(ref) == 0
    assert not port.release() and not ref.release()


def test_ring_checks_frame_shapes():
    ring = FrameRing(W, H, capacity=2)
    with pytest.raises(ValueError, match="shape"):
        ring.push_gray(np.zeros((H, W + 1), np.uint8))
    with pytest.raises(ValueError, match="shape"):
        ring.push_rgba(np.zeros((H, W, 3), np.uint8))


def test_ring_producer_consumer_in_order(rng):
    """A producer thread under a semaphore (as ``VideoCapture``) and a
    consumer that copies each slot before releasing it: every frame
    arrives once, in order, unchanged."""
    ring, space, n = FrameRing(W, H, capacity=3), threading.Semaphore(3), 40
    frames = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(n)]

    def produce():
        for i, f in enumerate(frames):
            space.acquire()
            assert ring.push_gray(f, float(i)) >= 0

    t = threading.Thread(target=produce)
    t.start()
    got, deadline = [], time.monotonic() + 30
    while len(got) < n and time.monotonic() < deadline:
        item = ring.front()
        if item is None:
            continue
        view, ts = item
        got.append((view.copy(), ts))
        ring.release()
        space.release()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [ts for _, ts in got] == [float(i) for i in range(n)]
    assert all(np.array_equal(g, f.astype(np.float32)) for (g, _), f in zip(got, frames))


# ---------------------------------------------------------------------------
# Video
# ---------------------------------------------------------------------------

def test_video_library_loads_or_says_why():
    try:
        lib = tvideo._load_lib()
    except RuntimeError as e:
        assert "libav" in str(e), e
        return
    assert callable(lib.vd_open) and callable(lib.vd_next_gray)
    with pytest.raises(IOError, match="cannot open video"):
        tvideo.VideoReader(str(ROOT / "no_such_video.mp4"))


def test_video_prebuilt_loads_without_headers(monkeypatch):
    monkeypatch.setattr(tvideo, "_lib", None)
    monkeypatch.setattr(tvideo, "_missing_headers", lambda gxx: "libavformat/avformat.h: none")
    assert tvideo._library_path() == ROOT / "native" / "libvideodec.so"
    try:
        lib = tvideo._load_lib()
    except RuntimeError as e:                    # no libav runtime on this host
        assert "libav runtime" in str(e), e
        return
    assert callable(lib.vd_open)


def test_video_library_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(tvideo, "_lib", None)
    monkeypatch.setattr(tvideo, "_missing_headers", lambda gxx: "libavformat/avformat.h: none")
    monkeypatch.setattr(tvideo, "_PREBUILT", tmp_path / "absent.so")
    with pytest.raises(RuntimeError, match="libav headers are missing"):
        tvideo._load_lib()
    junk = tmp_path / "junk.so"
    junk.write_bytes(b"not a library")
    monkeypatch.setattr(tvideo, "_PREBUILT", junk)
    with pytest.raises(RuntimeError, match="cannot load the video decoder"):
        tvideo._load_lib()


def _demo_video():
    if not REF_VIDEO.exists():
        pytest.skip("reference demo video not available")
    return str(REF_VIDEO)


def test_video_reader_matches_jax():
    path = _demo_video()
    from alvaar_tpu.io.video import VideoReader as JReader
    with tvideo.VideoReader(path) as a, JReader(path) as b:
        assert (a.width, a.height, a.fps, a.nframes) == (b.width, b.height, b.fps, b.nframes)
        for _ in range(10):
            (fa, ta), (fb, tb) = a.read(), b.read()
            assert ta == tb
            np.testing.assert_array_equal(fa, fb)


def test_video_capture_feeds_frames():
    path = _demo_video()
    from alvaar_tpu_torch.io.capture import VideoCapture
    cap = VideoCapture(path, capacity=4, max_frames=25)
    try:
        frames = list(cap.frames())
    finally:
        cap.close()
    assert len(frames) == 25
    stamps = [t for _, t in frames]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))
    assert frames[0][0].shape == (cap.height, cap.width) and frames[0][0].dtype == np.float32


# ---------------------------------------------------------------------------
# V4L2
# ---------------------------------------------------------------------------

PINNED = dict(VIDIOC_QUERYCAP=0x80685600, VIDIOC_S_FMT=0xC0D05605, VIDIOC_REQBUFS=0xC0145608,
              VIDIOC_QUERYBUF=0xC0585609, VIDIOC_QBUF=0xC058560F, VIDIOC_DQBUF=0xC0585611,
              VIDIOC_STREAMON=0x40045612, VIDIOC_STREAMOFF=0x40045613,
              PIX_FMT_YUYV=0x56595559, PIX_FMT_GREY=0x59455247)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_v4l2_codes(name):
    assert getattr(tcam, name) == getattr(jcam, name) == PINNED[name]


def test_v4l2_encoders_match_jax():
    for code in ("YUYV", "GREY", "MJPG", "RGB3"):
        assert tcam.fourcc(code) == jcam.fourcc(code)
    for args in ((2, 0, 104), (3, 5, 208), (1, 18, 4), (3, 17, 88, ord("U"))):
        assert tcam._ioc(*args) == jcam._ioc(*args)


def test_camera_open_failure_raises(tmp_path):
    with pytest.raises(OSError):
        tcam.CameraCapture(str(tmp_path / "video99"))


def test_live_camera_reads_frames():
    if not os.path.exists("/dev/video0"):
        pytest.skip("no camera device")
    with tcam.CameraCapture("/dev/video0") as c:
        out = c.read(timeout=5.0)
        assert out is not None and out[0].shape == (c.height, c.width)


# ---------------------------------------------------------------------------
# IMU
# ---------------------------------------------------------------------------

def _feed(cap, rng, n=30):
    for i in range(n):
        b, g, a = rng.uniform(-90, 90, 3)
        cap.push_orientation(b, g, a)
        cap.push_motion(0.01 * i, rng.normal(size=3), rng.normal(size=3))
    cap.set_screen_orientation("landscape_left")


@pytest.mark.parametrize("platform", ["android", "ios", "none"])
def test_imu_capture_matches_jax(platform):
    port, ref = timu.ImuCapture(platform, max_samples=20), jimu.ImuCapture(platform, max_samples=20)
    _feed(port, np.random.default_rng(3))
    _feed(ref, np.random.default_rng(3))
    (qa, ma), (qb, mb) = port.snapshot(), ref.snapshot()
    np.testing.assert_array_equal(qa, qb)
    assert port.dropped == ref.dropped == 10 and port.screen_angle == ref.screen_angle == 90
    da, db = port.drain(), ref.drain()
    assert len(da) == len(db) == len(ma) == 20
    for sa, sb in zip(da, db):
        assert sa.timestamp == sb.timestamp
        np.testing.assert_array_equal(sa.gyro, sb.gyro)
        np.testing.assert_array_equal(sa.accel, sb.accel)
    assert port.drain() == [] and port.snapshot()[1] == []
    for x, y, z in np.random.default_rng(4).uniform(-3, 3, (5, 3)):
        np.testing.assert_array_equal(timu.quat_from_euler_zxy(x, y, z),
                                      jimu.quat_from_euler_zxy(x, y, z))
    assert timu.screen_orientation_angle("landscape_right") == 270


def test_imu_buffer_round_trip_with_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=4)
    samples = [jimu.ImuSample(0.1 * i, rng.normal(size=3), rng.normal(size=3)) for i in range(40)]
    buf = jimu.pack_imu_buffer(q, samples)
    q2, s2 = timu.unpack_imu_buffer(buf)
    np.testing.assert_array_equal(q2, q)
    assert len(s2) == 35                                  # the 256-double budget
    back = timu.pack_imu_buffer(q2, s2)
    np.testing.assert_array_equal(back, buf)
    np.testing.assert_array_equal(timu.pack_imu_buffer(q, samples), buf)
    q3, s3 = jimu.unpack_imu_buffer(back)
    np.testing.assert_array_equal(q3, q)
    assert [s.timestamp for s in s3] == [s.timestamp for s in s2]


def test_capture_feeds_find_camera_pose_with_imu():
    """The capture layer's snapshot drives the fused pose on the CPU: the
    rotation is the orientation mirrored in x and inverted, as the
    reference does (system.cpp:67-70)."""
    cfg = SlamConfig(width=128, height=96, cell_size=32, window_size=4, max_landmarks=64,
                     ransac_iters=8, ba_iters=1, pyramid_levels=2, klt_iters=3,
                     min_init_keypoints=4)
    slam = AlvaAR(128, 96, fov=60.0, config=cfg, device="cpu")
    cap = timu.ImuCapture(platform="android")
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    for i, (b, g, a) in enumerate([(15.0, -5.0, 30.0), (20.0, 0.0, 45.0)]):
        cap.push_orientation(b, g, a)
        cap.push_motion(0.1 * i, (0.1, 0, 0), (0, 0, 0.2))
        q, motion = cap.snapshot()
        T = slam.find_camera_pose_with_imu(frame, q, motion)
        cap.drain()
        w, x, y, z = q[0], q[1], -q[2], -q[3]            # conj of (w, -x, y, z)
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        assert T.shape == (4, 4) and np.isfinite(T).all()
        np.testing.assert_allclose(T[:3, :3], R, atol=1e-6)
