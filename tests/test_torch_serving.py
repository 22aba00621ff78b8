"""The port's serving front door (alvaar_tpu_torch/serving/server.py) on the
CPU: tests/test_serving.py's four tests against the port's server, the
JAX package's client against it (the wire protocol is the same), the
per-stage profile, the CUDA defaults of the entry points, and the port's
isolation from JAX."""

import inspect
import os
import pkgutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import alvaar_tpu_torch
from alvaar_tpu.serving.server import SlamClient as JSlamClient
from alvaar_tpu_torch import SlamConfig, bench
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.io import checkpoint
from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.parallel import multistream
from alvaar_tpu_torch.serving.server import _HELLO, MAGIC, VERSION, SlamClient, SlamServer
from alvaar_tpu_torch.utils.profiling import profile_step
from alvaar_tpu_torch.worldmap import state as tstate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = SlamConfig(width=128, height=96, cell_size=32, window_size=4,
                 max_landmarks=64, ransac_iters=8, ba_iters=1,
                 pyramid_levels=2, klt_iters=3, min_init_keypoints=4,
                 use_five_point=False, use_homography_init=False)


@pytest.fixture(scope="module")
def server():
    srv = SlamServer(num_streams=3, width=128, height=96, config=CFG, kf_slots=2,
                     device="cpu").start()
    yield srv
    srv.stop()
    assert srv.engine_error is None


def _frames(seed, n=6):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    return [np.clip(np.roll(base, shift=i, axis=1), 0, 255).astype(np.uint8) for i in range(n)]


class TestServing:
    def test_single_client_round_trip(self, server):
        c = SlamClient("127.0.0.1", server.port, 128, 96, want_points=True)
        try:
            statuses = []
            for k, f in enumerate(_frames(0)):
                status, pose, pts = c.process(f, timeout=600.0)
                statuses.append(status)
                assert c.last_frame_id == k + 1
                assert status in (1, 2, 3)
                if status == 1:
                    assert pose.shape == (4, 4)
                    np.testing.assert_allclose(pose[3], [0, 0, 0, 1], atol=1e-5)
            assert len(statuses) == 6
        finally:
            c.close()

    def test_concurrent_clients_independent(self, server):
        results = {}

        def run(cid):
            c = SlamClient("127.0.0.1", server.port, 128, 96)
            try:
                results[cid] = [c.process(f, timeout=600.0)[0] for f in _frames(cid, n=5)]
            finally:
                c.close()

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=900)
            assert not t.is_alive()
        assert set(results) == {0, 1, 2}
        for out in results.values():
            assert len(out) == 5

    def test_wrong_geometry_rejected(self, server):
        s = socket.create_connection(("127.0.0.1", server.port))
        s.sendall(_HELLO.pack(MAGIC, VERSION, 0, 64, 64, 45.0))
        s.settimeout(10.0)
        assert s.recv(1) == b""  # server closes on geometry mismatch
        s.close()

    def test_slot_recycled_after_disconnect(self, server):
        # 4 sequential connects to 3 slots would fail if slots leaked
        for seed in range(4):
            c = SlamClient("127.0.0.1", server.port, 128, 96)
            try:
                status, _, _ = c.process(_frames(seed, n=1)[0], timeout=600.0)
                assert status in (1, 2, 3)
            finally:
                c.close()

    def test_jax_client_against_port_server(self, server):
        """The JAX package's client speaks to the port's server: the wire
        protocol is the same byte for byte."""
        c = JSlamClient("127.0.0.1", server.port, 128, 96, want_points=True)
        try:
            for f in _frames(5, n=3):
                status, pose, pts = c.process(f, timeout=600.0)
                assert status in (1, 2, 3)
                assert pts.shape[1:] == (2,) and pts.dtype == np.float32
                if status == 1:
                    np.testing.assert_allclose(pose[3], [0, 0, 0, 1], atol=1e-5)
        finally:
            c.close()


def test_server_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamServer(num_streams=2, config=CFG)


def test_profile_step_stages_on_cpu():
    cam = Camera.from_fov(CFG.width, CFG.height, 60.0)
    state = tstate.init_map_state(CFG, "cpu")
    out = profile_step(state, _frames(1, n=1)[0], cam, CFG, reps=1)
    assert set(out) == {"preprocess", "track", "keyframe_pipeline", "finalize", "full_step"}
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out


@pytest.mark.parametrize("fn", [tstate.init_map_state, tstate.map_state_from_numpy,
                                tstate.init_multistream_state, tstate.multistream_state_from_numpy,
                                checkpoint.load_map, detector.db_init, detector.loop_db_from_numpy,
                                multistream.init_multistream_loopdbs,
                                multistream.loopdbs_from_numpy, SlamServer, bench.main,
                                bench.bench_multistream, bench.bench_multistream_loop,
                                bench.bench_single, bench.bench_ba_10k,
                                bench.bench_1080p_streams, bench.bench_real_video,
                                bench.bench_plane_720p, bench.bench_loop_closure])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_mesh_devices_come_from_the_caller():
    """The stream mesh has no device default: the caller names the
    devices, and the gather goes to block 0's device unless told."""
    assert inspect.signature(multistream.shard_states).parameters["devices"].default \
        is inspect.Parameter.empty
    step = inspect.signature(multistream.make_multistream_step).parameters["devices"]
    assert step.default is None and step.kind is inspect.Parameter.KEYWORD_ONLY
    assert inspect.signature(multistream.gather_states).parameters["device"].default is None


def test_port_and_chip_smoke_import_without_jax():
    """Every module of the port, and chip_smoke.py, import with JAX and the
    JAX package blocked, and their sources name neither."""
    mods = sorted(m.name for m in pkgutil.walk_packages(alvaar_tpu_torch.__path__,
                                                        "alvaar_tpu_torch."))
    for m in ("parallel.multistream", "io.frame_ring", "io.video", "io.capture", "io.camera",
              "io.imu", "utils.parity", "utils.stats", "utils.view", "utils.build",
              "utils.custom_ops", "solvers.pnp_kernel", "solvers.ba_kernels", "ops.hamming_kernel",
              "ops.image_kernels", "bench", "examples", "examples.demo", "examples.imu_demo",
              "examples.live_client", "examples.preproc_sandbox", "examples.video_demo"):
        assert "alvaar_tpu_torch." + m in mods, m
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'alvaar_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "alvaar_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "alvaar_tpu"), (p, line)
