"""Live/online-stream SLAM client on the port: camera or video →
SlamServer over TCP.

The reference's live path is examples/public/camera.html (getUserMedia →
per-frame findCameraPose in the browser); this is its serving-era
counterpart: any machine with a camera streams frames to the serving
front door (alvaar_tpu_torch.serving.server, on the card) and gets poses
back at wire latency.  Sources:

  --source /dev/video0      V4L2 camera (io/camera.py, stdlib)
  --source path/to.mp4      video file, replayed at its native fps
  --source synthetic        rendered synthetic scene (no hardware needed)

With --serve the script also hosts a local SlamServer, so the demo is
self-contained:
  python -m alvaar_tpu_torch.examples.live_client --serve --source synthetic
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def frame_source(name: str, n_synthetic: int, width: int = 640, height: int = 480):
    """Yield (gray [H, W], wall-paced) frames + declared geometry;
    ``width`` and ``height`` size the synthetic scene."""
    if name.startswith("/dev/video"):
        from alvaar_tpu_torch.io.camera import CameraCapture
        cam = CameraCapture(name)
        print(f"camera {name}: {cam.width}x{cam.height} "
              f"fourcc=0x{cam.pixelformat:08x}")

        def gen():
            for gray, _ts in cam.frames():
                yield gray
        return gen(), cam.width, cam.height
    if name == "synthetic":
        from alvaar_tpu_torch.examples import render_scene
        rs = render_scene()
        scene = rs.TwoPlaneScene(np.random.default_rng(7), width=width, height=height,
                                 fov=60.0, tex_scale=120.0)
        gt = rs.trajectory(n_synthetic, step=0.04)

        def gen():
            for i in range(len(gt)):
                yield scene.render(gt[i])
        return gen(), width, height
    # video file, paced at native fps
    from alvaar_tpu_torch.io.video import VideoReader
    reader = VideoReader(name)
    spf = 1.0 / (reader.fps or 30.0)

    def gen():
        nxt = time.time()
        for gray, _ts in reader:
            nxt += spf
            delay = nxt - time.time()
            if delay > 0:
                time.sleep(delay)
            yield gray
    return gen(), reader.width, reader.height


def main(argv=None, *, device="cuda", width=640, height=480, config=None) -> int:
    """The client over ``argv``; the server of ``--serve`` runs on
    ``device``.  ``width``, ``height`` (the synthetic scene) and
    ``config`` (the server's) cut its size for the tests."""
    ap = argparse.ArgumentParser(prog="python -m alvaar_tpu_torch.examples.live_client")
    ap.add_argument("--source", default="synthetic",
                    help="/dev/videoN | video file | 'synthetic'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7026)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--frames", type=int, default=120,
                    help="frame cap (synthetic length)")
    ap.add_argument("--serve", action="store_true",
                    help="also run a local SlamServer (self-contained demo)")
    args = ap.parse_args(argv)

    frames, w, h = frame_source(args.source, args.frames, width, height)

    from alvaar_tpu_torch.serving.server import SlamClient, SlamServer
    srv = None
    if args.serve:
        srv = SlamServer(num_streams=4, width=w, height=h, fov=args.fov,
                         host=args.host, port=args.port, config=config,
                         device=device).start()
        args.port = srv.port
        print(f"serving on {args.host}:{srv.port}")

    client = SlamClient(args.host, args.port, w, h, fov=args.fov,
                        want_points=True)
    n = tracked = 0
    t0 = time.time()
    try:
        for gray in frames:
            if n >= args.frames:
                break
            status, pose, pts = client.process(
                np.asarray(gray, np.float32).astype(np.uint8), timeout=600.0)
            n += 1
            if status == 1:
                tracked += 1
                t = pose[:3, 3]
                print(f"[{n:4d}] pose t=({t[0]:+.3f},{t[1]:+.3f},"
                      f"{t[2]:+.3f}) {len(pts)} pts")
            else:
                print(f"[{n:4d}] status={status}"
                      f" ({'lost' if status == 2 else 'initializing'})")
    finally:
        client.close()
        if srv is not None:
            srv.stop()
    dt = time.time() - t0
    print(f"{n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps wire), "
          f"{tracked} tracked")
    return 0 if tracked else 1


if __name__ == "__main__":
    raise SystemExit(main())
