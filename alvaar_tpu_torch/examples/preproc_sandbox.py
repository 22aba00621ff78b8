"""Image-preprocessing sandbox on the port: run and time the frontend ops
standalone.

The counterpart of the reference's WebGL2 preprocessing sandbox
(reference examples/public/assets/webgl.js + examples/public/sandbox/
gpu.html: a scratchpad for GPU image ops, shipped unwired into the SLAM
path — README.md:153 roadmap).  Here the scratchpad drives the port's
production ops (ops/image.py, ops/detect.py), eager, on any input — a
video file, a camera, or the synthetic scene — and prints each op's time
per call: on the card, CUDA events around ``--reps`` back-to-back calls
after one warm-up call; with ``--cpu``, the host clock around them.

The last line times gray conversion, the pyramid and detection in
sequence.  The port does not fuse them: each op launches its own kernels
(the JAX package's script jits the three into one program).

Usage:
  python -m alvaar_tpu_torch.examples.preproc_sandbox            # synthetic 640x480
  python -m alvaar_tpu_torch.examples.preproc_sandbox --source video.mp4 --levels 4 --clahe
  python -m alvaar_tpu_torch.examples.preproc_sandbox --width 1920 --height 1080
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def get_frame(args) -> np.ndarray:
    if args.source == "synthetic":
        from alvaar_tpu_torch.examples import render_scene
        rs = render_scene()
        scene = rs.TwoPlaneScene(np.random.default_rng(3), width=args.width,
                                 height=args.height, fov=60.0, tex_scale=120.0)
        return scene.render(rs.trajectory(1, step=0.04)[0])
    if args.source.startswith("/dev/video"):
        from alvaar_tpu_torch.io.camera import CameraCapture
        with CameraCapture(args.source, args.width, args.height) as cam:
            gray, _ = cam.read(timeout=5.0)
            return gray
    from alvaar_tpu_torch.io.video import VideoReader
    gray, _ = next(iter(VideoReader(args.source)))
    return gray


def time_per_call_ms(fn, reps: int, dev: torch.device) -> float:
    """Milliseconds per call over ``reps`` back-to-back calls: CUDA events
    on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="python -m alvaar_tpu_torch.examples.preproc_sandbox")
    ap.add_argument("--source", default="synthetic",
                    help="'synthetic' | video file | /dev/videoN")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--cell", type=int, default=40)
    ap.add_argument("--clahe", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run the ops on the CPU")
    args = ap.parse_args(argv)

    dev = torch.device("cpu" if args.cpu else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("preproc_sandbox runs on CUDA (or --cpu), and CUDA is not available")

    from alvaar_tpu_torch.ops import image as im
    from alvaar_tpu_torch.ops.detect import detect_grid, shi_tomasi_response

    frame = np.asarray(get_frame(args), np.float32)
    h, w = frame.shape
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"devices: [{dev} {name}]\nframe: {w}x{h} ({args.source})")
    gray = torch.as_tensor(frame, device=dev)
    no_xy = torch.zeros((1, 2), device=dev)
    no_valid = torch.zeros(1, dtype=torch.bool, device=dev)

    def bench(name, fn, *xs):
        out = fn(*xs)                  # warm-up
        ms = time_per_call_ms(lambda: fn(*xs), args.reps, dev)
        print(f"  {name:<28s} {ms:8.3f} ms")
        return out

    rgba = torch.stack([gray, gray, gray, torch.full_like(gray, 255.0)], -1)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"per-op timings ({clock}, mean of {args.reps} calls after one warm-up):")
    bench("rgba_to_gray", im.rgba_to_gray, rgba)
    if args.clahe:
        gray = bench("clahe", im.clahe, gray)
    bench("gaussian_blur3", im.gaussian_blur3, gray)
    bench(f"build_pyramid(L={args.levels})",
          lambda g: im.build_pyramid(g, args.levels), gray)
    bench("sobel_gradients", im.sobel_gradients, gray)
    bench("shi_tomasi_response", shi_tomasi_response, gray)
    det = bench(
        f"detect_grid(cell={args.cell})",
        lambda g: detect_grid(g, no_xy, no_valid, cell=args.cell, border=20), gray)
    n = int(det.valid.sum())
    print(f"detections: {n} corners "
          f"(adapted quality -> {float(det.new_quality):.2e})")

    # the preprocessing the engine runs, op after op (not fused)
    def preproc(rgba):
        g = im.rgba_to_gray(rgba)
        pyr = im.build_pyramid(g, args.levels)
        d = detect_grid(g, no_xy, no_valid, cell=args.cell, border=20)
        return pyr[-1], d.xy
    bench("gray+pyramid+detect", preproc, rgba)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
