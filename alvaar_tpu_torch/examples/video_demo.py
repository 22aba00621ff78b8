"""Run the SLAM engine end to end on a real video file, on the port.

The reference's video demo (reference examples/public/video.html:148-195:
decode frame → findCameraPose → overlay).  Decodes with the native libav
decoder (io/video.py), feeds grayscale frames and their timestamps
through ``AlvaAR``, and prints tracking statistics and the trajectory
extent.

Usage:
    python -m alvaar_tpu_torch.examples.video_demo [video_path] [--frames N] [--fov DEG]
                                                   [--save NPZ]

The default input is assets/video.mp4 in the repository (the reference's
demo video); the repository does not hold it yet, and then the demo says
so and exits with status 2.
"""

import argparse
import os
import sys
import time

import numpy as np

from alvaar_tpu_torch.examples import REFERENCE_VIDEO as DEFAULT_VIDEO


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="python -m alvaar_tpu_torch.examples.video_demo")
    ap.add_argument("video", nargs="?", default=DEFAULT_VIDEO)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--fov", type=float, default=45.0)
    ap.add_argument("--save", type=str, default=None,
                    help="save trajectory .npz (poses, statuses, stamps)")
    args = ap.parse_args(argv)
    if not os.path.isfile(args.video):
        print(f"video_demo: {args.video} is absent (the repository does not hold the "
              f"reference's demo video yet); nothing to run")
        return 2

    from alvaar_tpu_torch import AlvaAR
    from alvaar_tpu_torch.io.video import VideoReader
    from alvaar_tpu_torch.utils.stats import Stats

    v = VideoReader(args.video)
    print(f"video: {v.width}x{v.height} @ {v.fps:.1f} fps, "
          f"{v.nframes or '?'} frames")
    alva = AlvaAR(v.width, v.height, fov=args.fov, device=device)
    stats = Stats()

    poses, statuses, stamps = [], [], []
    n_tracked = 0
    t_start = time.time()
    for i, (gray, pts) in enumerate(v):
        if i >= args.frames:
            break
        with stats.timeit("slam"):
            pose = alva.find_camera_pose(gray, timestamp=pts)
        statuses.append(alva.last_status)
        stamps.append(pts)
        if pose is not None:
            n_tracked += 1
            poses.append(pose)
    wall = time.time() - t_start
    n = len(statuses)

    statuses = np.asarray(statuses)
    print(f"processed {n} frames in {wall:.1f}s "
          f"({n / wall:.1f} fps incl. decode and the kernel build)")
    print(f"tracking: {n_tracked}/{n} frames "
          f"(init {np.sum(statuses == 3)}, reset {np.sum(statuses == 2)})")
    print(f"slam step: {stats.stages['slam'].avg_ms:.2f} ms avg")
    if poses:
        t = np.stack([p[:3, 3] for p in poses])
        ext = t.max(0) - t.min(0)
        print(f"trajectory extent (monocular scale): "
              f"[{ext[0]:.3f}, {ext[1]:.3f}, {ext[2]:.3f}]")
        finite = np.isfinite(np.stack(poses)).all()
        print(f"poses finite: {finite}")
    if args.save and poses:
        np.savez(args.save, poses=np.stack(poses), statuses=statuses,
                 stamps=np.asarray(stamps))
        print(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
