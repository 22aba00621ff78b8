"""End-to-end demo on the port: the reference's video.html loop
(reference examples/public/video.html:148-195) — feed frames, read poses
and tracked points, anchor a plane, print per-stage timing.

Run: python -m alvaar_tpu_torch.examples.demo [num_frames]
"""

import sys

import numpy as np

from alvaar_tpu_torch import AlvaAR
from alvaar_tpu_torch.examples import render_scene
from alvaar_tpu_torch.system import pose_to_three
from alvaar_tpu_torch.utils.stats import Stats


def main(argv=None, *, device="cuda", width=640, height=480, config=None) -> int:
    """The demo over ``argv`` ([num_frames], default 60).  ``width``,
    ``height`` and ``config`` cut its size for the tests."""
    argv = sys.argv[1:] if argv is None else argv
    n_frames = int(argv[0]) if argv else 60
    rs = render_scene()
    scene = rs.TwoPlaneScene(np.random.default_rng(0), width=width, height=height,
                             fov=60.0, tex_scale=120.0)
    gt = rs.trajectory(n_frames, step=0.04)

    slam = AlvaAR(width, height, fov=60.0, config=config, device=device,
                  enable_loop_closure=False)
    stats = Stats()

    for i in range(n_frames):
        with stats.timeit("video"):
            frame = scene.render(gt[i])
        with stats.timeit("slam"):
            pose = slam.find_camera_pose(frame)

        if pose is not None:
            quat, pos = pose_to_three(pose)
            pts = slam.get_frame_points()
            print(f"frame {i:3d}: status {slam.last_status}  "
                  f"pos [{pos[0]:+.3f} {pos[1]:+.3f} {pos[2]:+.3f}]  "
                  f"{len(pts)} pts")
        else:
            print(f"frame {i:3d}: status {slam.last_status} "
                  f"({'initializing' if slam.last_status == 3 else 'reset'})")

    plane = slam.find_plane(250)
    if plane is not None:
        print(f"plane anchored at {plane[:3, 3].round(3)}")
    print("timing:", stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
