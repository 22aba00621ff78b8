"""IMU-fusion demo on the port: findCameraPoseWithIMU on a synthetic
sequence.

The reference's IMU demo (reference examples/public/imu.html +
assets/imu.js: device-orientation quaternions fused with SLAM
translation, system.cpp:57-104).  Renders the synthetic scene, derives
per-frame orientation quaternions from the ground-truth rotations (the
role of DeviceOrientation events), and runs the fused pose path —
rotation from "IMU", translation accumulated from visual odometry.

Usage: python -m alvaar_tpu_torch.examples.imu_demo [--frames N] [--map-out PNG]
"""

import argparse
import sys

import numpy as np
import torch

from alvaar_tpu_torch import AlvaAR
from alvaar_tpu_torch.examples import render_scene
from alvaar_tpu_torch.geom.lie import matrix_to_quat


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), in float32 on the
    CPU."""
    return matrix_to_quat(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()


def main(argv=None, *, device="cuda", width=640, height=480, config=None) -> int:
    """The demo over ``argv``.  ``width``, ``height`` and ``config`` cut
    its size for the tests."""
    ap = argparse.ArgumentParser(prog="python -m alvaar_tpu_torch.examples.imu_demo")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--map-out", type=str, default=None,
                    help="write a map/trajectory debug render (PNG)")
    args = ap.parse_args(argv)

    rs = render_scene()
    scene = rs.TwoPlaneScene(np.random.default_rng(9), width=width, height=height,
                             fov=60.0, tex_scale=120.0)
    gt = rs.trajectory(args.frames, step=0.04, rot_step=0.004)
    slam = AlvaAR(width, height, fov=60.0, config=config, device=device)

    poses = []
    for i in range(len(gt)):
        frame = scene.render(gt[i])
        # the "IMU": device orientation (world→device, the DeviceOrientation
        # convention) with the reference's mirrored-x handedness — the
        # engine inverts and un-mirrors it back to camera-to-world
        # (system.cpp:67-70)
        q = rot_to_quat_wxyz(gt[i][:3, :3].T)
        quat = (float(q[0]), -float(q[1]), float(q[2]), float(q[3]))
        T = slam.find_camera_pose_with_imu(frame, quat, timestamp=i / 30.0)
        poses.append(T)

    T_last = poses[-1]
    print(f"processed {len(poses)} frames (fused pose always available: "
          f"status forced 1, reference system.cpp:103)")
    print(f"final fused pose t = {np.round(T_last[:3, 3], 3)}")
    R_err = T_last[:3, :3].T @ gt[-1][:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    print(f"fused-rotation error vs ground truth: {ang:.2f} deg")

    if args.map_out:
        from alvaar_tpu_torch.utils.view import render_map
        pts, colors = slam.get_map_points()
        render_map(pts, colors, trajectory=poses, path=args.map_out)
        print(f"wrote {args.map_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
