"""The JAX package's examples (examples/*.py) on the port.

Each runs as ``python -m alvaar_tpu_torch.examples.<name>`` with the JAX
script's arguments and output lines, on the card (``main`` raises without
CUDA unless the caller passes ``device="cpu"``):

* ``demo``: frames -> ``find_camera_pose`` -> ``pose_to_three``, tracked
  points, ``find_plane(250)`` and per-stage timing;
* ``imu_demo``: ``find_camera_pose_with_imu`` with orientation from the
  ground truth, ``--map-out`` renders the map;
* ``live_client``: a camera, a video file or the synthetic scene streamed
  to ``SlamServer`` over TCP, ``--serve`` hosts the server;
* ``preproc_sandbox``: the frontend ops timed one by one;
* ``video_demo``: ``find_camera_pose`` over a video file (by default
  ``assets/video.mp4`` in the repository).

The synthetic scene is tests/render_scene_np.py of the repository.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the reference's demo video (examples/public/assets/video.mp4 of the
# reference project), read only from inside the repository
REFERENCE_VIDEO = os.path.join(ROOT, "assets", "video.mp4")


def render_scene():
    """tests/render_scene_np.py (``TwoPlaneScene``, ``trajectory``) from
    the repository's tests/ directory."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import render_scene_np
    return render_scene_np
