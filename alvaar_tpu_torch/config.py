"""SLAM configuration — the PyTorch port's twin of ``alvaar_tpu.config``.

Same fields, same defaults, same presets as the JAX package's frozen
``SlamConfig`` (alvaar_tpu/config.py), so a configuration means the same
thing on both sides.  It is duplicated rather than imported because
importing anything under ``alvaar_tpu`` pulls in JAX.

``use_pallas`` is kept for field parity only: in the port the KLT path
follows the tensor's device alone (the CUDA kernel for CUDA tensors, the
plain twin for CPU tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # ---- image geometry -------------------------------------------------
    width: int = 640
    height: int = 480
    image_border: int = 20

    # ---- feature detection ----------------------------------------------
    cell_size: int = 40
    detector_quality: float = 0.001
    use_clahe: bool = False
    clahe_clip: float = 3.0

    # ---- KLT tracking ------------------------------------------------------
    pyramid_levels: int = 3
    klt_window: int = 9
    klt_iters: int = 16
    klt_eps: float = 0.01
    klt_err_max: float = 30.0
    klt_fb_dist: float = 0.5
    klt_prior_levels: int = 1
    track_base_level: int = 0
    # stage-2 compaction slots, on the CPU only: on CUDA stage 2 runs at
    # full width and this has no effect (frontend/step.py track_phase)
    klt_stage2_slots: int | None = 48

    # ---- robust estimation -------------------------------------------------
    ransac_iters: int = 100
    ransac_err_px: float = 3.0
    init_min_inliers: int = 10
    use_five_point: bool = True
    use_homography_init: bool = True
    p3p_min_inliers: int = 5
    use_p3p: bool = True

    # ---- solver budgets ------------------------------------------------------
    pnp_iters: int = 4
    ba_iters: int = 5
    huber_thresh: float = math.sqrt(5.9915)
    ba_min_covisibility: int = 25

    # ---- keyframe / map policy -----------------------------------------------
    window_size: int = 30
    max_landmarks: int = 4096
    desc_bag_size: int = 6
    kf_filtering_ratio: float = 0.95
    triang_max_reproj_px: float = 3.0
    match_nndr: float = 0.9
    match_max_hamming: float = 51.2

    # ---- bootstrap gates -------------------------------------------------------
    init_parallax_px: float = 40.0
    kf_parallax_px: float | None = None
    min_init_keypoints: int = 50
    max_pose_failures: int = 3

    # ---- plane detection ---------------------------------------------------------
    plane_iters: int = 250
    plane_min_points: int = 32
    plane_max_tilt_deg: float = 5.0
    plane_inlier_scale: float = 1.4

    # ---- compute -------------------------------------------------------------------
    dtype: str = "float32"
    use_pallas: bool = True
    seed: int = 0

    # ------------------------------------------------------------------
    @property
    def grid_cells(self) -> Tuple[int, int]:
        """(rows, cols) of the detection grid."""
        return (_cdiv(self.height, self.cell_size), _cdiv(self.width, self.cell_size))

    @property
    def max_keypoints(self) -> int:
        """Keypoint budget = number of grid cells."""
        r, c = self.grid_cells
        return r * c

    @property
    def pyr_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Static (h, w) of each pyramid level."""
        shapes = []
        h, w = self.height, self.width
        for _ in range(self.pyramid_levels):
            shapes.append((h, w))
            h, w = (h + 1) // 2, (w + 1) // 2
        return tuple(shapes)


FAST = SlamConfig(cell_size=50, klt_iters=20, ransac_iters=50, ba_iters=3)
AVERAGE = SlamConfig()
ACCURATE = SlamConfig(cell_size=30, klt_iters=30, ransac_iters=200, ba_iters=10)


def hd_serving(width: int = 1920, height: int = 1080) -> SlamConfig:
    """High-resolution preset: the grid cell scales with resolution so the
    feature budget stays near the 640x480 level, and KLT tracks at
    pyramid level 1."""
    cell = max(40, int(round(width / 20)))
    return SlamConfig(width=width, height=height, cell_size=cell,
                      track_base_level=1)
