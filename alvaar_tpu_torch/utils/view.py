"""Render/overlay helpers: the role of the reference's view layer
(reference examples/public/assets/view.js: ARCamView anchored-object
overlay, ARSimpleMap free-orbit map debug view with camera frustum).

Port of alvaar_tpu/utils/view.py.  Draws tracked keypoints and an axes
gizmo onto frames (pure numpy) and renders the map point cloud,
trajectory and camera frustum to an image with matplotlib (imported
lazily, Agg backend, headless).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def draw_points(gray: np.ndarray, points: np.ndarray,
                radius: int = 2, value: float = 255.0) -> np.ndarray:
    """Burn keypoint markers into a grayscale frame (the reference's
    per-frame dot overlay, video.html:175-183).  Returns a copy."""
    img = np.asarray(gray, np.float32).copy()
    h, w = img.shape
    for x, y in np.asarray(points, np.int32):
        if 0 <= x < w and 0 <= y < h:
            x0, x1 = max(0, x - radius), min(w, x + radius + 1)
            y0, y1 = max(0, y - radius), min(h, y + radius + 1)
            img[y0:y1, x0:x1] = value
    return img


def project_axes(T_wc: np.ndarray, fx: float, fy: float, cx: float,
                 cy: float, scale: float = 0.2) -> np.ndarray:
    """Project a world-origin axes gizmo into the camera: returns
    [4, 2] pixel coords (origin, +x, +y, +z endpoints) — the pose
    sanity overlay of ARCamView's anchored object."""
    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    pts_w = np.array([[0, 0, 0], [scale, 0, 0],
                      [0, scale, 0], [0, 0, scale]], np.float64)
    pc = (T_cw[:3, :3] @ pts_w.T).T + T_cw[:3, 3]
    z = np.clip(pc[:, 2], 1e-6, None)
    return np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)


def render_map(points: np.ndarray, colors: Optional[np.ndarray] = None,
               trajectory: Optional[Sequence[np.ndarray]] = None,
               path: str = "map.png", elev: float = -70.0,
               azim: float = -90.0) -> str:
    """Render the 3D map + camera trajectory to an image file (the
    ARSimpleMap debug view).  ``points`` [N, 3]; ``colors`` [N] gray
    intensities (get_map_points output); ``trajectory`` iterable of
    4x4 T_wc poses.  Returns the written path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    pts = np.asarray(points)
    if len(pts):
        c = (np.asarray(colors, np.float32) / 255.0
             if colors is not None else None)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2,
                   c=c, cmap="gray", vmin=0, vmax=1, depthshade=False)
    if trajectory is not None:
        tr = np.asarray([np.asarray(T)[:3, 3] for T in trajectory])
        if len(tr):
            ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], "r-", linewidth=1.5)
            # frustum glyph at the last camera
            T = np.asarray(trajectory[-1], np.float64)
            o = T[:3, 3]
            for dx, dy in ((0.5, 0.4), (-0.5, 0.4), (0.5, -0.4),
                           (-0.5, -0.4)):
                tip = o + T[:3, :3] @ (0.3 * np.array([dx, dy, 1.0]))
                ax.plot(*np.stack([o, tip], 1), "b-", linewidth=0.8)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
