"""IMU capture layer: orientation tracking + motion sample queue.

Port of alvaar_tpu/io/imu.py: the host-side counterpart of the reference's
browser IMU stack (reference examples/public/assets/imu.js).
DeviceOrientation Euler angles become a world-frame orientation
quaternion (imu.js:170-186), DeviceMotion rotation-rate/acceleration
samples accumulate in a queue drained once per frame (imu.js:188-202,
cleared by imu.js:229-231 after each findCameraPoseWithIMU), and the
platform-specific world transform aligns the device frame with the render
world (imu.js:170-172: iOS -90 deg about x, Android +90 deg about y).

Plain numpy + threading: capture is a host concern.  The device path
consumes the per-frame orientation quaternion::

    orientation, motion = cap.snapshot()
    pose = alva.find_camera_pose_with_imu(frame, orientation, motion)

Sources feeding it call ``push_orientation`` / ``push_motion`` from their
own reader thread (serial IMU, sensor bridge, replay file, ...).

Quaternions are (w, x, y, z), as in alvaar_tpu_torch/geom/lie.py.
"""

from __future__ import annotations

import math
import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


class ImuSample(NamedTuple):
    """One DeviceMotion-equivalent sample (imu.js:188-200)."""
    timestamp: float  # seconds
    gyro: np.ndarray   # [3] rad/s (gx, gy, gz)
    accel: np.ndarray  # [3] m/s^2, gravity-free (ax, ay, az)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(w,x,y,z) Hamilton product."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        ax * bw + aw * bx + ay * bz - az * by,
        ay * bw + aw * by + az * bx - ax * bz,
        az * bw + aw * bz + ax * by - ay * bx,
    ], np.float64)


def quat_from_axis_angle(axis: Sequence[float], angle: float) -> np.ndarray:
    ax = np.asarray(axis, np.float64)
    ax = ax / (np.linalg.norm(ax) or 1.0)
    h = 0.5 * angle
    return np.concatenate([[math.cos(h)], math.sin(h) * ax])


def quat_from_euler_zxy(x: float, y: float, z: float) -> np.ndarray:
    """Intrinsic ZXY Euler (radians) → quaternion — the DeviceOrientation
    convention (imu.js:176-180 fromEuler(..., 'ZXY'): beta about x, gamma
    about y, alpha about z, applied z-first)."""
    cx, sx = math.cos(x / 2), math.sin(x / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    cz, sz = math.cos(z / 2), math.sin(z / 2)
    # q = qz * qx * qy (ZXY intrinsic)
    return np.array([
        cx * cy * cz - sx * sy * sz,
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz + sx * sy * cz,
    ], np.float64)


def world_transform(platform: str) -> np.ndarray:
    """Device→render-world alignment quaternion (imu.js:170-172): iOS
    mounts the device frame -90 deg about x, Android +90 deg about y."""
    if platform == "ios":
        return quat_from_axis_angle((1.0, 0.0, 0.0), -math.pi / 2)
    if platform == "android":
        return quat_from_axis_angle((0.0, 1.0, 0.0), math.pi / 2)
    if platform == "none":
        return np.array([1.0, 0.0, 0.0, 0.0])
    raise ValueError(f"unknown platform {platform!r} "
                     "(expected 'ios', 'android' or 'none')")


def screen_orientation_angle(orientation: str) -> int:
    """Screen-rotation compensation angle in degrees
    (imu.js:204-221: landscape_left=90, landscape_right=270, else 0)."""
    return {"landscape_left": 90, "landscape_right": 270}.get(orientation, 0)


class ImuCapture:
    """Thread-safe orientation tracker + bounded motion queue.

    Mirrors the reference IMU object's observable behavior:
      * ``push_orientation(beta, gamma, alpha)`` (degrees, the
        DeviceOrientation event fields) updates ``orientation`` through
        the platform world transform, gated by the same change test
        ``8 * (1 - dot(old, new)) > eps`` (imu.js:182-185);
      * ``push_motion(...)`` appends to the sample queue (imu.js:188-200);
      * ``drain()`` returns-and-clears the queue — the per-frame consume
        analogous to imu.html's read + ``imu.clear()``.

    The queue is bounded (drop-oldest) so a stalled consumer cannot grow
    memory — a divergence from the reference's unbounded array, which
    only survives because its browser loop always drains.
    """

    EPS = 1e-6

    def __init__(self, platform: str = "android", max_samples: int = 512):
        self._world = world_transform(platform)
        self._lock = threading.Lock()
        self._motion: List[ImuSample] = []
        self._max = int(max_samples)
        self.orientation = np.array([1.0, 0.0, 0.0, 0.0])  # (w,x,y,z)
        self.screen_angle = 0
        self.dropped = 0

    # ---- producers (reader threads) -----------------------------------
    def push_orientation(self, beta_deg: float, gamma_deg: float,
                         alpha_deg: float) -> bool:
        """Feed one DeviceOrientation-style event; returns True when the
        tracked orientation actually moved (past the change gate)."""
        d2r = math.pi / 180.0
        q = quat_mul(self._world,
                     quat_from_euler_zxy(beta_deg * d2r, gamma_deg * d2r,
                                         alpha_deg * d2r))
        with self._lock:
            if 8.0 * (1.0 - float(np.dot(self.orientation, q))) > self.EPS:
                self.orientation = q
                return True
        return False

    def push_motion(self, timestamp: float, gyro: Sequence[float],
                    accel: Sequence[float]) -> None:
        s = ImuSample(float(timestamp),
                      np.asarray(gyro, np.float64),
                      np.asarray(accel, np.float64))
        with self._lock:
            self._motion.append(s)
            if len(self._motion) > self._max:
                del self._motion[0]
                self.dropped += 1

    def set_screen_orientation(self, orientation: str) -> None:
        with self._lock:
            self.screen_angle = screen_orientation_angle(orientation)

    # ---- consumer (per-frame) ------------------------------------------
    def drain(self) -> List[ImuSample]:
        """Return and clear all queued motion samples (imu.js clear())."""
        with self._lock:
            out, self._motion = self._motion, []
        return out

    def snapshot(self):
        """(orientation (w,x,y,z), motion samples) without clearing."""
        with self._lock:
            return self.orientation.copy(), list(self._motion)


def pack_imu_buffer(orientation_wxyz: np.ndarray,
                    samples: Sequence[ImuSample],
                    max_samples: int = 35) -> np.ndarray:
    """Flatten to the reference wire layout (src/system.js:143-156):
    ``[qw, qx, qy, qz, n, (ts, gx, gy, gz, ax, ay, az) * n]`` f64, capped
    to the 256-double IMU buffer (system.js:66: 4 + 1 + 35*7 = 250)."""
    samples = list(samples)[:max_samples]
    buf = np.empty(5 + 7 * len(samples), np.float64)
    buf[:4] = np.asarray(orientation_wxyz, np.float64)
    buf[4] = len(samples)
    for i, s in enumerate(samples):
        o = 5 + 7 * i
        buf[o] = s.timestamp
        buf[o + 1:o + 4] = s.gyro
        buf[o + 4:o + 7] = s.accel
    return buf


def unpack_imu_buffer(buf: np.ndarray):
    """Inverse of pack_imu_buffer → (orientation, [ImuSample])."""
    buf = np.asarray(buf, np.float64)
    n = int(buf[4])
    out = []
    for i in range(n):
        o = 5 + 7 * i
        out.append(ImuSample(buf[o], buf[o + 1:o + 4].copy(),
                             buf[o + 4:o + 7].copy()))
    return buf[:4].copy(), out
