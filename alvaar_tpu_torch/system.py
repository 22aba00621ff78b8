"""AlvaAR-compatible facade over the PyTorch pipeline.

Port of the single-stream surface of alvaar_tpu/system.py: construction
from (width, height, fov); ``find_camera_pose`` and its deferred form
``find_camera_pose_async`` (a :class:`PendingResult`); ``process_frames``
over a sequence; ``find_camera_pose_with_imu``; ``find_plane``;
``get_frame_points`` and ``get_map_points``; ``save_map``/``load_map``;
loop closure (``enable_loop_closure``) with ``relocalize``; ``reset``.
Status codes are the reference's (1 = tracking → pose returned; 2 =
reset → None; 3 = initializing → None).

The map state stays on the device across calls; each frame costs one
upload and one small packed readback (status, pose, counts), plus the
host syncs of the data-dependent branches in the step
(``host_bool.syncs`` counts them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.frontend.step import slam_step
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3, matrix_to_quat, quat_conj, quat_to_matrix
from alvaar_tpu_torch.io import checkpoint
from alvaar_tpu_torch.loopclosure import detector
from alvaar_tpu_torch.ops.detect import detect_grid
from alvaar_tpu_torch.ops.image import rgba_to_gray
from alvaar_tpu_torch.ops.orb import describe
from alvaar_tpu_torch.solvers.plane import find_plane_ransac
from alvaar_tpu_torch.worldmap.state import apply_world_correction, init_map_state


def pose_to_array(T_wc: np.ndarray) -> np.ndarray:
    """4x4 → 16-float column-major array (the reference's wire format)."""
    return np.asarray(T_wc, np.float32).T.reshape(-1).copy()


def pose_to_three(T_wc: np.ndarray) -> tuple:
    """4x4 T_wc → (quaternion (x, y, z, w), position (x, y, z)) with the
    handedness flips of the reference's Three.js connector: quaternion
    (−x, y, z, w), position (x, −y, −z)."""
    q = matrix_to_quat(torch.as_tensor(np.asarray(T_wc[:3, :3], np.float32))).numpy()
    t = np.asarray(T_wc[:3, 3])
    return (np.array([-q[1], q[2], q[3], q[0]], np.float32),
            np.array([t[0], -t[1], -t[2]], np.float32))


class PendingResult:
    """Deferred per-frame result of :meth:`AlvaAR.find_camera_pose_async`.

    Holds the step's device outputs.  On CUDA the packed 20-float result
    [status, pose (16, row-major), num_tracked, num_3d, is_keyframe] starts
    its copy into pinned host memory at once, behind a CUDA event; reading
    any property waits for that event only."""

    __slots__ = ("_packed", "_points", "_points_valid", "_host", "_event", "_np")

    def __init__(self, packed, points, points_valid):
        self._packed, self._points, self._points_valid = packed, points, points_valid
        self._np = None
        self._host = self._event = None
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def _sync(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
                self._np = self._host.numpy()
            else:
                self._np = self._packed.numpy()
        return self._np

    @property
    def status(self) -> int:
        return int(self._sync()[0])

    @property
    def pose(self) -> Optional[np.ndarray]:
        """4x4 T_wc when tracking (status 1), else None."""
        p = self._sync()
        if int(p[0]) != 1:
            return None
        return p[1:17].reshape(4, 4).astype(np.float32)

    @property
    def num_tracked(self) -> int:
        return int(self._sync()[17])

    @property
    def num_3d(self) -> int:
        return int(self._sync()[18])

    @property
    def is_keyframe(self) -> bool:
        return bool(self._sync()[19] > 0.5)

    def frame_points(self) -> np.ndarray:
        pts = self._points.cpu().numpy()
        return pts[self._points_valid.cpu().numpy()].astype(np.int32)

    @staticmethod
    def drain(results) -> None:
        """Wait for many pending results at once: their copies run in
        stream order, so after waiting for the newest the rest are done."""
        for r in reversed([r for r in results if r._np is None]):
            r._sync()


class AlvaAR:
    """Monocular visual SLAM with the AlvaAR API, on PyTorch.

    ``device="cuda"`` (the default) raises when CUDA is not available; the
    port never moves to the CPU on its own.  Tests pass ``device="cpu"``.
    ``enable_loop_closure`` keeps a ring database of ``loop_db_capacity``
    keyframes; keyframes younger than ``max(loop_delay, window_size)`` are
    not loop candidates (they are still inside the local BA window)."""

    def __init__(self, width: int, height: int, fov: float = 45.0,
                 config: Optional[SlamConfig] = None, device="cuda",
                 camera: Optional[Camera] = None, enable_loop_closure: bool = False,
                 loop_db_capacity: int = 256, loop_delay: int = 50):
        cfg = config or SlamConfig()
        if cfg.width != width or cfg.height != height:
            cfg = dataclasses.replace(cfg, width=width, height=height)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AlvaAR(device='cuda'): CUDA is not available")
        # the solvers and BA depend on full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = cfg
        self.camera = camera if camera is not None else Camera.from_fov(width, height, fov)
        self.state = init_map_state(cfg, self.device)
        self._last_out: Optional[PendingResult] = None
        self._last_ts: Optional[float] = None
        # IMU fusion accumulators
        self._imu_translation = np.zeros(3, np.float64)
        self._imu_prev_slam_t: Optional[np.ndarray] = None
        # loop closure
        self.loop_db = None
        self.last_loop = None
        self.last_loop_correction = None
        self.last_loop_inliers = 0
        self.loop_delay = max(loop_delay, cfg.window_size)
        if enable_loop_closure:
            self.loop_db = detector.db_init(loop_db_capacity, cfg.max_keypoints, self.device)

    # ------------------------------------------------------------------
    def _dt(self, timestamp: Optional[float]) -> float:
        if timestamp is None:
            self._last_ts = None
            return 1.0
        dt = 1.0 if self._last_ts is None else float(timestamp) - self._last_ts
        self._last_ts = float(timestamp)
        return dt if dt > 0 else 1.0

    def _upload(self, frames):
        """Frame(s) to the device; float64 goes up as float32, as JAX does
        without x64."""
        f = np.asarray(frames)
        if f.dtype == np.float64:
            f = f.astype(np.float32)
        return torch.as_tensor(f).to(self.device)

    def _step(self, frame, dt: float):
        gray = rgba_to_gray(frame) if frame.ndim == 3 else frame.to(torch.float32)
        self.state, out = slam_step(self.state, gray, self.camera, self.config, dt)
        return out

    def _dispatch(self, frame, timestamp) -> PendingResult:
        out = self._step(self._upload(frame), self._dt(timestamp))
        packed = torch.cat([
            out.status.reshape(1).to(torch.float32), out.pose_wc.reshape(-1),
            out.num_tracked.reshape(1).to(torch.float32),
            out.num_3d.reshape(1).to(torch.float32),
            out.is_keyframe.reshape(1).to(torch.float32)])
        self._last_out = PendingResult(packed, out.points, out.points_valid)
        return self._last_out

    def find_camera_pose(self, frame, timestamp: Optional[float] = None
                         ) -> Optional[np.ndarray]:
        """Run one SLAM iteration on a [H, W] gray or [H, W, 4] RGBA frame.
        Returns the 4x4 camera-to-world pose when tracking (status 1),
        else None.  ``timestamp`` (seconds) scales the motion prior."""
        res = self._dispatch(frame, timestamp)
        self._loop_closure_hooks(res)
        return res.pose

    def find_camera_pose_async(self, frame, timestamp: Optional[float] = None
                               ) -> PendingResult:
        """One SLAM iteration whose result is read later (see
        :class:`PendingResult`).  The step's own branches still sync the
        host several times per frame, and with loop closure on the
        keyframe flag is read every frame."""
        res = self._dispatch(frame, timestamp)
        self._loop_closure_hooks(res)
        return res

    def process_frames(self, frames, timestamps=None, chunk: int = 32):
        """SLAM over a sequence: [N, H, W] gray or [N, H, W, 4] RGBA frames
        (or a list), staged to the device ``chunk`` frames at a time.
        Returns (statuses [N] int32, poses [N, 4, 4] float32); pose rows
        are meaningful where the status is 1."""
        frames = np.asarray(frames)
        n = frames.shape[0]
        if timestamps is None:
            dts = np.ones(n, np.float32)
        else:
            ts = np.asarray(timestamps, np.float64)
            dts = np.concatenate([[1.0], np.diff(ts)]).astype(np.float32)
            dts[dts <= 0] = 1.0
            self._last_ts = float(ts[-1])
        statuses, poses = [], []
        for lo in range(0, n, chunk):
            block = self._upload(frames[lo:lo + chunk])
            for j in range(block.shape[0]):
                out = self._step(block[j], float(dts[lo + j]))
                statuses.append(out.status)
                poses.append(out.pose_wc)
        self._last_out = None
        return (torch.stack(statuses).to(torch.int32).cpu().numpy(),
                torch.stack(poses).cpu().numpy())

    @property
    def last_status(self) -> int:
        """Status of the last processed frame (0 before the first)."""
        return self._last_out.status if self._last_out is not None else 0

    @property
    def last_is_keyframe(self) -> bool:
        return self._last_out is not None and self._last_out.is_keyframe

    # ------------------------------------------------------------------
    # loop closure
    # ------------------------------------------------------------------
    def _loop_closure_hooks(self, res: PendingResult) -> None:
        if self.loop_db is None:
            return
        # every keyframe reaches the database; bootstrap keyframes are
        # backfilled at the first tracking keyframe (see _on_keyframe)
        if res.status == 1 and res.is_keyframe:
            self._on_keyframe()
        # a reset is near: recover the pose against the database first
        elif res.status == 1 and int(self.state.pose_failures) >= 2:
            self._try_autorelocalize()

    def _push_kf_to_db(self, slot: int) -> None:
        st = self.state
        lm = st.kf_obs_lm[slot]
        valid = st.kf_obs_valid[slot] & st.lm_valid[lm]
        self.loop_db = detector.db_add(
            self.loop_db, st.lm_desc[lm], st.lm_pos[lm], st.lm_is3d[lm] & valid, valid,
            st.kf_id[slot], st.kf_pose[slot])

    def _on_keyframe(self) -> None:
        """Query the database with the new keyframe, push it, and on a
        verified loop re-gauge the map onto the loop-consistent frame."""
        st = self.state
        slot = int(st.cur_kf_slot)
        if int(self.loop_db.ptr) == 0:
            # backfill the keyframes made before the first hook (the
            # bootstrap, at status 3), in id order, with their geometry as
            # triangulated now
            ids = st.kf_id.cpu().numpy()
            live = st.kf_valid.cpu().numpy()
            older = [i for i in range(len(ids)) if live[i] and i != slot and ids[i] < ids[slot]]
            for s2 in sorted(older, key=lambda i: ids[i]):
                self._push_kf_to_db(s2)
        lm = st.kf_obs_lm[slot]
        desc = st.lm_desc[lm]
        valid = st.kf_obs_valid[slot] & st.lm_valid[lm]
        self.loop_db, res = detector.detect_loop(self.loop_db, desc, valid, st.kf_id[slot],
                                                 delay=self.loop_delay)
        self._push_kf_to_db(slot)
        self.last_loop = res if bool(res.found) else None
        self.last_loop_correction = None
        if self.last_loop is None:
            return
        # verification refines from the current pose (a cold P3P takes the
        # far branch on near-coplanar matches)
        r_pose, r_ok, n_in = detector.verify_loop(
            self.loop_db, res.entry, desc, st.kf_obs_px[slot], valid, self.camera,
            st.kf_pose[slot])
        self.last_loop_inliers = int(n_in)
        if bool(r_ok):
            dT = r_pose.inverse().compose(st.pose)      # world_old → world_loop
            self.state = apply_world_correction(st, dT)
            self.last_loop_correction = dT.matrix().cpu().numpy()

    def relocalize(self) -> Optional[np.ndarray]:
        """Pose recovery against the loop database from the current frame
        (descriptor votes, then P3P-LMedS on the top entries).  Returns a
        4x4 T_wc or None."""
        res = self._relocalize_solve()
        if res is None or not bool(res.success):
            return None
        return res.pose.inverse().matrix().cpu().numpy()

    def _relocalize_solve(self):
        if self.loop_db is None or self._last_out is None:
            return None
        st = self.state
        if int(torch.sum(st.kp_valid)) >= 20:
            desc, bearings, valid = (st.lm_desc[st.kp_lm], self.camera.bearing(st.kp_und),
                                     st.kp_valid)
        else:
            # tracks are gone: describe fresh features of the last frame
            desc, bearings, valid = self._describe_current_frame()
        return detector.relocalize_topk(self.loop_db, desc, bearings, valid, st.rng,
                                        focal=self.camera.focal)

    def _describe_current_frame(self):
        """Fresh detection + description on the last frame
        (``state.prev_pyr[0]``), described at the tracking level like the
        database entries.  Returns (desc [K, 8], bearings [K, 3], valid
        [K])."""
        cfg, cam, st = self.config, self.camera, self.state
        det = detect_grid(st.prev_pyr[0], torch.zeros((1, 2), device=self.device),
                          torch.zeros((1,), dtype=torch.bool, device=self.device),
                          cell=cfg.cell_size, border=cfg.image_border,
                          quality=st.detect_quality)
        desc, _ = describe(st.prev_pyr[cfg.track_base_level],
                           det.xy / float(2 ** cfg.track_base_level), det.valid)
        return desc, cam.bearing(cam.undistort(det.xy)), det.valid

    def _try_autorelocalize(self) -> bool:
        """On consecutive PnP failures, snap the pose to a database-recovered
        one so the next PnP starts from a loop-consistent prior."""
        res = self._relocalize_solve()
        if res is None or not bool(res.success):
            return False
        st = self.state
        self.state = st.replace(pose=SE3(res.pose.q, res.pose.t),
                                vel=torch.zeros_like(st.vel),
                                pose_failures=torch.zeros_like(st.pose_failures),
                                p3p_req=torch.ones_like(st.p3p_req))
        return True

    # ------------------------------------------------------------------
    # the rest of the API
    # ------------------------------------------------------------------
    def find_camera_pose_with_imu(self, frame, orientation, motion=None,
                                  timestamp: Optional[float] = None) -> np.ndarray:
        """IMU attitude + visual-odometry translation: the rotation comes
        from the device orientation quaternion (w, x, y, z), mirrored in x
        and inverted as the reference does; the translation is the sum of
        SLAM translation deltas while tracking.  ``motion`` samples are
        accepted and unused, as in the reference.  Always returns a pose."""
        res = self._dispatch(frame, timestamp)
        qw, qx, qy, qz = [float(v) for v in orientation]
        q = torch.tensor([qw, -qx, qy, qz], dtype=torch.float32)
        R = quat_to_matrix(quat_conj(q)).numpy()
        if res.status == 1:
            slam_t = res._sync()[1:17].reshape(4, 4)[:3, 3]
            if self._imu_prev_slam_t is not None:
                self._imu_translation += slam_t - self._imu_prev_slam_t
            self._imu_prev_slam_t = slam_t.copy()
        else:
            self._imu_prev_slam_t = None
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = self._imu_translation.astype(np.float32)
        return T

    def find_plane(self, num_iterations: Optional[int] = None) -> Optional[np.ndarray]:
        """Dominant horizontal plane among the 3D points of the current
        frame; a 4x4 plane-to-world pose or None.  ``num_iterations``
        defaults to ``config.plane_iters``."""
        cfg, st = self.config, self.state
        bound3d = st.kp_valid & st.lm_valid[st.kp_lm] & st.lm_is3d[st.kp_lm]
        res = find_plane_ransac(
            st.rng, st.lm_pos[st.kp_lm], bound3d, st.pose.inverse().t,
            iters=num_iterations if num_iterations is not None else cfg.plane_iters,
            min_points=cfg.plane_min_points, max_tilt_deg=cfg.plane_max_tilt_deg,
            inlier_scale=cfg.plane_inlier_scale)
        if not bool(res.success):
            return None
        return res.pose.matrix().cpu().numpy()

    def get_frame_points(self) -> np.ndarray:
        """[N, 2] int32 tracked keypoint pixels of the last frame."""
        if self._last_out is None:
            return np.zeros((0, 2), np.int32)
        return self._last_out.frame_points()

    def get_map_points(self, colored: bool = True):
        """The 3D map as a point cloud: (points [N, 3] float32 world
        positions, colors [N] uint8 gray) when ``colored``, else the points."""
        st = self.state
        mask = (st.lm_valid & st.lm_is3d).cpu().numpy()
        pts = st.lm_pos.cpu().numpy()[mask]
        if not colored:
            return pts
        return pts, np.clip(st.lm_color.cpu().numpy()[mask], 0, 255).astype(np.uint8)

    def save_map(self, path: str) -> None:
        """Write the whole map to ``path`` (io/checkpoint.py; the JAX
        package's layout)."""
        checkpoint.save_map(path, self.state, self.config)

    def load_map(self, path: str) -> None:
        """Restore a map written by either package's ``save_map``; tracking
        resumes against it on the next frame."""
        self.state = checkpoint.load_map(path, self.config, self.device)
        self._last_ts = None

    def reset(self) -> None:
        """Full reset (the random stream carries on)."""
        self.state = init_map_state(self.config, self.device, rng=self.state.rng)
        self._last_out = None
        self._last_ts = None
        self._imu_translation[:] = 0
        self._imu_prev_slam_t = None
