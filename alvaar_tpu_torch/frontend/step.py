"""The per-frame SLAM step.

Port of alvaar_tpu/frontend/step.py (the single-stream path):
preprocess → motion prior → two-stage forward-backward KLT → [bootstrap |
PnP] → keyframe decision → [keyframe pipeline] → status and reset.
Where the JAX package compiles ``lax.cond``/``lax.switch`` branches into
one program, the port runs eager torch and branches in Python on device
scalars, each read through ``host_bool`` so a run can count its host
syncs.  The bootstrap runs the 5-point (or 8-point) essential RANSAC and,
with ``use_homography_init``, the homography RANSAC, and keeps the model
with more inliers by a select, not a branch.

Multi-stream serving (parallel/multistream.py) recomposes the phases as
the JAX package does: ``track_phase_batched`` runs the per-frame work of B
streams at once with the heavy RANSAC solves deferred (``defer_heavy``);
its three branches (first frame, initialization, tracking) are computed
for every stream and selected per stream, as under the JAX ``vmap``, with
no host sync, and its two KLT stages are one kernel launch each for all
streams.  ``recovery_phase``, ``init_essential_phase``, ``keyframe_phase``
and the reset then run on the streams that the scheduler elects, each
once on the stack of the elected rows (``*_phase_batched``): the
single-stream code under ``vmap``, every branch selected per row, the
RANSAC draws taken per row from each stream's own generator first.

Status codes: 1 = tracking, 2 = reset performed, 3 = initializing.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.ops.image import build_pyramid, clahe
from alvaar_tpu_torch.ops.klt import fb_klt_track
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.solvers.absolute import p3p_lmeds
from alvaar_tpu_torch.solvers.essential import RelativePoseResult, essential_ransac
from alvaar_tpu_torch.solvers.fivept import essential_ransac_5pt
from alvaar_tpu_torch.solvers.homography import homography_ransac
from alvaar_tpu_torch.solvers.pnp import pnp_refine
from alvaar_tpu_torch.solvers.ransac import uniform_draw
from alvaar_tpu_torch.worldmap.keyframe import create_keyframe, host_bool
from alvaar_tpu_torch.worldmap.state import (MapState, from_tensors, map_rows,
                                             reset_map_state, stack_states, state_row)


@dataclasses.dataclass
class StepOutput:
    status: torch.Tensor        # int: 1 tracking / 2 reset / 3 initializing
    pose_wc: torch.Tensor       # [4, 4] T_wc
    points: torch.Tensor        # [K, 2] tracked keypoint pixels
    points_valid: torch.Tensor  # [K]
    num_tracked: torch.Tensor
    num_3d: torch.Tensor
    is_keyframe: torch.Tensor


@dataclasses.dataclass
class TrackFlags:
    """Per-frame outcomes the serving layer schedules on (0-d, or [B]
    for a batched track phase)."""
    kf_req: torch.Tensor     # keyframe required (already reset-gated)
    p3p_need: torch.Tensor   # pose failed and P3P recovery was deferred
    init_gate: torch.Tensor  # bootstrap gate passed, essential solve deferred


def preprocess(gray, cfg: SlamConfig):
    """Optional CLAHE, then the float32 pyramid of the gray frame ([H, W],
    or a stack [B, H, W] of B streams' frames)."""
    img = gray.to(torch.float32)
    if cfg.use_clahe:
        img = (clahe(img, clip=cfg.clahe_clip) if img.dim() == 2
               else torch.stack([clahe(x, clip=cfg.clahe_clip) for x in img]))
    return build_pyramid(img, cfg.pyramid_levels)


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------

def _track_keypoints(state: MapState, pyr_cur, pose_prior: SE3, cam: Camera,
                     cfg: SlamConfig, allow_cond: bool = True) -> MapState:
    """Two-stage forward-backward KLT: 3D keypoints tracked at one level
    from their motion-prior projections; failures and 2D keypoints retried
    on the full pyramid from their previous positions.

    ``allow_cond``: permit the stage-2 compaction into
    ``klt_stage2_slots`` slots, a branch on a device scalar (one host
    sync), as the JAX package's ``allow_cond``.  Points are independent, so
    both branches give the same result."""
    proj, prior_ok = _motion_priors(state, pose_prior, cam, cfg)
    klt_args = _klt_args(cfg)
    L = cfg.track_base_level
    sc = float(2 ** L)
    pyr_p, pyr_c = state.prev_pyr[L:], pyr_cur[L:]
    pts_t, proj_t = state.kp_px / sc, proj / sc
    s1 = fb_klt_track(pyr_p, pyr_c, pts_t, proj_t, prior_ok,
                      levels=cfg.klt_prior_levels, search_r=4, **klt_args)
    stage2_mask = state.kp_valid & (~prior_ok | (prior_ok & ~s1.status))
    s2_levels = max(1, cfg.pyramid_levels - L)
    K = state.kp_px.shape[0]
    cap = cfg.klt_stage2_slots
    if allow_cond and cap is not None and cap < K and host_bool(torch.sum(stage2_mask) <= cap):
        # compact the stage-2 candidates into [cap] slots; only the
        # selected set matters (points are independent), and the stable
        # sort takes the same set as the JAX package's top_k
        _, idx = top_k(stage2_mask.to(torch.float32), cap)
        sel_valid = stage2_mask[idx]
        s2c = fb_klt_track(pyr_p, pyr_c, pts_t[idx], pts_t[idx], sel_valid,
                           levels=s2_levels, **klt_args)
        s2_xy = pts_t.clone()                 # in-place scatter on a copy
        s2_xy[idx] = s2c.xy
        s2_status = torch.zeros(K, dtype=torch.bool, device=pts_t.device)
        s2_status[idx] = s2c.status & sel_valid
    else:
        s2 = fb_klt_track(pyr_p, pyr_c, pts_t, pts_t, stage2_mask,
                          levels=s2_levels, **klt_args)
        s2_xy, s2_status = s2.xy, s2.status

    return _merge_tracks(state, cam, sc, prior_ok, s1.xy, s1.status, stage2_mask,
                         s2_xy, s2_status)


def _klt_args(cfg: SlamConfig) -> dict:
    return dict(win=cfg.klt_window, iters=cfg.klt_iters, eps=cfg.klt_eps,
                err_max=cfg.klt_err_max, fb_dist=cfg.klt_fb_dist)


def _motion_priors(state: MapState, pose_prior: SE3, cam: Camera, cfg: SlamConfig):
    """Motion-prior projections (distorted pixels) of the keypoints' 3D
    landmarks and which of them stage 1 tracks.  Returns (proj, prior_ok)."""
    is3d = (state.kp_valid & state.lm_valid[state.kp_lm]
            & state.lm_is3d[state.kp_lm])
    proj = cam.project_dist(pose_prior.apply(state.lm_pos[state.kp_lm]))
    return proj, is3d & cam.in_roi(proj, cfg.width, cfg.height, border=1)


def _merge_tracks(state: MapState, cam: Camera, sc: float, prior_ok, s1_xy, s1_status,
                  stage2_mask, s2_xy, s2_status) -> MapState:
    """The keypoints after both stages (stage 1 first), and the P3P request
    when stage 1 tracked under a third of its priors.  Elementwise over
    [..., K]: one stream or a stack of streams."""
    ok1 = prior_ok & s1_status
    ok2 = stage2_mask & s2_status
    kp_px = torch.where(ok1[..., None], s1_xy * sc,
                        torch.where(ok2[..., None], s2_xy * sc, state.kp_px))
    n_priors = torch.sum(prior_ok, dim=-1)
    p3p_req = (n_priors > 0) & (torch.sum(ok1, dim=-1).to(torch.float32)
                                < 0.33 * n_priors.to(torch.float32))
    return state.replace(kp_px=kp_px, kp_und=cam.undistort(kp_px),
                         kp_valid=ok1 | ok2, p3p_req=state.p3p_req | p3p_req)


# ---------------------------------------------------------------------------
# Pose estimation
# ---------------------------------------------------------------------------

def _compute_pose(state: MapState, cam: Camera, cfg: SlamConfig, p3p=None, samples=None):
    """P3P-LMedS recovery when requested, then motion-only PnP.
    ``p3p``: None runs P3P when the state requests it (a branch on a device
    scalar), False never (the deferred, batched track phase), True always
    (the recovery phase).  ``samples`` replaces P3P's draw.
    Returns (state, success, P3P requested)."""
    is3d = (state.kp_valid & state.lm_valid[state.kp_lm]
            & state.lm_is3d[state.kp_lm])
    n3d = torch.sum(is3d)
    pts_w = state.lm_pos[state.kp_lm]
    do_p3p = state.p3p_req | (state.pose_failures > 0) if cfg.use_p3p else state.p3p_req

    pose_init, pnp_mask = state.pose, is3d
    p3p_ok = torch.ones((), dtype=torch.bool, device=is3d.device)
    if p3p or (p3p is None and host_bool(do_p3p)):
        r = p3p_lmeds(state.rng, cam.bearing(state.kp_und), pts_w, is3d,
                      focal=cam.focal, iters=cfg.ransac_iters,
                      err_px=cfg.ransac_err_px, min_inliers=cfg.p3p_min_inliers,
                      samples=samples)
        pose_init = SE3.where(r.success, r.pose, state.pose)
        pnp_mask = torch.where(r.success, r.inliers, is3d)
        p3p_ok = r.success

    res = pnp_refine(pose_init, cam, pts_w, state.kp_und, pnp_mask,
                     iters=cfg.pnp_iters, huber_delta=cfg.huber_thresh)
    n_in = res.num_inliers
    success = ((n3d >= 4) & p3p_ok & (n_in >= 5)
               & (n_in.to(torch.float32) >= 0.5 * torch.sum(pnp_mask).to(torch.float32))
               & torch.all(torch.isfinite(res.pose.t)))
    failures = torch.where(success, 0, state.pose_failures + 1)
    return state.replace(
        pose=SE3.where(success, res.pose, state.pose),
        kp_valid=torch.where(success, state.kp_valid & (res.inliers | ~is3d),
                             state.kp_valid),
        p3p_req=~success, pose_failures=failures,
        reset_requested=state.reset_requested | (failures > cfg.max_pose_failures),
    ), success, do_p3p


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _parallax_vs_kf(state: MapState, cam: Camera, rotation_compensated: bool,
                    median: bool):
    """Parallax of the current keypoints vs the latest keyframe's
    observations (by the stable-slot invariant).  Returns (value, count)."""
    slot = state.cur_kf_slot
    K = state.kp_lm.shape[0]
    same = (state.kf_obs_lm[slot] == state.kp_lm) & state.kf_obs_valid[slot] & state.kp_valid
    kf_px = state.kf_obs_px[slot]
    cur_px = state.kp_und
    if rotation_compensated:
        T_kf = state.kf_pose[slot]
        zero = torch.zeros_like(T_kf.t)
        R_rel = SE3(T_kf.q, zero).compose(SE3(state.pose.q, zero).inverse())
        cur_px = cam.project(R_rel.rotate(cam.bearing(cur_px)))
    d = torch.linalg.norm(cur_px - kf_px, dim=-1)
    n = torch.sum(same)
    if median:
        srt = torch.sort(torch.where(same, d, torch.inf)).values
        val = srt[torch.clamp(n // 2, 0, K - 1)]
        return torch.where(n > 0, val, 0.0), n
    avg = torch.sum(torch.where(same, d, 0.0)) / torch.clamp_min(n, 1)
    return torch.where(n > 0, avg, 0.0), n


def _init_gate(state: MapState, cam: Camera, cfg: SlamConfig):
    """Bootstrap readiness: enough rotation-compensated parallax."""
    par, n_common = _parallax_vs_kf(state, cam, rotation_compensated=True,
                                    median=False)
    return (par >= cfg.init_parallax_px) & (n_common >= 8)


def _bootstrap(state: MapState, cam: Camera, cfg: SlamConfig, samples=None):
    """Bootstrap against the latest keyframe: the 5-point (or 8-point)
    essential RANSAC, then with ``use_homography_init`` the homography
    RANSAC, keeping the homography where it succeeds with more inliers.
    Both draw from ``state.rng``; ``samples`` = (essential draw,
    homography draw) replaces them.  Returns (state, became_ready, the
    choice: a device bool, True where the homography was kept, or None
    without ``use_homography_init``)."""
    slot = state.cur_kf_slot
    same = (state.kf_obs_lm[slot] == state.kp_lm) & state.kf_obs_valid[slot] & state.kp_valid
    f_kf, f_cur = cam.bearing(state.kf_obs_px[slot]), cam.bearing(state.kp_und)
    s_e, s_h = samples if samples is not None else (None, None)
    solver = essential_ransac_5pt if cfg.use_five_point else essential_ransac
    args = dict(focal=cam.focal, iters=cfg.ransac_iters, err_px=cfg.ransac_err_px,
                min_inliers=cfg.init_min_inliers)
    r = solver(state.rng, f_kf, f_cur, same, samples=s_e, **args)
    use_h = None
    if cfg.use_homography_init:
        rh, _ = homography_ransac(state.rng, f_kf, f_cur, same, samples=s_h, **args)
        use_h = rh.success & (rh.num_inliers > r.num_inliers)
        r = RelativePoseResult.where(use_h, rh, r)
    # r.pose is T_kf_cur = T_wc of the current frame (kf0 at identity)
    return state.replace(
        pose=SE3.where(r.success, r.pose.inverse(), state.pose),
        kp_valid=torch.where(r.success, state.kp_valid & (r.inliers | ~same),
                             state.kp_valid),
        ready_for_init=state.ready_for_init | r.success), r.success, use_h


def _try_essential(state: MapState, cam: Camera, cfg: SlamConfig, samples=None):
    """``_bootstrap`` on one stream.  Returns (state, became_ready);
    ``_try_essential.last_use_h`` holds the latest choice of model for
    diagnostics."""
    state, ok, _try_essential.last_use_h = _bootstrap(state, cam, cfg, samples)
    return state, ok


_try_essential.last_use_h = None


def _attempt_init(state: MapState, cam: Camera, cfg: SlamConfig):
    """Gate, then the essential bootstrap when it passes."""
    if host_bool(_init_gate(state, cam, cfg)):
        return _try_essential(state, cam, cfg)
    return state, torch.zeros((), dtype=torch.bool, device=state.kp_px.device)


# ---------------------------------------------------------------------------
# Keyframe policy
# ---------------------------------------------------------------------------

def _keyframe_required(state: MapState, cam: Camera, cfg: SlamConfig):
    slot = state.cur_kf_slot
    med_rot_par, _ = _parallax_vs_kf(state, cam, rotation_compensated=True,
                                     median=True)
    id_diff = state.frame_id - state.last_kf_frame_id
    n_occupied = torch.sum(state.kp_valid)
    n3d = torch.sum(state.kp_valid & state.lm_is3d[state.kp_lm]
                    & state.lm_valid[state.kp_lm])
    kf_lm = state.kf_obs_lm[slot]
    kf_n3d = torch.sum(state.kf_obs_valid[slot] & state.lm_is3d[kf_lm]
                       & state.lm_valid[kf_lm])
    max_kps = cfg.max_keypoints
    c_occ = (id_diff >= 5) & (n_occupied < 0.33 * max_kps)
    c_low3d = (id_diff >= 2) & (n3d < 20)
    c_fresh = (id_diff < 2) & (n3d > 0.5 * max_kps)
    kf_par = cfg.kf_parallax_px if cfg.kf_parallax_px is not None else cfg.init_parallax_px
    cx = med_rot_par >= kf_par / 2.0
    c0 = med_rot_par >= kf_par
    c1 = n3d < 0.75 * kf_n3d
    c2 = (n_occupied < 0.5 * max_kps) & (n3d < 0.85 * kf_n3d)
    return c_occ | c_low3d | (~c_fresh & ((c0 | c1 | c2) & cx))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def track_phase(state: MapState, gray, cam: Camera, cfg: SlamConfig, dt=1.0, *,
                defer_heavy: bool = False):
    """Per-frame work without the keyframe pipeline.  Returns (state,
    TrackFlags).  The current pyramid is left in ``prev_pyr``.

    ``defer_heavy``: leave out the P3P recovery and the essential bootstrap
    and report them as ``p3p_need`` and ``init_gate`` instead: the batched
    phase (``track_phase_batched``) on a one-stream stack."""
    if defer_heavy:
        states, fl = track_phase_batched(stack_states([state]), gray[None], cam, cfg, [dt])
        return state_row(states, 0), TrackFlags(kf_req=fl.kf_req[0], p3p_need=fl.p3p_need[0],
                                                init_gate=fl.init_gate[0])
    pyr_cur = preprocess(gray, cfg)
    dt = max(float(dt), 1e-6)
    dev = state.kp_px.device

    is_first = host_bool(state.frame_id == 0)
    in_tracking = (not is_first) and host_bool(state.ready_for_init)
    prev_pose = state.pose
    if in_tracking:
        # constant-velocity prior: T_cw_prior = Exp(-vel·dt) ∘ T_cw
        pose_prior = SE3.exp(-state.vel * dt).compose(state.pose)
    else:
        pose_prior = state.pose
    # on the card stage 2 runs at full width: one kernel launch over all
    # keypoints costs about what 48 slots do, and saves the host sync, the
    # top_k and the scatters of the compaction
    state = _track_keypoints(state, pyr_cur, pose_prior, cam, cfg,
                             allow_cond=not pyr_cur[0].is_cuda)

    if is_first:
        state = state.replace(pose=SE3.identity(dtype=state.kp_px.dtype, device=dev))
        kf_required = torch.ones((), dtype=torch.bool, device=dev)
    elif not in_tracking:
        n2d = torch.sum(state.kp_valid)
        state = state.replace(reset_requested=state.reset_requested
                              | (n2d < cfg.min_init_keypoints))
        state, kf_required = _attempt_init(state, cam, cfg)
    else:
        state = state.replace(pose=pose_prior)
        state, success, _ = _compute_pose(state, cam, cfg)
        new_vel = prev_pose.compose(state.pose.inverse()).log() / dt
        state = state.replace(vel=torch.where(success, new_vel, state.vel))
        kf_required = _keyframe_required(state, cam, cfg) & success
    state = state.replace(prev_pyr=pyr_cur)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return state, TrackFlags(kf_req=kf_required & ~state.reset_requested, p3p_need=false,
                             init_gate=false)


def _branches(state: MapState, pose_prior_q, pose_prior_t, dt, cam: Camera,
              cfg: SlamConfig) -> dict:
    """One stream's three branches of the track phase after the KLT, all
    computed and selected by the stream's own phase (first frame,
    initializing, tracking), with the heavy solves deferred: the body of
    the JAX package's ``track_phase(defer_heavy=True)`` as its ``vmap``
    runs it.  Returns the fields it changes and the flags."""
    pose_prior = SE3(pose_prior_q, pose_prior_t)
    is_first = state.frame_id == 0
    tracking = ~is_first & state.ready_for_init
    initializing = ~is_first & ~state.ready_for_init

    # tracking: PnP from the motion prior, velocity, keyframe decision
    tr, success, do_p3p = _compute_pose(state.replace(pose=pose_prior), cam, cfg, p3p=False)
    new_vel = state.pose.compose(tr.pose.inverse()).log() / dt
    kf_tracking = _keyframe_required(tr, cam, cfg) & success
    # initializing: the reset on too few tracks, the bootstrap gate
    init_reset = state.reset_requested | (torch.sum(state.kp_valid) < cfg.min_init_keypoints)
    gate = _init_gate(state, cam, cfg)

    ident = SE3.identity(dtype=state.kp_px.dtype, device=state.kp_px.device)
    pose = SE3.where(is_first, ident, SE3.where(tracking, tr.pose, state.pose))
    reset = torch.where(tracking, tr.reset_requested,
                        torch.where(initializing, init_reset, state.reset_requested))
    ok = ~reset
    return {
        "pose.q": pose.q, "pose.t": pose.t,
        "kp_valid": torch.where(tracking, tr.kp_valid, state.kp_valid),
        "p3p_req": torch.where(tracking, tr.p3p_req, state.p3p_req),
        "pose_failures": torch.where(tracking, tr.pose_failures, state.pose_failures),
        "vel": torch.where(tracking & success, new_vel, state.vel),
        "reset_requested": reset,
        "kf_req": (is_first | (tracking & kf_tracking)) & ok,
        "p3p_need": tracking & do_p3p & ~success & ok,
        "init_gate": initializing & gate & ok,
    }


def _stream_tensors(states: MapState) -> dict:
    """The per-stream tensors of a stacked state that the batched track
    phase reads, by name (the pyramid is left out)."""
    return {k: v for k, v in states.tensors() if not k.startswith("prev_pyr.")}


def track_phase_batched(states: MapState, grays, cam: Camera, cfg: SlamConfig, dts):
    """``track_phase(defer_heavy=True)`` for a stacked state of B streams:
    grays [B, H, W], dts [B].  Returns (states, TrackFlags of [B] bools).

    Preprocess and the two KLT stages run on the stack (each stage one
    ``fb_klt_track`` call, so one kernel launch for all B streams on the
    card), stage 2 at full width; the per-stream logic between and after
    them is the single-stream code under ``torch.func.vmap``, every branch
    computed and selected per stream.  No host sync."""
    B, K = states.kp_px.shape[:2]
    dev = states.kp_px.device
    pyr_cur = preprocess(grays.contiguous(), cfg)     # the kernel reads levels densely
    dts = torch.as_tensor(dts, dtype=torch.float32, device=dev).clamp_min(1e-6)

    def priors(d, dt):
        st = from_tensors(d)
        in_tracking = st.ready_for_init & (st.frame_id != 0)
        prior = SE3.where(in_tracking, SE3.exp(-st.vel * dt).compose(st.pose), st.pose)
        proj, prior_ok = _motion_priors(st, prior, cam, cfg)
        return prior.q, prior.t, proj, prior_ok

    prior_q, prior_t, proj, prior_ok = vmap(priors)(_stream_tensors(states), dts)

    L = cfg.track_base_level
    sc = float(2 ** L)
    pyr_p, pyr_c = states.prev_pyr[L:], pyr_cur[L:]
    pts_t = (states.kp_px / sc).reshape(B * K, 2)
    s1 = fb_klt_track(pyr_p, pyr_c, pts_t, (proj / sc).reshape(B * K, 2),
                      prior_ok.reshape(B * K), levels=cfg.klt_prior_levels, search_r=4,
                      **_klt_args(cfg))
    s1_status = s1.status.reshape(B, K)
    stage2_mask = states.kp_valid & (~prior_ok | (prior_ok & ~s1_status))
    s2 = fb_klt_track(pyr_p, pyr_c, pts_t, pts_t, stage2_mask.reshape(B * K),
                      levels=max(1, cfg.pyramid_levels - L), **_klt_args(cfg))
    states = _merge_tracks(states, cam, sc, prior_ok, s1.xy.reshape(B, K, 2), s1_status,
                           stage2_mask, s2.xy.reshape(B, K, 2), s2.status.reshape(B, K))

    out = vmap(lambda d, q, t, dt: _branches(from_tensors(d), q, t, dt, cam, cfg))(
        _stream_tensors(states), prior_q, prior_t, dts)
    states = states.replace(
        pose=SE3(out["pose.q"], out["pose.t"]), kp_valid=out["kp_valid"],
        p3p_req=out["p3p_req"], pose_failures=out["pose_failures"], vel=out["vel"],
        reset_requested=out["reset_requested"], prev_pyr=pyr_cur)
    return states, TrackFlags(kf_req=out["kf_req"], p3p_need=out["p3p_need"],
                              init_gate=out["init_gate"])


def recovery_phase(state: MapState, cam: Camera, cfg: SlamConfig, samples=None) -> MapState:
    """The deferred P3P + PnP redo on the current frame, from the frame's
    KLT results in the state, drawing from the stream's generator
    (``samples`` replaces the draw).  The track phase already counted this
    frame's failure, so a failure here leaves ``pose_failures`` as it was."""
    pre_fail, pre_reset = state.pose_failures, state.reset_requested
    st, success, _ = _compute_pose(state.replace(p3p_req=torch.ones_like(state.p3p_req)),
                                   cam, cfg, p3p=True, samples=samples)
    return st.replace(pose_failures=torch.where(success, 0, pre_fail),
                      reset_requested=torch.where(success, pre_reset, st.reset_requested))


def init_essential_phase(state: MapState, cam: Camera, cfg: SlamConfig,
                         samples=None) -> MapState:
    """The deferred essential bootstrap (``_bootstrap``), drawing from the
    stream's generator; ``samples`` = (essential draw, homography draw)
    replaces the draws."""
    return _bootstrap(state, cam, cfg, samples=samples)[0]


def keyframe_phase(state: MapState, cam: Camera, cfg: SlamConfig,
                   select: bool = False) -> MapState:
    """The keyframe pipeline on the frame held in ``state.prev_pyr``;
    ``select`` as in ``create_keyframe``."""
    return create_keyframe(state, state.prev_pyr, cam, cfg, select=select)


# ---------------------------------------------------------------------------
# The gated phases on a stack of elected streams
# ---------------------------------------------------------------------------

def _row_draws(states: MapState, cfg: SlamConfig, n: int):
    """``n`` uniform RANSAC draws [S, n, ransac_iters, K] for each row of a
    stacked sub-state, each row's from its own generator and in the order
    the single-stream phase takes them: a stream's generator advances as it
    does there, whichever other streams share the stack."""
    K, dev = states.kp_px.shape[1], states.kp_px.device
    return torch.stack([torch.stack([uniform_draw(g, cfg.ransac_iters, K, dev)
                                     for _ in range(n)]) for g in states.rng])


def recovery_phase_batched(states: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """``recovery_phase`` on every row of a stacked sub-state in one pass
    (``map_rows``): each row's P3P draw first, then the phase under
    ``vmap``."""
    return map_rows(lambda s, u: recovery_phase(s, cam, cfg, samples=u[0]), states,
                    _row_draws(states, cfg, 1))


def init_essential_phase_batched(states: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """``init_essential_phase`` on every row of a stacked sub-state in one
    pass: each row's essential draw, then (with ``use_homography_init``)
    its homography draw, then the phase under ``vmap``."""
    n = 2 if cfg.use_homography_init else 1
    return map_rows(lambda s, u: init_essential_phase(s, cam, cfg, samples=(u[0], u[n - 1])),
                    states, _row_draws(states, cfg, n))


def keyframe_phase_batched(states: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """``keyframe_phase`` on every row of a stacked sub-state in one pass,
    under ``vmap`` with both sides of each branch selected per row: no
    host sync, whatever the number of rows."""
    return map_rows(lambda s: keyframe_phase(s, cam, cfg, select=True), states)


def finalize_phase(state: MapState, kf_created, cfg: SlamConfig, defer_reset: bool = False):
    """Status, output marshalling and the reset, for one stream or (with
    ``defer_reset``) a stacked state of B streams.  ``defer_reset`` leaves
    the reset to the caller (``reset_requested`` stays set) and needs no
    host sync."""
    status = torch.where(state.reset_requested, 2,
                         torch.where(state.ready_for_init, 1, 3))
    at_kp = lambda field: torch.gather(field, -1, state.kp_lm)
    n3d = torch.sum(state.kp_valid & at_kp(state.lm_is3d) & at_kp(state.lm_valid), dim=-1)
    out = StepOutput(status=status, pose_wc=state.pose.inverse().matrix(),
                     points=state.kp_und, points_valid=state.kp_valid,
                     num_tracked=torch.sum(state.kp_valid, dim=-1), num_3d=n3d,
                     is_keyframe=kf_created & ~state.reset_requested)
    if defer_reset:
        return state.replace(frame_id=torch.where(status == 2, 0, state.frame_id + 1)), out
    reset = host_bool(state.reset_requested)
    if reset:
        state = reset_map_state(state, cfg)
    return state.replace(frame_id=torch.zeros_like(state.frame_id) if reset
                         else state.frame_id + 1), out


def slam_step(state: MapState, gray, cam: Camera, cfg: SlamConfig,
              dt=1.0) -> tuple[MapState, StepOutput]:
    """Process one grayscale frame; returns the new state and outputs.
    ``dt`` is the time since the previous frame (1.0 per frame when the
    caller has no timestamps)."""
    state, flags = track_phase(state, gray, cam, cfg, dt)
    if host_bool(flags.kf_req):
        state = keyframe_phase(state, cam, cfg)
    return finalize_phase(state, flags.kf_req, cfg)
