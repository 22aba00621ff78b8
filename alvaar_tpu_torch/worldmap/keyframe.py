"""Keyframe pipeline: creation, eviction, triangulation, BA, culling.

Port of alvaar_tpu/worldmap/keyframe.py.  Every step is a masked tensor
transformation of the fixed-shape MapState.  The stable-slot invariant
carries over: a landmark keeps its keypoint slot k from detection until
track loss, so its pixel in keyframe w is ``kf_obs_px[w, k]``.  Where the
JAX package branches with ``lax.cond``, the single-stream port branches in
Python on a device scalar, which costs one host sync (``host_bool``);
``create_keyframe(select=True)`` computes both sides and selects, as
``lax.cond`` does under ``jax.vmap``, so the batched keyframe phase runs
the pipeline under ``torch.func.vmap`` with no host sync.
"""

from __future__ import annotations

import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.geom.triangulation import triangulate_midpoint
from alvaar_tpu_torch.ops.detect import detect_grid
from alvaar_tpu_torch.ops.hamming import popcount_words
from alvaar_tpu_torch.ops.orb import describe
from alvaar_tpu_torch.solvers.ba import BAProblem, local_ba
from alvaar_tpu_torch.utils.stats import count
from alvaar_tpu_torch.worldmap.matching import match_to_local_map
from alvaar_tpu_torch.worldmap.state import (
    MapState,
    allocate_slots,
    covisibility,
    landmark_world_positions,
    map_tensors,
    masked_scatter_set,
)

_INT_MAX = torch.iinfo(torch.int64).max


def host_bool(x) -> bool:
    """Read a 0-d device bool on the host (one sync per call on CUDA);
    every data-dependent branch of the port goes through here so a run can
    count them."""
    count(host_bool, "syncs")
    return bool(x)


host_bool.syncs = 0


def _oldest_observer(state: MapState, exclude_slot=None):
    """Per landmark: (ring slot of the oldest live observer, has one)."""
    obs = state.lm_obs & state.kf_valid[None, :]
    if exclude_slot is not None:
        W = state.kf_valid.shape[0]
        obs = obs & (torch.arange(W, device=obs.device) != exclude_slot)[None, :]
    ids = torch.where(obs, state.kf_id[None, :], _INT_MAX)
    return torch.argmin(ids, dim=1), torch.any(obs, dim=1)


def _lm_bound_in_frame(state: MapState):
    """[L] bool — landmark bound to a live keypoint slot."""
    L = state.lm_valid.shape[0]
    bound = torch.zeros(L, dtype=torch.int64, device=state.kp_lm.device)
    return bound.scatter_reduce(0, state.kp_lm, state.kp_valid.to(torch.int64),
                                reduce="amax").to(torch.bool)


def evict_and_write_keyframe(state: MapState, cfg: SlamConfig) -> MapState:
    """Overwrite the ring slot of the new keyframe and bind the current
    keypoints as its observations."""
    W = cfg.window_size
    slot = state.next_kf_id % W
    lm_obs = state.lm_obs.clone()     # in-place column updates on a copy
    lm_obs[:, slot] = False
    bound = _lm_bound_in_frame(state)
    n_obs = torch.sum(lm_obs & state.kf_valid[None, :], dim=1)
    lm_valid = state.lm_valid & ((n_obs > 0) | bound)

    kf_pose = state.kf_pose.clone()
    kf_pose.q[slot] = state.pose.q
    kf_pose.t[slot] = state.pose.t
    kf_valid = state.kf_valid.clone()
    kf_valid[slot] = True
    kf_id = state.kf_id.clone()
    kf_id[slot] = state.next_kf_id

    obs_ok = state.kp_valid & lm_valid[state.kp_lm]
    kf_obs_lm = state.kf_obs_lm.clone()
    kf_obs_lm[slot] = state.kp_lm
    kf_obs_px = state.kf_obs_px.clone()
    kf_obs_px[slot] = state.kp_und
    kf_obs_valid = state.kf_obs_valid.clone()
    kf_obs_valid[slot] = obs_ok
    # lm_obs[kp_lm, slot] |= obs_ok (OR-scatter into the slot's column)
    col = lm_obs[:, slot].to(torch.int64).scatter_reduce(
        0, state.kp_lm, obs_ok.to(torch.int64), reduce="amax")
    lm_obs[:, slot] = col.to(torch.bool)

    return state.replace(
        lm_obs=lm_obs, lm_valid=lm_valid, kf_pose=kf_pose, kf_valid=kf_valid,
        kf_id=kf_id, kf_obs_lm=kf_obs_lm, kf_obs_px=kf_obs_px,
        kf_obs_valid=kf_obs_valid, cur_kf_slot=slot,
        last_kf_frame_id=state.frame_id, next_kf_id=state.next_kf_id + 1)


def reanchor_landmarks(state: MapState, cfg: SlamConfig) -> MapState:
    """Re-derive each 3D landmark's inverse-depth anchor as its oldest live
    observer, from the stored world position."""
    slot, has = _oldest_observer(state)
    X_a = state.kf_pose[slot].apply(state.lm_pos)
    z = X_a[:, 2]
    z_ok = z > 1e-3
    z_safe = torch.where(z_ok, z, 1.0)
    upd = state.lm_is3d & state.lm_valid & has & z_ok
    return state.replace(
        lm_anchor=torch.where(upd, slot, state.lm_anchor),
        lm_mxy=torch.where(upd[:, None], X_a[:, :2] / z_safe[:, None], state.lm_mxy),
        lm_invd=torch.where(upd, 1.0 / z_safe, state.lm_invd))


def _push_descriptor_bags(state: MapState, desc, ok_tracked):
    """Append each tracked keypoint's descriptor to its landmark's ring
    bag and re-elect the bag medoid as the representative.
    Returns (lm_desc, lm_desc_bag, lm_desc_cnt)."""
    L, G, _ = state.lm_desc_bag.shape
    lm = state.kp_lm
    cnt = state.lm_desc_cnt[lm]
    bag = masked_scatter_set(state.lm_desc_bag.reshape(L * G, 8),
                             lm * G + cnt % G, desc, ok_tracked).reshape(L, G, 8)
    cnt_new = masked_scatter_set(state.lm_desc_cnt, lm, cnt + 1, ok_tracked)

    bags_k = bag[lm]                                        # [K, G, 8]
    n_k = torch.clamp_max(cnt + 1, G)
    d = popcount_words(bags_k[:, :, None, :] ^ bags_k[:, None, :, :])   # [K, G, G]
    filled = torch.arange(G, device=lm.device)[None, :] < n_k[:, None]
    sums = torch.sum(torch.where(filled[:, :, None] & filled[:, None, :], d, 0), dim=-1)
    sums = torch.where(filled, sums, torch.iinfo(torch.int32).max)
    med = torch.argmin(sums, dim=-1)
    rep = bags_k[torch.arange(lm.shape[0], device=lm.device), med]
    return masked_scatter_set(state.lm_desc, lm, rep, ok_tracked), bag, cnt_new


def describe_and_detect(state: MapState, pyr, cam: Camera,
                        cfg: SlamConfig) -> MapState:
    """Describe the tracked keypoints, then fill empty grid cells with new
    detections as new 2D landmarks."""
    slot = state.cur_kf_slot
    gray = pyr[0]
    dimg = pyr[cfg.track_base_level]
    dsc = float(2 ** cfg.track_base_level)

    desc, _ = describe(dimg, state.kp_px / dsc, state.kp_valid)
    ok_tracked = state.kp_valid & state.lm_valid[state.kp_lm]
    lm_desc_all, lm_bag, lm_cnt = _push_descriptor_bags(state, desc, ok_tracked)
    state = state.replace(lm_desc_bag=lm_bag, lm_desc_cnt=lm_cnt)

    det = detect_grid(gray, state.kp_px, state.kp_valid, cell=cfg.cell_size,
                      border=cfg.image_border, quality=state.detect_quality)
    state = state.replace(detect_quality=det.new_quality)
    new_desc, _ = describe(dimg, det.xy / dsc, det.valid)

    kp_slot, kp_ok = allocate_slots(state.kp_valid, det.valid)
    lm_slot, lm_ok = allocate_slots(state.lm_valid, det.valid & kp_ok)
    ok = det.valid & kp_ok & lm_ok
    und = cam.undistort(det.xy)
    ones = torch.ones_like(ok)

    L, G, _ = state.lm_desc_bag.shape
    h, w = gray.shape
    yi = torch.round(det.xy[:, 1]).to(torch.int64).clamp(0, h - 1)
    xi = torch.round(det.xy[:, 0]).to(torch.int64).clamp(0, w - 1)
    W = state.lm_obs.shape[1]
    fresh_rows = (torch.arange(W, device=ok.device) == slot)[None, :].expand(ok.shape[0], W)

    kf_obs_lm = state.kf_obs_lm.clone()
    kf_obs_lm[slot] = masked_scatter_set(state.kf_obs_lm[slot], kp_slot, lm_slot, ok)
    kf_obs_px = state.kf_obs_px.clone()
    kf_obs_px[slot] = masked_scatter_set(state.kf_obs_px[slot], kp_slot, und, ok)
    kf_obs_valid = state.kf_obs_valid.clone()
    kf_obs_valid[slot] = masked_scatter_set(state.kf_obs_valid[slot], kp_slot, ones, ok)

    return state.replace(
        kp_px=masked_scatter_set(state.kp_px, kp_slot, det.xy, ok),
        kp_und=masked_scatter_set(state.kp_und, kp_slot, und, ok),
        kp_lm=masked_scatter_set(state.kp_lm, kp_slot, lm_slot, ok),
        kp_valid=masked_scatter_set(state.kp_valid, kp_slot, ones, ok),
        lm_valid=masked_scatter_set(state.lm_valid, lm_slot, ones, ok),
        lm_is3d=masked_scatter_set(state.lm_is3d, lm_slot, ~ones, ok),
        lm_desc=masked_scatter_set(lm_desc_all, lm_slot, new_desc, ok),
        lm_desc_bag=masked_scatter_set(state.lm_desc_bag.reshape(L * G, 8),
                                       lm_slot * G, new_desc, ok).reshape(L, G, 8),
        lm_desc_cnt=masked_scatter_set(state.lm_desc_cnt, lm_slot,
                                       torch.ones_like(lm_slot), ok),
        lm_color=masked_scatter_set(state.lm_color, lm_slot, gray[yi, xi], ok),
        lm_obs=masked_scatter_set(state.lm_obs, lm_slot, fresh_rows, ok),
        kf_obs_lm=kf_obs_lm, kf_obs_px=kf_obs_px, kf_obs_valid=kf_obs_valid)


def triangulate_temporal(state: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """Triangulate the new keyframe's 2D landmarks against their oldest
    observing keyframe (midpoint, z > 0.1 in both views, reprojection
    gate); failures with > 20 px parallax lose the new observation."""
    slot = state.cur_kf_slot
    K = state.kp_lm.shape[0]
    kr = torch.arange(K, device=state.kp_lm.device)
    lm = state.kf_obs_lm[slot]
    obs_ok = state.kf_obs_valid[slot]

    first_w, has_other = _oldest_observer(state, exclude_slot=slot)
    w_i = first_w[lm]
    same = (state.kf_obs_lm[w_i, kr] == lm) & state.kf_obs_valid[w_i, kr]
    cand = (obs_ok & ~state.lm_is3d[lm] & state.lm_valid[lm]
            & has_other[lm] & same & (w_i != slot))

    T_i = state.kf_pose[w_i]
    T_ij = T_i.compose(state.pose.inverse())
    px_i = state.kf_obs_px[w_i, kr]
    px_j = state.kf_obs_px[slot]
    f_i = cam.bearing(px_i)
    f_j = cam.bearing(px_j)
    X_i = triangulate_midpoint(T_ij, f_i, f_j)
    X_j = T_ij.inverse().apply(X_i)
    z_i, z_j = X_i[..., 2], X_j[..., 2]
    e_i = torch.linalg.norm(cam.project(X_i) - px_i, dim=-1)
    e_j = torch.linalg.norm(cam.project(X_j) - px_j, dim=-1)
    good = (cand & (z_i > 0.1) & (z_j > 0.1)
            & (e_i <= cfg.triang_max_reproj_px) & (e_j <= cfg.triang_max_reproj_px))

    parallax = torch.linalg.norm(cam.project(T_ij.rotate(f_j)) - px_i, dim=-1)
    drop = cand & ~good & (parallax > 20.0)

    X_w = T_i.inverse().apply(X_i)
    z_safe = torch.where(z_i > 1e-3, z_i, 1.0)
    lm_is3d = state.lm_is3d.to(torch.int64).scatter_reduce(
        0, lm, good.to(torch.int64), reduce="amax").to(torch.bool)
    kf_obs_valid = state.kf_obs_valid.clone()
    kf_obs_valid[slot] = state.kf_obs_valid[slot] & ~drop
    lm_obs = state.lm_obs.clone()
    col = lm_obs[:, slot].to(torch.int64).scatter_reduce(
        0, lm, (~drop).to(torch.int64), reduce="amin")
    lm_obs[:, slot] = col.to(torch.bool)
    return state.replace(
        lm_pos=masked_scatter_set(state.lm_pos, lm, X_w, good),
        lm_is3d=lm_is3d,
        lm_anchor=masked_scatter_set(state.lm_anchor, lm, w_i, good),
        lm_mxy=masked_scatter_set(state.lm_mxy, lm, X_i[..., :2] / z_safe[..., None], good),
        lm_invd=masked_scatter_set(state.lm_invd, lm, 1.0 / z_safe, good),
        kf_obs_valid=kf_obs_valid, lm_obs=lm_obs)


def refine_landmark_depths(state: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """Re-triangulate existing 3D landmarks between their anchor and the
    new keyframe, accepted only when it lowers the two-view reprojection
    error (and passes depth and ≥ 1° parallax gates)."""
    slot = state.cur_kf_slot
    K = state.kp_lm.shape[0]
    kr = torch.arange(K, device=state.kp_lm.device)
    lm = state.kf_obs_lm[slot]
    obs_ok = state.kf_obs_valid[slot] & state.lm_valid[lm] & state.lm_is3d[lm]
    a = state.lm_anchor[lm].clamp(0, state.kf_valid.shape[0] - 1)
    same = (state.kf_obs_lm[a, kr] == lm) & state.kf_obs_valid[a, kr]
    cand = obs_ok & same & (a != slot) & state.kf_valid[a]

    T_a = state.kf_pose[a]
    T_j = state.kf_pose[slot]
    T_aj = T_a.compose(T_j.inverse())
    px_a = state.kf_obs_px[a, kr]
    px_j = state.kf_obs_px[slot]
    f_a = cam.bearing(px_a)
    f_j = cam.bearing(px_j)
    X_a = triangulate_midpoint(T_aj, f_a, f_j)
    X_j = T_aj.inverse().apply(X_a)
    e_new = (torch.linalg.norm(cam.project(X_a) - px_a, dim=-1)
             + torch.linalg.norm(cam.project(X_j) - px_j, dim=-1))
    Xw = state.lm_pos[lm]
    e_cur = (torch.linalg.norm(cam.project(T_a.apply(Xw)) - px_a, dim=-1)
             + torch.linalg.norm(cam.project(T_j.apply(Xw)) - px_j, dim=-1))
    cosang = torch.sum(f_a * T_aj.rotate(f_j), dim=-1)
    cos1 = torch.cos(torch.deg2rad(torch.tensor(1.0, device=lm.device)))
    good = (cand & (X_a[..., 2] > 0.1) & (X_j[..., 2] > 0.1)
            & (cosang < cos1) & (e_new < e_cur))
    return state.replace(lm_pos=masked_scatter_set(
        state.lm_pos, lm, T_a.inverse().apply(X_a), good))


def build_ba_problem(state: MapState, cfg: SlamConfig) -> BAProblem:
    """The window's BA problem.  Low-covisibility keyframes are constant,
    the oldest live one always, the second-oldest once ≥ 3 are live."""
    slot = state.cur_kf_slot
    score = covisibility(state)[:, slot]
    constant = (score < cfg.ba_min_covisibility) & state.kf_valid
    ids = torch.where(state.kf_valid, state.kf_id, _INT_MAX)
    order = torch.argsort(ids, stable=True)
    n_live = torch.sum(state.kf_valid)
    constant = constant.clone()
    constant[order[0]] = True
    constant[order[1]] = torch.where(n_live >= 3, True, constant[order[1]])
    constant = constant | ~state.kf_valid

    obs_lm = state.kf_obs_lm
    ba_obs = state.kf_obs_valid & state.lm_valid[obs_lm] & state.lm_is3d[obs_lm]
    return BAProblem(
        poses=state.kf_pose, kf_valid=state.kf_valid, constant=constant,
        anchor_kf=state.lm_anchor, anchor_mxy=state.lm_mxy,
        invdepth=state.lm_invd, lm_valid=state.lm_valid & state.lm_is3d,
        obs_lm=obs_lm, obs_px=state.kf_obs_px, obs_valid=ba_obs)


def run_local_ba(state: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """Local BA over the window, write-back, outlier pruning and culling."""
    slot = state.cur_kf_slot
    prob = build_ba_problem(state, cfg)
    res = local_ba(prob, cam, iters=cfg.ba_iters, refine_iters=2,
                   huber_delta=cfg.huber_thresh)
    lm3d = state.lm_valid & state.lm_is3d
    lm_pos = landmark_world_positions(res.poses, state.lm_anchor, state.lm_mxy,
                                      res.invdepth)
    lm_pos = torch.where(lm3d[:, None], lm_pos, state.lm_pos)

    remove = prob.obs_valid & ~res.obs_inlier                     # [W, K]
    W, K = remove.shape
    w_idx = torch.arange(W, device=remove.device).repeat_interleave(K)
    flat = state.lm_obs.to(torch.int64).reshape(-1)
    lin = prob.obs_lm.reshape(-1) * W + w_idx
    lm_obs = flat.scatter_reduce(0, lin, (~remove).reshape(-1).to(torch.int64),
                                 reduce="amin").reshape(state.lm_obs.shape).to(torch.bool)

    bound = _lm_bound_in_frame(state)
    n_obs = torch.sum(lm_obs & state.kf_valid[None, :], dim=1)
    return state.replace(
        kf_pose=res.poses, lm_invd=res.invdepth, lm_pos=lm_pos,
        kf_obs_valid=state.kf_obs_valid & ~remove, lm_obs=lm_obs,
        lm_valid=state.lm_valid & ~(state.lm_is3d & (n_obs < 2) & ~bound),
        pose=res.poses[slot])


def filter_redundant_keyframes(state: MapState, cfg: SlamConfig) -> MapState:
    """Drop keyframes whose 3D observations are > kf_filtering_ratio seen
    by more than 4 keyframes, or that have too few 3D observations (the
    newest keyframe and keyframe 0 are exempt; only from 20 keyframes on)."""
    if cfg.kf_filtering_ratio >= 1.0:
        return state
    W = cfg.window_size
    slot = state.cur_kf_slot
    lm3d = state.lm_valid & state.lm_is3d
    n_obs_lm = torch.sum(state.lm_obs & state.kf_valid[None, :], dim=1)
    well_observed = lm3d & (n_obs_lm > 4)
    obs3d = state.kf_obs_valid & lm3d[state.kf_obs_lm]
    good = obs3d & well_observed[state.kf_obs_lm]
    n_total = torch.sum(obs3d, dim=1)
    ratio = (torch.sum(good, dim=1).to(torch.float32)
             / torch.clamp_min(n_total, 1).to(torch.float32))
    eligible = (state.kf_valid & (torch.arange(W, device=slot.device) != slot)
                & (state.kf_id > 0) & (state.next_kf_id - 1 >= 20))
    remove = eligible & ((ratio > cfg.kf_filtering_ratio)
                         | (n_total < cfg.ba_min_covisibility // 2))
    kf_valid = state.kf_valid & ~remove
    lm_obs = state.lm_obs & kf_valid[None, :]
    bound = _lm_bound_in_frame(state)
    n_obs = torch.sum(lm_obs & kf_valid[None, :], dim=1)
    return state.replace(
        kf_valid=kf_valid, kf_obs_valid=state.kf_obs_valid & ~remove[:, None],
        lm_obs=lm_obs,
        lm_valid=state.lm_valid & ~(state.lm_is3d & (n_obs < 2) & ~bound))


def _cond(pred, fn, state: MapState, select: bool) -> MapState:
    """``fn(state)`` where the 0-d ``pred`` holds, else ``state``: a branch
    on the host (one sync), or with ``select`` both computed and selected
    on the device, which is what ``lax.cond`` becomes under ``vmap``."""
    if not select:
        return fn(state) if host_bool(pred) else state
    return map_tensors(lambda a, b: a if a is b else torch.where(pred, a, b), fn(state), state)


def _later_keyframe(state: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    state = triangulate_temporal(state, cam, cfg)
    state = match_to_local_map(state, cam, cfg)
    return refine_landmark_depths(state, cam, cfg)


def create_keyframe(state: MapState, pyr, cam: Camera, cfg: SlamConfig,
                    select: bool = False) -> MapState:
    """The full keyframe pipeline on the pyramid ``pyr`` (level 0 first).
    ``select``: compute both sides of its two branches and select, with no
    host sync (the batched keyframe phase runs it so under ``vmap``)."""
    state = evict_and_write_keyframe(state, cfg)
    state = describe_and_detect(state, pyr, cam, cfg)
    # next_kf_id is already incremented
    state = _cond(state.next_kf_id > 1, lambda s: _later_keyframe(s, cam, cfg), state, select)
    state = reanchor_landmarks(state, cfg)

    n3d_now = torch.sum(state.kp_valid & state.lm_is3d[state.kp_lm]
                        & state.lm_valid[state.kp_lm])
    kf_idx = state.next_kf_id - 1
    bad_boot = state.ready_for_init & (
        ((kf_idx == 1) & (n3d_now < 30))
        | ((kf_idx < 10) & (kf_idx >= 2) & (n3d_now < 3)))
    state = _cond((kf_idx >= 1) & (n3d_now > 0) & ~bad_boot,
                  lambda s: run_local_ba(s, cam, cfg), state, select)
    state = filter_redundant_keyframes(state, cfg)
    return state.replace(reset_requested=state.reset_requested | bad_boot)
