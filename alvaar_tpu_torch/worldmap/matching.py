"""Local-map projection matching + landmark merging.

Port of alvaar_tpu/worldmap/matching.py: established 3D landmarks that
the new keyframe does not observe are projected in; a young keypoint
within 2 px of a projection, with a close descriptor bag (NNDR 0.9,
absolute gate 0.2·256 bits), never co-observed with the candidate, and
consistent in its own observers, is merged into the established landmark.
Three dense [L, K] passes (projection distance, Hamming, incidence
overlap), then masked selection and vectorized merge scatters.  On CUDA
tensors the Hamming pass is one launch of K4 (``ops/hamming.py``), also
under ``torch.func.vmap``; ``match_to_local_map.calls`` counts the calls
(once per batched call), against which a run holds K4's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.geom.camera import Camera
from alvaar_tpu_torch.ops.hamming import hamming_min_crossbag
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.ops.index import take_col
from alvaar_tpu_torch.utils.stats import count
from alvaar_tpu_torch.worldmap.state import MapState, masked_scatter_set

MAX_PROJ_PX = 2.0


def match_to_local_map(state: MapState, cam: Camera, cfg: SlamConfig) -> MapState:
    """Match unobserved 3D landmarks into the new keyframe and merge."""
    count(match_to_local_map, "calls")
    slot = state.cur_kf_slot
    K = state.kp_lm.shape[0]
    L = state.lm_valid.shape[0]
    W = state.kf_valid.shape[0]
    dev = state.kp_lm.device
    kp_lm = state.kp_lm
    kp_young = state.lm_valid[kp_lm] & state.kp_valid

    # ---- candidate old landmarks: valid, 3D, not observed by this kf ----
    cand = state.lm_valid & state.lm_is3d & ~take_col(state.lm_obs, slot)
    Xc = state.pose.apply(state.lm_pos)
    z = Xc[:, 2]
    view_cos = z / torch.linalg.norm(Xc, dim=-1).clamp_min(1e-9)
    # the half-FOV tangent in float32 on the host (IEEE division, as on the
    # device): a tensor built from host data would wait for the card
    fov = max(np.float32(0.5 * cfg.width) / np.float32(cam.fx),
              np.float32(0.5 * cfg.height) / np.float32(cam.fy))
    view_th = torch.cos(torch.atan(torch.full((), float(fov), dtype=Xc.dtype, device=dev)))
    proj = cam.project_dist(Xc)
    in_img = cam.in_roi(proj, cfg.width, cfg.height, border=1)
    cand = cand & (z > 0.1) & (torch.abs(view_cos) >= view_th) & in_img

    n3d_frame = torch.sum(state.kp_valid & state.lm_is3d[kp_lm] & state.lm_valid[kp_lm])
    max_px = torch.where(n3d_frame < 30, 2.0 * MAX_PROJ_PX, MAX_PROJ_PX)

    # ---- [L, K] gates ----
    px_dist = torch.linalg.norm(proj[:, None, :] - state.kp_px[None, :, :], dim=-1)
    inc = (state.lm_obs & state.kf_valid[None, :]).to(torch.float32)
    overlap = inc @ inc[kp_lm].T
    G = state.lm_desc_bag.shape[1]
    filled = (torch.arange(G, device=dev)[None, :]
              < torch.clamp_max(state.lm_desc_cnt, G)[:, None])
    desc_dist = hamming_min_crossbag(state.lm_desc_bag, filled,
                                     state.lm_desc_bag[kp_lm], filled[kp_lm])

    pair_ok = (cand[:, None] & kp_young[None, :] & (px_dist <= max_px)
               & (overlap < 0.5)
               & (kp_lm[None, :] != torch.arange(L, device=dev)[:, None]))
    BIG = 1e9
    d = torch.where(pair_ok, desc_dist, BIG)

    # ---- per-landmark best/second NNDR ----
    neg2, idx2 = top_k(-d, 2)
    best, sec = -neg2[:, 0], -neg2[:, 1]
    best_k = idx2[:, 0]
    lm_match_ok = (best <= float(cfg.match_max_hamming)) & ~(cfg.match_nndr * sec < best)

    # ---- per-keypoint: keep the lowest-distance landmark ----
    lm_best = torch.where(lm_match_ok, best, BIG)
    kp_best = torch.full((K,), BIG, dtype=torch.float32, device=dev).scatter_reduce(
        0, best_k, lm_best, reduce="amin")
    is_winner = lm_match_ok & (lm_best <= kp_best[best_k] + 1e-6)
    lm_ids = torch.arange(L, device=dev)
    winner_lm = torch.full((K,), L, dtype=torch.int64, device=dev).scatter_reduce(
        0, best_k, torch.where(is_winner, lm_ids, L), reduce="amin")
    merge = (winner_lm < L) & kp_young
    old_lm = winner_lm.clamp(0, L - 1)

    # ---- co-keyframe reprojection gate on the K selected pairs ----
    young = kp_lm
    obs_y = state.lm_obs[young] & state.kf_valid[None, :]            # [K, W]
    k_idx = torch.arange(K, device=dev)
    same = (state.kf_obs_lm[:, k_idx] == young[None, :]) & state.kf_obs_valid[:, k_idx]
    obs_y = obs_y & same.T
    pos_old = state.lm_pos[old_lm]                                    # [K, 3]
    proj_kw = cam.project(state.kf_pose.unsqueeze(1).apply(pos_old[None]))  # [W, K, 2]
    co_d = torch.linalg.norm(proj_kw - state.kf_obs_px[:, k_idx], dim=-1)
    n_co = torch.sum(obs_y.T, dim=0)
    co_avg = (torch.sum(torch.where(obs_y.T, co_d, 0.0), dim=0)
              / torch.clamp_min(n_co, 1).to(torch.float32))
    merge = merge & ((n_co == 0) | (co_avg <= max_px))

    # ---- vectorized merge ----
    # 1. transfer young observations to old (OR into the old rows)
    young_rows = (state.lm_obs[young] & merge[:, None]).to(torch.int64)
    dst = torch.where(merge, old_lm, L - 1)[:, None].expand(K, W)
    lm_obs = state.lm_obs.to(torch.int64).scatter_reduce(
        0, dst, young_rows, reduce="amax").to(torch.bool)
    # 2. rewrite keyframe observation tables for merged slots
    rewrite = same & merge[None, :] & state.kf_obs_valid[:, k_idx]
    kf_obs_lm = torch.where(rewrite, old_lm[None, :], state.kf_obs_lm)
    # 3. kill young landmarks
    lm_valid = masked_scatter_set(state.lm_valid, young,
                                  torch.zeros(K, dtype=torch.bool, device=dev), merge)
    lm_obs = masked_scatter_set(lm_obs, young,
                                torch.zeros((K, W), dtype=torch.bool, device=dev), merge)
    # 4. rebind current-frame keypoints
    return state.replace(kp_lm=torch.where(merge, old_lm, kp_lm), kf_obs_lm=kf_obs_lm,
                         lm_obs=lm_obs, lm_valid=lm_valid)


match_to_local_map.calls = 0
