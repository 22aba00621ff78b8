"""Trajectory parity metrics against the native reference engine.

Port of alvaar_tpu/utils/parity.py, in float64 numpy.  The accuracy
target is set against the reference engine: tools/ref_native builds the
same C++ engine (reference src/slam/src) for the host, and
tools/ref_native/record_golden.py records its trajectories into
tests/golden/.  This module loads those goldens and scores a run's
trajectory against them.

The reference is nondeterministic (RANSAC seeded from std::random_device,
reference system.cpp:210), so a golden file holds several reference runs;
parity is the ATE to the closest run, and the runs' own spread is the
noise floor.  Monocular scale is arbitrary (reference
visual_frontend.cpp:547), so every comparison is similarity (sim3)
aligned.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "golden")


def sim3_align_ate(est_t: np.ndarray, ref_t: np.ndarray) -> float:
    """RMSE between trajectories after similarity alignment (Umeyama)."""
    mu_e, mu_r = est_t.mean(0), ref_t.mean(0)
    e, r = est_t - mu_e, ref_t - mu_r
    cov = r.T @ e / len(e)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var_e = (e * e).sum() / len(e)
    s = np.trace(np.diag(S) @ D) / max(var_e, 1e-12)
    aligned = s * e @ R.T + mu_r
    return float(np.sqrt(((aligned - ref_t) ** 2).sum(axis=1).mean()))


def rpe_rmse(est_T: np.ndarray, ref_T: np.ndarray, delta: int = 1,
             scale: Optional[float] = None) -> dict:
    """Relative pose error over frame pairs (i, i+delta): local accuracy,
    separating drift from local jitter (ATE conflates them).

    est_T/ref_T: [N, 4, 4] T_wc at matched frames.  Monocular scale is
    arbitrary; ``scale`` (est→ref) defaults to matching the median
    relative-translation magnitudes.  Returns translation RMSE (in ref
    units) and rotation RMSE (degrees)."""
    n = len(est_T)
    if n <= delta:
        return {"trans_rmse": float("nan"), "rot_rmse_deg": float("nan")}
    rel = lambda T: np.matmul(np.linalg.inv(T[:-delta]), T[delta:])
    e, r = rel(np.asarray(est_T, np.float64)), rel(np.asarray(ref_T,
                                                             np.float64))
    if scale is None:
        en = np.linalg.norm(e[:, :3, 3], axis=1)
        rn = np.linalg.norm(r[:, :3, 3], axis=1)
        med = np.median(en)
        scale = float(np.median(rn) / med) if med > 1e-12 else 1.0
    dt = scale * e[:, :3, 3] - r[:, :3, 3]
    dR = np.matmul(e[:, :3, :3].transpose(0, 2, 1), r[:, :3, :3])
    cosang = np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return {
        "trans_rmse": float(np.sqrt((dt ** 2).sum(axis=1).mean())),
        "rot_rmse_deg": float(np.rad2deg(np.sqrt(
            (np.arccos(cosang) ** 2).mean()))),
        "scale": scale,
    }


def _traj(status: np.ndarray, poses: np.ndarray):
    """Tracked-frame indices + translations from one run's outputs."""
    idx = np.where(status == 1)[0]
    return idx, poses[idx][:, :3, 3]


def load_golden(name: str):
    path = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(path):
        return None
    return np.load(path)


def _window_pairs(trajs, w0: int, w1: int):
    """Pairwise sim3-ATE (%-of-span) between reference runs restricted to
    frames in [w0, w1)."""
    vals = []
    for a in range(len(trajs)):
        for b in range(a + 1, len(trajs)):
            ia, ta = trajs[a]
            ib, tb = trajs[b]
            common = np.intersect1d(ia, ib)
            common = common[(common >= w0) & (common < w1)]
            if len(common) < 10:
                continue
            pa = {int(v): k for k, v in enumerate(ia)}
            pb = {int(v): k for k, v in enumerate(ib)}
            ca = ta[[pa[int(c)] for c in common]]
            cb = tb[[pb[int(c)] for c in common]]
            span = float(np.linalg.norm(cb.max(0) - cb.min(0)))
            if span < 1e-9:
                continue
            vals.append(100.0 * sim3_align_ate(ca, cb) / span)
    return vals


def windowed_parity(our_status: np.ndarray, our_poses: np.ndarray,
                    golden_name: str, window: int = 50) -> Optional[dict]:
    """Per-segment parity vs the reference's own nondeterminism envelope.

    Where along the trajectory the ATE accumulates: for each
    ``window``-frame segment, measure (a) our best
    sim3-ATE to any reference run on that segment and (b) the reference
    runs' own pairwise spread there.  ``inside_envelope`` holds when our
    per-window score is ≤ the window's median pairwise reference spread
    in EVERY window — i.e. locally indistinguishable from one more
    reference run, with no segment where we quietly diverge.

    Two grades are reported: ``inside_envelope`` (strict — ≤ the MEDIAN
    pairwise spread in every window) and ``within_max`` (≤ the MAX
    observed pairwise spread in every window, i.e. never outside the
    spread reference runs actually exhibit among themselves).

    Returns {windows: [(w0, ours_pct, ref_median_pct, ref_max_pct)],
    worst_ratio, inside_envelope, worst_ratio_max, within_max} or
    None."""
    g = load_golden(golden_name)
    if g is None:
        return None
    ref_status = np.asarray(g["status"])
    ref_poses = np.asarray(g["poses"])
    trajs = []
    for r in range(ref_status.shape[0]):
        idx = np.where(ref_status[r] == 1)[0]
        trajs.append((idx, ref_poses[r][idx][:, :3, 3]))
    our_idx = np.where(np.asarray(our_status) == 1)[0]
    our_t = np.asarray(our_poses)[our_idx][:, :3, 3]
    n = ref_status.shape[1]

    rows, ratios = [], []
    for w0 in range(0, n, window):
        w1 = min(w0 + window, n)
        ours_best = None
        for ridx, rt in trajs:
            common = np.intersect1d(our_idx, ridx)
            common = common[(common >= w0) & (common < w1)]
            if len(common) < 10:
                continue
            po = {int(v): k for k, v in enumerate(our_idx)}
            pr = {int(v): k for k, v in enumerate(ridx)}
            co = our_t[[po[int(c)] for c in common]]
            cr = rt[[pr[int(c)] for c in common]]
            span = float(np.linalg.norm(cr.max(0) - cr.min(0)))
            if span < 1e-9:
                continue
            a = 100.0 * sim3_align_ate(co, cr) / span
            ours_best = a if ours_best is None else min(ours_best, a)
        pairs = _window_pairs(trajs, w0, w1)
        if ours_best is None or not pairs:
            continue
        med, mx = float(np.median(pairs)), float(max(pairs))
        rows.append((w0, float(ours_best), med, mx))
        ratios.append(ours_best / max(med, 1e-9))
    if not rows:
        return None
    worst = float(max(ratios))
    worst_max = float(max(o / max(x, 1e-9) for _, o, _, x in rows))
    return {"windows": rows, "worst_ratio": worst,
            "inside_envelope": bool(worst <= 1.0),
            "worst_ratio_max": worst_max,
            "within_max": bool(worst_max <= 1.0)}


def ate_vs_reference(our_status: np.ndarray, our_poses: np.ndarray,
                     golden_name: str) -> Optional[dict]:
    """Score our trajectory against every recorded reference run.

    Returns a dict with:
      ate_pct       — min over reference runs of sim3-ATE(ours, ref) on
                      commonly-tracked frames, as % of the reference
                      trajectory span;
      ref_noise_pct — max pairwise sim3-ATE between reference runs
                      (the reference's own nondeterminism floor), same
                      normalization;
      ref_noise_median_pct — MEDIAN pairwise sim3-ATE between reference
                      runs.  The defensible pass criterion on a
                      nondeterministic reference (std::random_device
                      RANSAC seeds, reference system.cpp:210) is
                      ``ate_pct <= max(1.0, ref_noise_median_pct)``:
                      either the 1%-of-span accuracy target, or
                      our trajectory is closer to a reference run than
                      reference runs typically are to each other —
                      i.e. statistically indistinguishable from one
                      more reference run;
      parity_pass   — that criterion, evaluated;
      overlap       — number of commonly tracked frames used;
    or None when the golden file is absent or overlap is too small.
    """
    g = load_golden(golden_name)
    if g is None:
        return None
    ref_status = np.asarray(g["status"])   # [R, N]
    ref_poses = np.asarray(g["poses"])     # [R, N, 4, 4]
    our_idx = np.where(np.asarray(our_status) == 1)[0]

    ates, spans, overlaps, commons = [], [], [], []
    ref_trajs = []
    for r in range(ref_status.shape[0]):
        ridx, rt = _traj(ref_status[r], ref_poses[r])
        ref_trajs.append((ridx, rt))
        common = np.intersect1d(our_idx, ridx)
        if len(common) < 10:
            continue
        ours_c = np.asarray(our_poses)[common][:, :3, 3]
        pos = {int(v): k for k, v in enumerate(ridx)}
        ref_c = rt[[pos[int(c)] for c in common]]
        span = float(np.linalg.norm(ref_c.max(0) - ref_c.min(0)))
        if span < 1e-9:
            continue
        ates.append(100.0 * sim3_align_ate(ours_c, ref_c) / span)
        spans.append(span)
        overlaps.append(len(common))
        commons.append((r, common))
    if not ates:
        return None

    # reference self-consistency across runs (nondeterminism floor)
    pairwise = []
    for a in range(len(ref_trajs)):
        for b in range(a + 1, len(ref_trajs)):
            ia, ta = ref_trajs[a]
            ib, tb = ref_trajs[b]
            common = np.intersect1d(ia, ib)
            if len(common) < 10:
                continue
            pa = {int(v): k for k, v in enumerate(ia)}
            pb = {int(v): k for k, v in enumerate(ib)}
            ca = ta[[pa[int(c)] for c in common]]
            cb = tb[[pb[int(c)] for c in common]]
            span = float(np.linalg.norm(cb.max(0) - cb.min(0)))
            if span < 1e-9:
                continue
            pairwise.append(100.0 * sim3_align_ate(ca, cb) / span)
    noise = max(pairwise) if pairwise else 0.0
    noise_med = float(np.median(pairwise)) if pairwise else 0.0

    best = int(np.argmin(ates))
    r, common = commons[best]
    ridx, _ = ref_trajs[r]
    pos = {int(v): k for k, v in enumerate(ridx)}
    ref_T = ref_poses[r][[pos[int(c)] for c in common]]
    rpe = rpe_rmse(np.asarray(our_poses)[common], ref_T)
    ate_pct = float(ates[best])
    return {"ate_pct": ate_pct,
            "ref_noise_pct": float(noise),
            "ref_noise_median_pct": noise_med,
            "parity_pass": bool(ate_pct <= max(1.0, noise_med)),
            "n_ref_runs": int(ref_status.shape[0]),
            "overlap": int(overlaps[best]),
            "span": float(spans[best]),
            "rpe_trans": rpe["trans_rmse"],
            "rpe_rot_deg": rpe["rot_rmse_deg"]}
