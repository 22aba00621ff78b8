"""Seeded inputs for the descriptor Hamming kernel K4 (csrc/hamming.cu), in
numpy and the port only (no JAX): the CPU tests
(tests/test_torch_hamming_kernel.py), the card's tests
(tests/test_torch_hamming_kernel_card.py) and chip_smoke.py phase 2d use
them.

``bag_problem`` makes the two sides of a min cross-bag pass: descriptor
bags as local-map matching holds them (bag entries filled in order, some
bags empty), B's bags partly a few bits from A's so that small distances
occur, or filled at random, with an all-empty side, or with all-ones and
all-zero words (distances 256 and 0).  ``seeded_map`` and
``seeded_loop_db`` make a map state and loop databases on which
``match_to_local_map``, ``detect_loop`` and ``relocalize_topk`` do real
work (merges, found loops); ``best_two_problem`` the loop queries' best
two with ties and masks; ``slice_outputs`` runs them and ``digest``
hashes what they return.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

KINDS = ("matching", "scattered", "all-empty side", "extreme words")


def words(rng, *shape) -> np.ndarray:
    """Random 32-bit words as int32 (the port's descriptor words)."""
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


def flip_bits(rng, w: np.ndarray, n_bits: int) -> np.ndarray:
    """``w`` [..., 8] with about ``n_bits`` random bits flipped per
    descriptor."""
    u = w.view(np.uint32).copy()
    for _ in range(n_bits):
        word = rng.integers(0, 8, size=u.shape[:-1])
        bit = rng.integers(0, 32, size=u.shape[:-1]).astype(np.uint32)
        at = word[..., None]
        flipped = np.take_along_axis(u, at, -1) ^ (np.uint32(1) << bit)[..., None]
        np.put_along_axis(u, at, flipped, -1)
    return u.view(np.int32)


def _prefix_filled(rng, rows: int, g: int, s: int) -> np.ndarray:
    cnt = rng.integers(0, g + 2, size=(s, rows))          # 0: an empty bag
    return np.arange(g)[None, None, :] < np.minimum(cnt, g)[..., None]


def bag_problem(rng, S: int, N: int, M: int, G: int, kind: str = "matching", device="cpu"):
    """(bag_a [S, N, G, 8] int32, filled_a [S, N, G] bool, bag_b [S, M, G,
    8], filled_b [S, M, G]) on ``device``."""
    a = words(rng, S, N, G, 8)
    b = words(rng, S, M, G, 8)
    near = rng.integers(0, N, size=(S, M))               # B's bags near an A bag
    take = rng.random((S, M)) < 0.5
    for s in range(S):
        src = a[s, near[s]]
        b[s, take[s]] = flip_bits(rng, src[take[s]][:, rng.permutation(G)], 12)
    fa, fb = _prefix_filled(rng, N, G, S), _prefix_filled(rng, M, G, S)
    if kind == "scattered":
        fa, fb = rng.random((S, N, G)) < 0.6, rng.random((S, M, G)) < 0.6
    elif kind == "all-empty side":
        fb[:] = False
    elif kind == "extreme words":
        a[:, ::3] = -1                                   # all ones
        b[:, ::4] = 0                                    # all zeros: 256 from an all-ones bag
        b[:, 1::4] = -1                                  # all ones: 0 from it
        fa[:, ::3] = True
        fb[:, :2] = True
    elif kind != "matching":
        raise ValueError(kind)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(a), t(fa), t(b), t(fb)


def dense_problem(rng, S: int, N: int, M: int, device="cpu"):
    """(a [S, N, 8], b [S, M, 8]) int32 words: half of b a few bits from a
    row of a, and all-ones / all-zero rows on both sides."""
    a = words(rng, S, N, 8)
    b = words(rng, S, M, 8)
    for s in range(S):
        take = rng.random(M) < 0.5
        b[s, take] = flip_bits(rng, a[s, rng.integers(0, N, size=int(take.sum()))], 10)
    a[:, 0], b[:, 0], b[:, -1] = -1, 0, -1
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(a), t(b)


BEST_TWO_KINDS = ("random", "ties", "masked")


def best_two_problem(rng, S: int, N: int, M: int, kind: str = "random", device="cpu"):
    """(a [S, N, 8], b [S, M, 8] int32 words, row_ok [S, N], col_ok [S, M]
    bool) for the loop queries' best two: ``dense_problem``'s words with
    about 10% of the rows and 20% of the columns masked; "ties" plants,
    for every third row, two equal columns near it (a tie at the best) and,
    for the rows after those, an exact copy and two equal one-bit flips (a
    tie at the second), all unmasked; "masked" masks row 0 of every s, every
    column of s = 0 and every other column of the last s."""
    a = words(rng, S, N, 8)
    b = words(rng, S, M, 8)
    for s in range(S):
        take = rng.random(M) < 0.5
        b[s, take] = flip_bits(rng, a[s, rng.integers(0, N, size=int(take.sum()))], 10)
    row_ok = rng.random((S, N)) < 0.9
    col_ok = rng.random((S, M)) < 0.8
    if kind == "ties" and M >= 3:
        for s in range(S):
            for r in range(0, N, 3):
                c = rng.choice(M, size=3, replace=False)
                near = flip_bits(rng, a[s, r:r + 1], 3)[0]
                b[s, c[0]], b[s, c[1]] = near, near
                col_ok[s, c[:2]] = True
                if r + 1 < N:
                    one = flip_bits(rng, a[s, r + 1:r + 2], 1)[0]
                    b[s, c[2]] = a[s, r + 1]
                    d = rng.choice(np.setdiff1d(np.arange(M), c), size=2, replace=False) \
                        if M >= 5 else c[:2]
                    b[s, d[0]], b[s, d[1]] = one, one
                    col_ok[s, c[2]] = col_ok[s, d] = True
                    row_ok[s, r + 1] = True
            row_ok[s, ::3] = True
    elif kind == "masked":
        row_ok[:, 0] = False
        col_ok[0] = False
        col_ok[-1, ::2] = False
    elif kind not in ("random", "ties"):
        raise ValueError(kind)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(a), t(b), t(row_ok), t(col_ok)


# ---------------------------------------------------------------------------
# The slice: local-map matching and the loop queries on seeded states
# ---------------------------------------------------------------------------

def slice_config():
    from alvaar_tpu_torch.config import SlamConfig
    return SlamConfig(width=320, height=240, cell_size=20, max_landmarks=512, window_size=8)


def seeded_map(seed: int, device="cpu"):
    """A map state at a new keyframe (slot 3) whose young keypoints sit
    within a pixel or two of established landmarks' projections, with bags a
    few bits from theirs: ``match_to_local_map`` merges some of them.
    Returns (state, cam, cfg)."""
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.worldmap.state import init_map_state
    cfg = slice_config()
    cam = Camera.create(250.0, 250.0, 160.0, 120.0)
    rng = np.random.default_rng(seed)
    K, W, L, G = cfg.max_keypoints, cfg.window_size, cfg.max_landmarks, cfg.desc_bag_size
    slot, n_old = 3, L // 2
    st = init_map_state(cfg, device)
    px = rng.uniform([8, 8], [cfg.width - 8, cfg.height - 8], size=(n_old, 2))
    z = rng.uniform(2.0, 8.0, size=n_old)
    pos = np.zeros((L, 3), np.float32)
    pos[:n_old, :2] = (px - [160.0, 120.0]) / 250.0 * z[:, None]
    pos[:n_old, 2] = z
    lm_valid = np.zeros(L, bool)
    lm_valid[:n_old + K] = True
    lm_is3d = np.zeros(L, bool)
    lm_is3d[:n_old] = rng.random(n_old) < 0.9
    lm_obs = np.zeros((L, W), bool)
    lm_obs[:n_old, :3] = rng.random((n_old, 3)) < 0.5
    lm_obs[:n_old, 0] |= ~lm_obs[:n_old, :3].any(1)
    young = n_old + np.arange(K)
    lm_obs[young, slot] = True
    bag = words(rng, L, G, 8)
    cnt = rng.integers(0, G + 2, size=L)
    # young keypoints: half near an old landmark's projection, with its bag a
    # few bits off
    src = rng.choice(n_old, size=K, replace=False)
    near = rng.random(K) < 0.5
    kp_px = rng.uniform([4, 4], [cfg.width - 4, cfg.height - 4], size=(K, 2))
    kp_px[near] = px[src[near]] + rng.uniform(-1.5, 1.5, size=(int(near.sum()), 2))
    bag[young[near]] = flip_bits(rng, bag[src[near]], 6)
    cnt[young[near]] = np.maximum(cnt[young[near]], 1)
    cnt[src[near]] = np.maximum(cnt[src[near]], 1)
    kp_valid = rng.random(K) < 0.9
    kf_valid = np.zeros(W, bool)
    kf_valid[[0, 1, 2, slot]] = True
    kf_obs_lm = np.zeros((W, K), np.int64)
    kf_obs_lm[slot] = young
    kf_obs_valid = np.zeros((W, K), bool)
    kf_obs_valid[slot] = kp_valid
    kf_obs_px = np.zeros((W, K, 2), np.float32)
    kf_obs_px[slot] = kp_px
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    st = st.replace(
        lm_pos=t(pos), lm_valid=t(lm_valid), lm_is3d=t(lm_is3d), lm_obs=t(lm_obs),
        lm_desc_bag=t(bag), lm_desc_cnt=t(cnt), kp_lm=t(young.astype(np.int64)),
        kp_px=t(kp_px.astype(np.float32)), kp_und=t(kp_px.astype(np.float32)),
        kp_valid=t(kp_valid), kf_valid=t(kf_valid), kf_obs_lm=t(kf_obs_lm),
        kf_obs_valid=t(kf_obs_valid), kf_obs_px=t(kf_obs_px),
        cur_kf_slot=torch.tensor(slot, device=device))
    return st, cam, cfg


LOOP_K = 96


def seeded_loop_db(seed: int, capacity: int, n_entries: int, device="cpu"):
    """A loop database of ``n_entries`` keyframes (LOOP_K random
    descriptors each, 3D landmarks in front of the camera), and queries: a
    revisit of entry 3 (a few bits off), one of entry 4, a novel keyframe.
    Returns (db, [(desc, valid, query_kf_id)], bearings of the first
    query [K, 3])."""
    from alvaar_tpu_torch.geom.lie import SE3
    from alvaar_tpu_torch.loopclosure import detector
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    db = detector.db_init(capacity, LOOP_K, device)
    descs = []
    for i in range(n_entries):
        d = words(rng, LOOP_K, 8)
        pts = rng.uniform([-2, -2, 3], [2, 2, 8], size=(LOOP_K, 3)).astype(np.float32)
        valid = rng.random(LOOP_K) < 0.9
        pose = SE3(t(np.array([1.0, 0.0, 0.0, 0.0], np.float32)),
                   t(rng.normal(size=3).astype(np.float32) * 0.1))
        db = detector.db_add(db, t(d), t(pts), t(valid), t(valid), i, pose)
        descs.append((d, pts))
    queries = [(flip_bits(rng, descs[3][0], 8), n_entries + 60),
               (flip_bits(rng, descs[4][0], 5), n_entries + 61),
               (words(rng, LOOP_K, 8), n_entries + 62)]
    queries = [(t(d), t(rng.random(LOOP_K) < 0.95), qid) for d, qid in queries]
    pts = descs[3][1]
    bearings = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    return db, queries, t(bearings.astype(np.float32))


def slice_outputs(device="cpu") -> dict:
    """``match_to_local_map`` on two seeded maps and the loop queries
    (``detect_loop`` on a dense and a prefiltered database, ``verify_loop``
    and ``relocalize_topk`` on the latter): name → tensor."""
    from alvaar_tpu_torch.geom.camera import Camera
    from alvaar_tpu_torch.geom.lie import SE3
    from alvaar_tpu_torch.loopclosure import detector
    from alvaar_tpu_torch.worldmap.matching import match_to_local_map
    out = {}
    for seed in (0, 1):
        st, cam, cfg = seeded_map(seed, device)
        for name, x in match_to_local_map(st, cam, cfg).tensors():
            out[f"match {seed} {name}"] = x
    for capacity, n in ((12, 10), (24, 22)):        # the dense pass; the prefilter (D > 16)
        db, queries, bearings = seeded_loop_db(capacity, capacity, n, device)
        for j, (d, valid, qid) in enumerate(queries):
            db, res = detector.detect_loop(db, d, valid, qid)
            for f in ("found", "entry", "match_kf_id", "score"):
                out[f"loop {capacity} query {j} {f}"] = getattr(res, f)
        out[f"loop {capacity} last_match"] = db.last_match
    # the revisit of entry 3, seen from the world origin
    d, valid, _ = queries[0]
    cam = Camera.create(250.0, 250.0, 160.0, 120.0)
    px = cam.project(bearings)
    pose0 = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device), torch.zeros(3, device=device))
    p, ok, n_in = detector.verify_loop(db, torch.tensor(3, device=device), d, px, valid, cam,
                                       pose0)
    out.update({"verify q": p.q, "verify t": p.t, "verify ok": ok, "verify n": n_in})
    gen = torch.Generator(device=device).manual_seed(0)
    r = detector.relocalize_topk(db, d, bearings, valid, gen, focal=250.0, iters=20, topk=3)
    out.update({"reloc q": r.pose.q, "reloc t": r.pose.t, "reloc n": r.num_inliers,
                "reloc ok": r.success, "reloc inliers": r.inliers})
    return out


def digest(outputs: dict) -> str:
    """SHA-256 of the outputs' names, dtypes, shapes and bytes, in name
    order; the first 16 hex digits."""
    h = hashlib.sha256()
    for name in sorted(outputs):
        x = outputs[name].detach().cpu().contiguous()
        h.update(f"{name} {x.dtype} {tuple(x.shape)}".encode())
        h.update((x.to(torch.uint8) if x.dtype == torch.bool else x).numpy().tobytes())
    return h.hexdigest()[:16]
