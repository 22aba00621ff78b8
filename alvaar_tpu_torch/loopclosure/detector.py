"""Loop-closure detection and relocalization over a keyframe database
(port of alvaar_tpu/loopclosure/detector.py).

The database is a fixed ring of the last D keyframes' descriptor sets,
their landmarks' 3D positions and poses.  A query is a dense Hamming pass
against it (after a coarse prefilter once the ring holds more than
``prefilter`` entries), kNN with the NNDR ratio filter, image voting,
min-max normalisation, temporal islands with priority for the previous
match, and an id-distance delay gate.  Relocalization matches a query to
stored 3D landmarks and solves P3P-LMedS.

The JAX package keeps a ±1 int8 unpack of the database resident for its
MXU contraction and reduces the [Kq, M] distance matrix to each query's
best two; the port keeps the packed words only, and each query's Hamming
pass is ``ops/hamming.hamming_best_two``: on CUDA tensors K4 computes the
masked best two without writing the matrix (one launch, two with its
merge, also under ``torch.func.vmap``), on CPU tensors the same
composition as the JAX package's.  ``hamming_best_two.calls`` counts the
passes.  The coarse per-entry signature ``sig`` (mean of the ±1 bits of
the entry's valid descriptors) is computed from the packed words with
shifts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from alvaar_tpu_torch.geom.lie import SE3
from alvaar_tpu_torch.ops.hamming import DESC_BITS, hamming_best_two
from alvaar_tpu_torch.ops.topk import top_k
from alvaar_tpu_torch.solvers.absolute import AbsolutePoseResult, p3p_lmeds
from alvaar_tpu_torch.solvers.pnp import pnp_refine

_INT = torch.int64


@dataclasses.dataclass
class LoopDB:
    desc: torch.Tensor       # [D, K, 8] int32 (uint32 bits)
    sig: torch.Tensor        # [D, 256] float32 coarse per-entry signature
    lm_pos: torch.Tensor     # [D, K, 3] landmark world positions at store time
    lm_is3d: torch.Tensor    # [D, K] bool
    kp_valid: torch.Tensor   # [D, K] bool
    kf_id: torch.Tensor      # [D] int64 global keyframe id (-1 empty)
    pose_q: torch.Tensor     # [D, 4] stored T_cw
    pose_t: torch.Tensor     # [D, 3]
    ptr: torch.Tensor        # 0-d ring pointer
    last_match: torch.Tensor  # 0-d kf id of the previous detection (-1 none)

    def replace(self, **changes) -> "LoopDB":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class LoopResult:
    found: torch.Tensor
    entry: torch.Tensor       # database slot of the best match
    match_kf_id: torch.Tensor
    score: torch.Tensor       # island score


def db_init(capacity: int, max_kps: int, device="cuda", dtype=torch.float32) -> LoopDB:
    dev = torch.device(device)
    pose_q = torch.zeros((capacity, 4), dtype=dtype, device=dev)
    pose_q[:, 0] = 1.0
    return LoopDB(
        desc=torch.zeros((capacity, max_kps, 8), dtype=torch.int32, device=dev),
        sig=torch.zeros((capacity, DESC_BITS), dtype=dtype, device=dev),
        lm_pos=torch.zeros((capacity, max_kps, 3), dtype=dtype, device=dev),
        lm_is3d=torch.zeros((capacity, max_kps), dtype=torch.bool, device=dev),
        kp_valid=torch.zeros((capacity, max_kps), dtype=torch.bool, device=dev),
        kf_id=torch.full((capacity,), -1, dtype=_INT, device=dev),
        pose_q=pose_q,
        pose_t=torch.zeros((capacity, 3), dtype=dtype, device=dev),
        ptr=torch.zeros((), dtype=_INT, device=dev),
        last_match=torch.full((), -1, dtype=_INT, device=dev))


def _unpack_pm1(desc):
    """[..., 8] int32 words → [..., 256] float32 in {-1, +1} (bit b of word
    k is entry 32 k + b)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.flatten(-2).to(torch.float32) * 2.0 - 1.0


def _signature(desc, valid, dtype):
    """Mean ±1 bit vector [256] of the valid descriptors."""
    nv = torch.clamp_min(torch.sum(valid), 1).to(dtype)
    return torch.sum(torch.where(valid[:, None], _unpack_pm1(desc), 0.0).to(dtype), dim=0) / nv


def _set_row(arr, i, value):
    """Copy of ``arr`` with row ``i`` (a 0-d index tensor) replaced."""
    return arr.index_copy(0, i.reshape(1), value.to(arr.dtype)[None])


def db_add(db: LoopDB, desc, lm_pos, lm_is3d, kp_valid, kf_id, pose: SE3) -> LoopDB:
    """Insert a keyframe at the ring pointer."""
    i = db.ptr % db.kf_id.shape[0]
    kf_id = torch.as_tensor(kf_id, device=db.kf_id.device)
    return db.replace(
        desc=_set_row(db.desc, i, desc),
        sig=_set_row(db.sig, i, _signature(desc, kp_valid, db.sig.dtype)),
        lm_pos=_set_row(db.lm_pos, i, lm_pos),
        lm_is3d=_set_row(db.lm_is3d, i, lm_is3d),
        kp_valid=_set_row(db.kp_valid, i, kp_valid),
        kf_id=_set_row(db.kf_id, i, kf_id),
        pose_q=_set_row(db.pose_q, i, pose.q),
        pose_t=_set_row(db.pose_t, i, pose.t),
        ptr=db.ptr + 1)


_BIG = 1e9


def detect_loop(db: LoopDB, desc_q, valid_q, query_kf_id, *, nndr: float = 0.8,
                min_score: float = 0.3, island_r: int = 10, delay: int = 50,
                min_votes: int = 8, prefilter: int = 16):
    """Query the database with the current keyframe's descriptors
    ``desc_q`` [Kq, 8].  Past ``prefilter`` stored entries, a coarse
    signature pass picks the top-``prefilter`` entries for the dense pass
    (0: always dense).  Returns (db with the temporal state updated,
    LoopResult)."""
    D, K, _ = db.desc.shape
    query_kf_id = torch.as_tensor(query_kf_id, device=db.kf_id.device)
    entry_ok = (db.kf_id >= 0) & (query_kf_id - db.kf_id > delay)

    if prefilter and D > prefilter:
        qsig = _signature(desc_q, valid_q, db.sig.dtype)
        coarse = torch.where(entry_ok, db.sig @ qsig, -torch.inf)
        _, top_e = top_k(coarse, prefilter)               # [E]
        sub_ok = db.kp_valid[top_e].reshape(-1) & entry_ok[top_e].repeat_interleave(K)
        best, second, bi = hamming_best_two(desc_q, db.desc[top_e].reshape(-1, 8), valid_q,
                                            sub_ok, _BIG)
        match_img = top_e[bi // K]
    else:
        db_ok = db.kp_valid.reshape(-1) & entry_ok.repeat_interleave(K)
        best, second, bi = hamming_best_two(desc_q, db.desc.reshape(-1, 8), valid_q, db_ok,
                                            _BIG)
        match_img = bi // K

    # kNN + NNDR, then one vote per surviving match
    match_ok = (best <= second * nndr) & (best < float(DESC_BITS))
    votes = torch.zeros(D, dtype=torch.float32, device=best.device).index_add(
        0, match_img, match_ok.to(torch.float32))

    # min-max normalisation and cutoff
    has_any = torch.any(votes > 0)
    vmax = torch.max(votes)
    vmin = torch.min(torch.where(db.kf_id >= 0, votes, torch.inf))
    vmin = torch.where(torch.isfinite(vmin), vmin, 0.0)
    norm = (votes - vmin) / torch.clamp_min(vmax - vmin, 1e-9)
    cand = (norm > min_score) & (db.kf_id >= 0) & (votes >= min_votes)

    # temporal islands, with priority for the previous detection's island
    ids = db.kf_id
    near = ((torch.abs(ids[:, None] - ids[None, :]) <= island_r)
            & cand[None, :] & (ids[:, None] >= 0))
    island = (torch.sum(torch.where(near, norm[None, :], 0.0), dim=1)
              / torch.clamp_min(torch.sum(near, dim=1), 1).to(torch.float32))
    island = torch.where(cand, island, -1.0)
    prior = (torch.abs(ids - db.last_match) <= island_r) & (db.last_match >= 0)
    island = island + torch.where(prior & cand, 0.5, 0.0)

    entry = torch.argmax(island)
    found = has_any & cand[entry] & (torch.sum(cand) > 0)
    match_kf = torch.where(found, ids[entry], -1)
    db = db.replace(last_match=torch.where(found, match_kf, db.last_match))
    return db, LoopResult(found=found, entry=entry, match_kf_id=match_kf,
                          score=island[entry])


def _match_entry(db: LoopDB, entry, desc_q, valid_q, nndr: float):
    """NNDR matches of the query to one entry's stored 3D landmarks.
    Returns (matched world points [Kq, 3], match mask [Kq])."""
    ok_db = db.kp_valid[entry] & db.lm_is3d[entry]
    best, second, bi = hamming_best_two(desc_q, db.desc[entry], valid_q, ok_db, _BIG)
    m_ok = (best <= second * nndr) & (best < 64.0)
    return db.lm_pos[entry][bi], m_ok


def verify_loop(db: LoopDB, entry, desc_q, px_q, valid_q, cam, pose0: SE3, *,
                nndr: float = 0.8, iters: int = 8, min_inliers: int = 12):
    """Geometric verification of a detected loop: match the query
    keyframe to the entry's 3D landmarks and refine from the current pose
    ``pose0`` with motion-only LM (a cold P3P picks the far branch on
    near-coplanar matches).  Returns (pose T_cw, success, num_inliers)."""
    pts_w, m_ok = _match_entry(db, entry, desc_q, valid_q, nndr)
    res = pnp_refine(pose0, cam, pts_w, px_q, m_ok, iters=iters,
                     huber_delta=math.sqrt(5.9915))
    n_used = torch.clamp_min(torch.sum(m_ok), 1)
    ok = ((res.num_inliers >= min_inliers) & (res.num_inliers >= 0.5 * n_used)
          & torch.all(torch.isfinite(res.pose.t)))
    return res.pose, ok, res.num_inliers


def relocalize(db: LoopDB, entry, desc_q, bearings_q, valid_q, gen, *, focal,
               nndr: float = 0.8, iters: int = 100, min_inliers: int = 12,
               samples=None) -> AbsolutePoseResult:
    """Absolute pose against one stored keyframe: NNDR matches to its 3D
    landmarks, then P3P-LMedS.  ``samples`` replaces the generator's
    draw."""
    pts_w, m_ok = _match_entry(db, entry, desc_q, valid_q, nndr)
    return p3p_lmeds(gen, bearings_q, pts_w, m_ok, focal=focal, iters=iters,
                     min_inliers=min_inliers, samples=samples)


def relocalize_topk(db: LoopDB, desc_q, bearings_q, valid_q, gen, *, focal,
                    nndr: float = 0.8, iters: int = 100, topk: int = 8,
                    min_inliers: int = 12, samples=None) -> AbsolutePoseResult:
    """Relocalization against the whole database: one dense Hamming pass
    votes for entries, the ``topk`` most-voted are solved with
    P3P-LMedS, and the solve with the most inliers wins.  ``samples``: a
    list of ``topk`` draws, one per entry, replacing the generator's."""
    D, K, _ = db.desc.shape
    db_ok = (db.kp_valid & db.lm_is3d & (db.kf_id >= 0)[:, None]).reshape(-1)
    best, second, bi = hamming_best_two(desc_q, db.desc.reshape(-1, 8), valid_q, db_ok, _BIG)
    m_ok = (best <= second * nndr) & (best < 64.0)
    votes = torch.zeros(D, dtype=torch.float32, device=best.device).index_add_(
        0, bi // K, m_ok.to(torch.float32))
    _, entries = top_k(votes, topk)

    res = [relocalize(db, entries[j], desc_q, bearings_q, valid_q, gen, focal=focal,
                      nndr=nndr, iters=iters, min_inliers=min_inliers,
                      samples=None if samples is None else samples[j])
           for j in range(topk)]
    n_in = torch.stack([torch.where(r.success, r.num_inliers, -1) for r in res])
    b = torch.argmax(n_in)
    pick = lambda xs: torch.stack(xs)[b]
    return AbsolutePoseResult(
        pose=SE3(pick([r.pose.q for r in res]), pick([r.pose.t for r in res])),
        inliers=pick([r.inliers for r in res]),
        num_inliers=pick([r.num_inliers for r in res]),
        success=pick([r.success for r in res]))


# ---------------------------------------------------------------------------
# numpy dict <-> LoopDB
# ---------------------------------------------------------------------------

_FIELDS = [f.name for f in dataclasses.fields(LoopDB)]


def loop_db_to_numpy(db: LoopDB) -> dict:
    """LoopDB → {field: ndarray}: descriptors as uint32 and integers as
    int32, as in the JAX package's LoopDB."""
    out = {}
    for name in _FIELDS:
        a = getattr(db, name).detach().cpu().numpy()
        if name == "desc":
            a = a.view(np.uint32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = a
    return out


def loop_db_from_numpy(d: dict, device="cuda") -> LoopDB:
    """{field: ndarray} (from :func:`loop_db_to_numpy`, or a JAX LoopDB
    through ``np.asarray``; its ``desc_pm`` is not used) → LoopDB."""
    dev = torch.device(device)
    desc = np.ascontiguousarray(np.asarray(d["desc"])).view(np.int32)
    ref = db_init(desc.shape[0], desc.shape[1], dev)
    changes = {}
    for name in _FIELDS:
        a = desc if name == "desc" else np.asarray(d[name])
        t = torch.as_tensor(np.array(a), device=dev).to(getattr(ref, name).dtype)
        if tuple(t.shape) != tuple(getattr(ref, name).shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}")
        changes[name] = t
    return ref.replace(**changes)
