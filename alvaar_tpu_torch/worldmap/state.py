"""The SLAM map as one fixed-shape set of device tensors.

Port of alvaar_tpu/worldmap/state.py.  The current frame's keypoints are
[K] slots bound to landmark pool ids, the keyframe window is a [W] ring
with [W, K] observation tables, and the landmark pool is [L] slots with
validity masks and an [L, W] observation incidence.  Nothing is
allocated or freed while tracking: removal flips masks, creation claims
free slots.

Differences from the JAX package:

* ``MapState`` is a dataclass; ``replace`` returns a shallow copy with
  some fields swapped (the JAX ``_replace``).
* Descriptors (``lm_desc``, ``lm_desc_bag``) are int32 tensors holding the
  uint32 bits (torch's uint32 supports few operations).
* The JAX PRNG key becomes ``rng``, a ``torch.Generator`` on the state's
  device seeded from ``cfg.seed``; its draws differ from threefry's.
* Multi-stream serving stacks B states into one ``MapState`` whose tensors
  have a leading [B] axis (pyramid levels [B, H, W]) and whose ``rng`` is
  a tuple of B generators (``init_multistream_state``, the JAX package's
  parallel/multistream.py version).  ``state_row`` gives one stream as a
  single-stream state of views, ``stack_states`` stacks rows into a
  sub-state, ``gather_rows`` gathers rows of a stacked state into one,
  ``map_rows`` runs a single-stream phase on every row of a stack under
  ``torch.func.vmap``, and ``write_rows`` writes a sub-state's rows back.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.func import vmap

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.geom.lie import SE3


@dataclasses.dataclass
class MapState:
    # ---- current frame ----
    pose: SE3                  # T_cw of the current frame
    kp_px: torch.Tensor        # [K, 2] raw (distorted) pixels
    kp_und: torch.Tensor       # [K, 2] undistorted pixels
    kp_lm: torch.Tensor        # [K] int64 landmark slot per keypoint
    kp_valid: torch.Tensor     # [K] bool
    prev_pyr: Tuple[torch.Tensor, ...]  # previous frame pyramid
    # ---- keyframe ring [W] ----
    kf_pose: SE3               # [W] T_cw
    kf_valid: torch.Tensor     # [W] bool
    kf_id: torch.Tensor        # [W] int64 (-1 empty)
    kf_obs_lm: torch.Tensor    # [W, K] int64
    kf_obs_px: torch.Tensor    # [W, K, 2] undistorted
    kf_obs_valid: torch.Tensor  # [W, K] bool
    # ---- landmark pool [L] ----
    lm_pos: torch.Tensor       # [L, 3]
    lm_anchor: torch.Tensor    # [L] int64 anchor ring slot
    lm_mxy: torch.Tensor       # [L, 2]
    lm_invd: torch.Tensor      # [L]
    lm_valid: torch.Tensor     # [L] bool
    lm_is3d: torch.Tensor      # [L] bool
    lm_obs: torch.Tensor       # [L, W] bool
    lm_desc: torch.Tensor      # [L, 8] int32 (uint32 bits)
    lm_desc_bag: torch.Tensor  # [L, G, 8] int32 (uint32 bits)
    lm_desc_cnt: torch.Tensor  # [L] int64
    lm_color: torch.Tensor     # [L] float32
    # ---- motion model ----
    vel: torch.Tensor          # [6]
    # ---- bookkeeping scalars (0-d tensors on the device) ----
    frame_id: torch.Tensor
    next_kf_id: torch.Tensor
    cur_kf_slot: torch.Tensor
    last_kf_frame_id: torch.Tensor
    ready_for_init: torch.Tensor
    pose_failures: torch.Tensor
    reset_requested: torch.Tensor
    p3p_req: torch.Tensor
    kf_pending: torch.Tensor
    detect_quality: torch.Tensor
    rng: torch.Generator
    # not a field: the next frame's branch, which the single-stream step
    # leaves on the state it returns (frontend/step.py ``Branch``); a state
    # made any other way, ``replace`` included, has none
    next_branch = None

    def replace(self, **changes) -> "MapState":
        return dataclasses.replace(self, **changes)

    def tensors(self):
        """(name, tensor) for every tensor field, SE3 and pyramid included."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "rng":
                continue
            if isinstance(v, SE3):
                yield f.name + ".q", v.q
                yield f.name + ".t", v.t
            elif isinstance(v, tuple):
                for i, level in enumerate(v):
                    yield f"{f.name}.{i}", level
            elif isinstance(v, torch.Tensor):
                yield f.name, v


_INT = torch.int64


def from_tensors(d: dict, rng=None) -> MapState:
    """A MapState from {name: tensor} named as :meth:`MapState.tensors`
    names them; a pyramid left out of ``d`` becomes ``()``."""
    fields = {}
    for f in dataclasses.fields(MapState):
        if f.name == "rng":
            continue
        if f.name in ("pose", "kf_pose"):
            fields[f.name] = SE3(d[f.name + ".q"], d[f.name + ".t"])
        elif f.name == "prev_pyr":
            n = sum(1 for k in d if k.startswith("prev_pyr."))
            fields[f.name] = tuple(d[f"prev_pyr.{i}"] for i in range(n))
        else:
            fields[f.name] = d[f.name]
    return MapState(rng=rng, **fields)


def _new_generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def init_map_state(cfg: SlamConfig, device="cuda", dtype=torch.float32,
                   rng: torch.Generator | None = None) -> MapState:
    K, W, L = cfg.max_keypoints, cfg.window_size, cfg.max_landmarks
    dev = torch.device(device)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    s = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)
    return MapState(
        pose=SE3.identity(dtype=dtype, device=dev),
        kp_px=z(K, 2), kp_und=z(K, 2), kp_lm=z(K, dt=_INT),
        kp_valid=z(K, dt=torch.bool),
        prev_pyr=tuple(z(*shape) for shape in cfg.pyr_shapes),
        kf_pose=SE3.identity((W,), dtype, dev),
        kf_valid=z(W, dt=torch.bool),
        kf_id=torch.full((W,), -1, dtype=_INT, device=dev),
        kf_obs_lm=z(W, K, dt=_INT), kf_obs_px=z(W, K, 2),
        kf_obs_valid=z(W, K, dt=torch.bool),
        lm_pos=z(L, 3), lm_anchor=z(L, dt=_INT), lm_mxy=z(L, 2),
        lm_invd=torch.ones(L, dtype=dtype, device=dev),
        lm_valid=z(L, dt=torch.bool), lm_is3d=z(L, dt=torch.bool),
        lm_obs=z(L, W, dt=torch.bool),
        lm_desc=z(L, 8, dt=torch.int32),
        lm_desc_bag=z(L, cfg.desc_bag_size, 8, dt=torch.int32),
        lm_desc_cnt=z(L, dt=_INT), lm_color=z(L),
        vel=z(6),
        frame_id=s(0, _INT), next_kf_id=s(0, _INT), cur_kf_slot=s(0, _INT),
        last_kf_frame_id=s(0, _INT), ready_for_init=s(False, torch.bool),
        pose_failures=s(0, _INT), reset_requested=s(False, torch.bool),
        p3p_req=s(False, torch.bool), kf_pending=s(False, torch.bool),
        detect_quality=s(cfg.detector_quality, torch.float32),
        rng=rng if rng is not None else _new_generator(dev, cfg.seed),
    )


def reset_map_state(state: MapState, cfg: SlamConfig) -> MapState:
    """Full reset keeping only the random stream and the adapted detector
    threshold."""
    fresh = init_map_state(cfg, state.kp_px.device, state.kp_px.dtype, state.rng)
    return fresh.replace(detect_quality=state.detect_quality)


# ---------------------------------------------------------------------------
# Carried state: numpy dict <-> MapState
# ---------------------------------------------------------------------------

_DESC_FIELDS = ("lm_desc", "lm_desc_bag")


def map_state_to_numpy(state: MapState) -> dict:
    """MapState → {name: ndarray}.  Keys are the field names, ``pose.q``/
    ``pose.t`` and ``kf_pose.q``/``kf_pose.t`` for the poses, and
    ``prev_pyr.<level>`` for the pyramid.  Descriptors come back as uint32
    and integer fields as int32, as in the JAX package's state.  The random
    stream is saved twice: as ``rng_key``, the uint32[2] key ``(seed >> 32,
    seed & 0xffffffff)`` of the generator's initial seed (a JAX key read by
    :func:`map_state_from_numpy` comes back unchanged), and as
    ``rng_state``, the generator's own state bytes."""
    out = {}
    for name, t in state.tensors():
        a = t.detach().cpu().numpy()
        if name in _DESC_FIELDS:
            a = a.view(np.uint32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = a
    seed = state.rng.initial_seed()
    out["rng_key"] = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    out["rng_state"] = state.rng.get_state().numpy()
    return out


def map_state_from_numpy(d: dict, cfg: SlamConfig, device="cuda") -> MapState:
    """{name: ndarray} (as written by :func:`map_state_to_numpy`, or built
    from a JAX MapState with ``np.asarray``) → MapState on ``device``.

    The random stream: ``rng_state`` restores a port generator of the same
    device type exactly; otherwise a JAX ``rng_key`` [2] uint32 becomes the
    seed ``key[0] << 32 | key[1]`` of a fresh generator (the JAX key cannot
    be carried over bit for bit)."""
    state = init_map_state(cfg, device)
    dev = torch.device(device)
    changes = {}
    for name, ref in state.tensors():
        a = np.asarray(d[name])
        if name in _DESC_FIELDS:
            a = np.ascontiguousarray(a).view(np.int32)
        t = torch.as_tensor(np.array(a), device=dev).to(ref.dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
        changes[name] = t
    for se3 in ("pose", "kf_pose"):
        changes[se3] = SE3(changes.pop(se3 + ".q"), changes.pop(se3 + ".t"))
    n_lvl = len(state.prev_pyr)
    changes["prev_pyr"] = tuple(changes.pop(f"prev_pyr.{i}") for i in range(n_lvl))
    rng_state = np.asarray(d.get("rng_state", ()), np.uint8)
    if rng_state.size == state.rng.get_state().numel():
        state.rng.set_state(torch.as_tensor(rng_state))
    else:
        key = np.asarray(d["rng_key"]).astype(np.uint64)
        state.rng.manual_seed(int(key[0]) << 32 | int(key[1]))
    return state.replace(**changes)


# ---------------------------------------------------------------------------
# Stacked multi-stream state
# ---------------------------------------------------------------------------

def map_tensors(fn, state: MapState, *others: MapState) -> MapState:
    """A state whose every tensor (SE3 parts and pyramid levels included)
    is ``fn(tensor, *the same tensor of others)``; ``rng`` is ``state``'s."""
    def apply(v, *ws):
        if isinstance(v, SE3):
            return SE3(fn(v.q, *(w.q for w in ws)), fn(v.t, *(w.t for w in ws)))
        if isinstance(v, tuple):
            return tuple(fn(*xs) for xs in zip(v, *ws))
        return fn(v, *ws)

    return state.replace(**{
        f.name: apply(getattr(state, f.name), *(getattr(o, f.name) for o in others))
        for f in dataclasses.fields(state) if f.name != "rng"})


def stack_states(rows) -> MapState:
    """B single-stream states → one stacked state ([B] leading axis, the
    rows' generators as a tuple)."""
    rows = list(rows)
    stacked = map_tensors(lambda *ts: torch.stack(ts), *rows)
    return stacked.replace(rng=tuple(r.rng for r in rows))


def _stream_seeds(seed: int, num_streams: int) -> list:
    """Distinct 63-bit generator seeds for ``num_streams`` streams, derived
    from ``seed`` (the counterpart of splitting one JAX key)."""
    words = np.random.SeedSequence(seed).generate_state(num_streams, np.uint64)
    return [int(w) >> 1 for w in words]


def init_multistream_state(cfg: SlamConfig, num_streams: int, seed: int = 0,
                           device="cuda", dtype=torch.float32) -> MapState:
    """Stacked fresh state of ``num_streams`` streams, each with its own
    generator seeded distinctly from ``seed``."""
    dev = torch.device(device)
    return stack_states(init_map_state(cfg, dev, dtype, _new_generator(dev, s))
                        for s in _stream_seeds(seed, num_streams))


def num_streams(states: MapState) -> int:
    return len(states.rng)


def state_row(states: MapState, i: int) -> MapState:
    """Stream ``i`` of a stacked state as a single-stream state: views of
    the stacked tensors (the step never writes into its input) and the
    stream's own generator."""
    return map_tensors(lambda t: t[i], states).replace(rng=states.rng[i])


def write_rows(states: MapState, idx, sub: MapState, mask=None) -> MapState:
    """``states`` with row ``idx[j]`` replaced by row j of the stacked
    sub-state ``sub`` where ``mask[j]`` (a list of bools, all by default);
    returns a new state, ``states`` is not written."""
    keep = [j for j in range(len(idx)) if mask is None or mask[j]]
    if not keep:
        return states
    dev = states.kp_px.device
    dst = torch.tensor([idx[j] for j in keep], dtype=_INT, device=dev)
    src = torch.tensor(keep, dtype=_INT, device=dev)
    rng = list(states.rng)
    for j in keep:
        rng[idx[j]] = sub.rng[j]
    return map_tensors(lambda full, part: full.index_copy(0, dst, part.index_select(0, src)),
                       states, sub).replace(rng=tuple(rng))


def gather_rows(states: MapState, rows) -> MapState:
    """Rows ``rows`` (stream indices) of a stacked state as a stacked
    sub-state: one ``index_select`` per tensor, the rows' generators."""
    index = torch.tensor(rows, dtype=_INT, device=states.kp_px.device)
    return map_tensors(lambda t: t.index_select(0, index), states).replace(
        rng=tuple(states.rng[i] for i in rows))


def map_rows(fn, states: MapState, *args) -> MapState:
    """``fn`` (a single-stream state and one row of each of ``args`` → a
    state) on every row of the stacked ``states`` at once, under
    ``torch.func.vmap``, as the JAX package's ``jax.vmap`` of a phase.
    ``fn`` draws nothing (random numbers come in through ``args``), so
    the generators pass through untouched."""
    out = vmap(lambda d, *a: dict(fn(from_tensors(d), *a).tensors()))(
        dict(states.tensors()), *args)
    return from_tensors(out, rng=states.rng)


def select_rows(mask, new: MapState, old: MapState) -> MapState:
    """Per stream: ``new``'s row where ``mask`` [B] holds, else ``old``'s
    (the JAX package's ``_row_select``).  Generators are ``new``'s: a
    caller masks only rows that drew nothing."""
    def sel(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return map_tensors(sel, new, old)


def multistream_state_to_numpy(states: MapState) -> dict:
    """Stacked state → {name: ndarray with a leading [B] axis}, each row as
    :func:`map_state_to_numpy` writes it (``rng_key`` [B, 2], ``rng_state``
    [B, n])."""
    rows = [map_state_to_numpy(state_row(states, i)) for i in range(num_streams(states))]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def multistream_state_from_numpy(d: dict, cfg: SlamConfig, device="cuda") -> MapState:
    """{name: ndarray with a leading [B] axis} (from
    :func:`multistream_state_to_numpy`, or a stacked JAX MapState through
    ``np.asarray``) → stacked state on ``device``; rows as
    :func:`map_state_from_numpy` reads them."""
    b = np.asarray(d["frame_id"]).shape[0]
    return stack_states(map_state_from_numpy({k: np.asarray(v)[i] for k, v in d.items()},
                                             cfg, device) for i in range(b))


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def covisibility(state: MapState):
    """[W, W] shared-3D-observation counts (one matmul over the incidence)."""
    f = (state.lm_obs & (state.lm_valid & state.lm_is3d)[:, None]).to(torch.float32)
    return (f.T @ f).to(_INT)


def landmark_world_positions(kf_pose: SE3, lm_anchor, lm_mxy, lm_invd):
    """[L, 3] world positions from the anchored inverse-depth parameters."""
    T_a = kf_pose[lm_anchor]
    invd_safe = torch.where(torch.abs(lm_invd) < 1e-9, 1e-9, lm_invd)
    X_a = torch.cat([lm_mxy, torch.ones_like(lm_invd)[:, None]], dim=-1) / invd_safe[:, None]
    return T_a.inverse().apply(X_a)


def apply_world_correction(state: MapState, dT: SE3, scale=None) -> MapState:
    """Re-gauge the whole map rigidly by a world-frame transform
    ``X_w' = s · dT · X_w`` (the loop-closure correction).  Landmarks are
    anchored inverse depth relative to their anchor keyframe, so moving
    every keyframe pose and world position together keeps them valid;
    ``scale`` (sim3) rescales translations and depths about the origin."""
    s = torch.as_tensor(1.0 if scale is None else scale, dtype=state.lm_pos.dtype,
                        device=state.lm_pos.device)
    dT_inv = dT.inverse()

    def fix_pose(T_cw: SE3) -> SE3:
        # T_cw' = T_cw ∘ (s·dT)⁻¹: rotation from dT, translation rescaled
        out = T_cw.compose(dT_inv)
        return SE3(out.q, s * T_cw.t + T_cw.rotate(dT_inv.t.expand(T_cw.t.shape)))

    return state.replace(pose=fix_pose(state.pose), kf_pose=fix_pose(state.kf_pose),
                         lm_pos=s * dT.rotate(state.lm_pos) + dT.t,
                         lm_invd=state.lm_invd / s)


def masked_scatter_set(arr, idx, values, mask):
    """``arr[idx[i]] = values[i]`` only where ``mask[i]``; returns a new
    tensor.  ``index_put_`` with colliding indices is nondeterministic on
    CUDA (and on the CPU on more than one thread), so masked-out rows go
    to a padded dummy row, and where live
    writes collide (local BA writes a merged landmark once per column it
    holds, ``solvers/ba.py``) only the last one (the highest i) is kept:
    the result of a serial loop, and of the JAX package's scatter on the
    CPU, on every device."""
    n = arr.shape[0]
    pos = torch.arange(idx.shape[0], device=idx.device)
    safe_idx = torch.where(mask, idx, n)
    last = torch.full((n + 1,), -1, dtype=pos.dtype, device=idx.device).scatter_reduce(
        0, safe_idx, pos, reduce="amax")
    safe_idx = torch.where(mask & (last[safe_idx] == pos), idx, n)
    pad = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
    pad[safe_idx] = values.to(arr.dtype)
    return pad[:n]


def allocate_slots(valid_mask, want_mask):
    """Claim distinct free slots in a fixed pool for the wanted requests.
    Returns (slot_idx [N], granted [N])."""
    n = want_mask.shape[0]
    L = valid_mask.shape[0]
    free_score = torch.where(valid_mask, -torch.inf,
                             -torch.arange(L, dtype=torch.float32,
                                           device=valid_mask.device))
    free_slots = torch.topk(free_score, n).indices     # scores are distinct
    num_free = torch.sum(~valid_mask)
    rank = torch.cumsum(want_mask.to(_INT), dim=0) - 1
    granted = want_mask & (rank < num_free) & (rank < n)
    return free_slots[rank.clamp(0, n - 1)], granted
