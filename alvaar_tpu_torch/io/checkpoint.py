"""Map checkpoint: save/load the whole SLAM state to/from one ``.npz``
file (port of alvaar_tpu/io/checkpoint.py).

The layout is the JAX package's, so a map saved by either package loads
into the other: one array per state leaf, ``leaf_0000`` … ``leaf_0038`` in
the JAX pytree's order (the order of ``MapState.tensors()``, then the PRNG
key), and a JSON header ``__alvaar_header__`` with the format version,
the shape-determining config fingerprint, the full config and the leaf
count.  Descriptors are written as uint32 and integers as int32.

The random stream: ``leaf_0038`` is the key ``map_state_to_numpy``
derives from the generator's initial seed, and the generator's own state
goes in the extra array ``rng_state`` (the JAX package reads only the
leaves and the header).  A JAX key read by the port seeds a fresh
generator.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.worldmap.state import (
    MapState,
    init_map_state,
    map_state_from_numpy,
    map_state_to_numpy,
)

_FORMAT_VERSION = 1
_HEADER_KEY = "__alvaar_header__"


def _config_fingerprint(cfg: SlamConfig) -> dict:
    """The config fields that determine state shapes."""
    return {
        "width": cfg.width,
        "height": cfg.height,
        "cell_size": cfg.cell_size,
        "pyramid_levels": cfg.pyramid_levels,
        "window_size": cfg.window_size,
        "max_landmarks": cfg.max_landmarks,
        "desc_bag_size": cfg.desc_bag_size,
        "dtype": cfg.dtype,
    }


def _leaf_names(cfg: SlamConfig) -> list:
    """Leaf names in the JAX pytree's order."""
    return [name for name, _ in init_map_state(cfg, "cpu").tensors()] + ["rng_key"]


def save_map(path: str, state: MapState, cfg: SlamConfig) -> None:
    """Write ``state`` to ``path`` (.npz)."""
    d = map_state_to_numpy(state)
    names = _leaf_names(cfg)
    header = {
        "format_version": _FORMAT_VERSION,
        "config": _config_fingerprint(cfg),
        "full_config": dataclasses.asdict(cfg),
        "num_leaves": len(names),
    }
    arrays = {f"leaf_{i:04d}": d[name] for i, name in enumerate(names)}
    arrays["rng_state"] = d["rng_state"]
    arrays[_HEADER_KEY] = np.frombuffer(json.dumps(header).encode("utf-8"), np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _read_header(data) -> dict:
    return json.loads(bytes(data[_HEADER_KEY]).decode("utf-8"))


def load_map(path: str, cfg: SlamConfig, device="cuda") -> MapState:
    """Read a map written by either package's ``save_map`` onto ``device``.
    Raises ValueError on a format-version or shape-fingerprint mismatch."""
    with np.load(path) as data:
        header = _read_header(data)
        if header["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {header['format_version']} != "
                             f"{_FORMAT_VERSION}")
        want, have = _config_fingerprint(cfg), header["config"]
        if have != want:
            diff = {k: (have.get(k), want[k]) for k in want if have.get(k) != want[k]}
            raise ValueError(f"checkpoint/config shape mismatch: {diff}")
        names = _leaf_names(cfg)
        if header["num_leaves"] != len(names):
            raise ValueError(f"checkpoint has {header['num_leaves']} leaves, "
                             f"the state {len(names)}")
        d = {name: data[f"leaf_{i:04d}"] for i, name in enumerate(names)}
        if "rng_state" in data:
            d["rng_state"] = data["rng_state"]
    return map_state_from_numpy(d, cfg, device)


def saved_config(path: str) -> SlamConfig:
    """The full SlamConfig a checkpoint was written under."""
    with np.load(path) as data:
        return SlamConfig(**_read_header(data)["full_config"])
