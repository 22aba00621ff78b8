"""Constant tables of the port, copied to each device once.

A tensor built from host memory on a CUDA device is a pageable copy that
the host waits for, so nothing that runs per frame, per keyframe or per
solver iteration builds one: it takes its module's numpy table from here.
"""

from __future__ import annotations

import numpy as np
import torch

_ON_DEVICE: dict = {}


def device_table(table: np.ndarray, device) -> torch.Tensor:
    """The module-level constant ``table`` on ``device``, copied there on
    first use and kept (keyed by the table's identity, which the cache
    keeps alive)."""
    key = (id(table), str(torch.device(device)))
    hit = _ON_DEVICE.get(key)
    if hit is None:
        hit = _ON_DEVICE[key] = (table, torch.as_tensor(table, device=device))
    return hit[1]
