"""Copies between the host and the card that the host does not wait for.

A copy from pageable host memory, or into it, makes the host wait until
the card's stream has caught up; a copy into or out of pinned memory with
``non_blocking=True`` returns at once.  ``ReadRing`` starts small reads
from the device (the step's packed flags, the facade's packed result) into
a few reused pinned buffers, each behind a CUDA event that ``HostRead.get``
waits for; ``UploadRing`` stages frames through reused pinned buffers.  On
the CPU both pass tensors through.
"""

from __future__ import annotations

import numpy as np
import torch


class HostRead:
    """A device tensor's values on the host: ``get`` waits for its copy
    the first time (its event, where ``ReadRing`` started one; else a
    blocking copy) and keeps the values."""

    __slots__ = ("_src", "_buf", "_event", "_np")

    def __init__(self, src, buf=None, event=None):
        self._src, self._buf, self._event, self._np = src, buf, event, None

    def get(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
                self._np = self._buf.numpy().copy()
            else:
                self._np = self._src.detach().cpu().numpy()
            self._src = self._buf = self._event = None
        return self._np


class ReadRing:
    """``slots`` pinned buffers, reused in turn for reads of small device
    tensors.  A buffer is reused only after its previous read has been
    taken: if its reader has not asked yet, the values are copied out for
    it first (its copy finished long before, so that wait is free)."""

    def __init__(self, slots: int = 2):
        self._slots = [None] * slots    # (buffer, event, reader)
        self._next = 0

    def start(self, t: torch.Tensor) -> HostRead:
        """Start copying ``t`` to the host; returns its ``HostRead``."""
        if not t.is_cuda:
            return HostRead(t)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[2].get()
        if slot is None or slot[0].shape != t.shape or slot[0].dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            event = torch.cuda.Event()
        else:
            buf, event = slot[0], slot[1]
        buf.copy_(t, non_blocking=True)
        event.record()
        read = HostRead(t, buf, event)
        self._slots[i] = (buf, event, read)
        return read


class UploadRing:
    """Host arrays to a device through ``slots`` reused pinned buffers: the
    host copies into a buffer, the card copies from it without the host
    waiting.  A buffer is written again only once its last copy to the
    card has finished (an event that long passed when frames come one after
    another)."""

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        self._slots = [None] * slots    # (buffer, event)
        self._next = 0

    def upload(self, array: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return src.to(self.device)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None and not slot[1].query():
            slot[1].synchronize()
        if slot is None or slot[0].shape != src.shape or slot[0].dtype != src.dtype:
            slot = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True), torch.cuda.Event())
            self._slots[i] = slot
        slot[0].copy_(src)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1].record()
        return out
