"""Per-stage timing statistics and the port's event counters.

``StageTimer`` and ``Stats`` are the port of alvaar_tpu/utils/stats.py
(the reference's Stats profiler, examples/public/assets/stats.js:3-78:
named ring-buffer timers with running averages), on the host clock.  They
add no device synchronisation: a caller that wants device time uses
utils/profiling.py.

``count`` increments a process-wide counter kept as an attribute of the
function that counts (``fb_klt_track.launches``, ``host_bool.syncs``,
...) under one lock, so that counts from several threads (a server's
engine thread beside the caller's) add up exactly; callers read and reset
the attributes directly.  The stream mesh's workers count in their own
processes and the mesh adds their deltas here (parallel/workers.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

_COUNT_LOCK = threading.Lock()


def count(fn, name: str, n: int = 1, **more: int) -> None:
    """``fn.<name> += n`` (and ``fn.<k> += v`` for each of ``more``) under
    the counters' lock."""
    with _COUNT_LOCK:
        setattr(fn, name, getattr(fn, name) + n)
        for k, v in more.items():
            setattr(fn, k, getattr(fn, k) + v)


class StageTimer:
    """Ring-buffer timer for one named stage."""

    def __init__(self, window: int = 30):
        self.samples = deque(maxlen=window)
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = (time.perf_counter() - self._t0) * 1e3
        self.samples.append(dt)
        self._t0 = None
        return dt

    @property
    def avg_ms(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def last_ms(self) -> float:
        return self.samples[-1] if self.samples else 0.0


class Stats:
    """Named stage registry (reference stats.js add/start/stop/update)."""

    def __init__(self, window: int = 30):
        self.window = window
        self.stages: Dict[str, StageTimer] = {}

    def add(self, name: str) -> None:
        self.stages.setdefault(name, StageTimer(self.window))

    def start(self, name: str) -> None:
        self.add(name)
        self.stages[name].start()

    def stop(self, name: str) -> float:
        return self.stages[name].stop()

    def timeit(self, name: str):
        """Context manager: ``with stats.timeit("slam"): ...``"""
        stats = self

        class _Ctx:
            def __enter__(self):
                stats.start(name)

            def __exit__(self, *a):
                stats.stop(name)

        return _Ctx()

    def summary(self) -> str:
        return " | ".join(f"{k}: {v.avg_ms:.2f} ms" for k, v in self.stages.items())
