"""Per-stage timing of the SLAM step (port of alvaar_tpu/utils/profiling.py).

Each phase of frontend/step.py is run on its own, back to back, on the
state's device: on the card timed by CUDA events around the calls (the
device's own clock, after a warm-up call), on the CPU by the host clock.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from alvaar_tpu_torch.frontend.step import (finalize_phase, keyframe_phase, preprocess,
                                            slam_step, track_phase)


def _bench(fn, device: torch.device, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls
    after one warm-up call."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_step(state, gray, cam, cfg, *, reps: int = 5) -> Dict[str, float]:
    """Stage-by-stage timing of one SLAM frame on the state's device.

    Returns {stage: milliseconds} for preprocess, track, keyframe_pipeline,
    finalize and full_step.  Every stage starts from the given state (the
    keyframe and finalize stages from the state after its track phase), so
    the keyframe stage should be given a state with keyframes to work with."""
    dev = state.kp_px.device
    gray = torch.as_tensor(gray).to(device=dev, dtype=torch.float32)
    tracked, _ = track_phase(state, gray, cam, cfg)
    no_kf = torch.zeros((), dtype=torch.bool, device=dev)
    stages = {
        "preprocess": lambda: preprocess(gray, cfg),
        "track": lambda: track_phase(state, gray, cam, cfg),
        "keyframe_pipeline": lambda: keyframe_phase(tracked, cam, cfg),
        "finalize": lambda: finalize_phase(tracked, no_kf, cfg),
        "full_step": lambda: slam_step(state, gray, cam, cfg),
    }
    return {name: _bench(fn, dev, reps) for name, fn in stages.items()}
