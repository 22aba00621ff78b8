"""The port's ``entry()`` (alvaar_tpu_torch/entry.py) against the JAX
package's (``__graft_entry__.entry``): one call of each ``fn`` on its own
example arguments, which hold the same frame, gives the same
``StepOutput`` (the first frame: status 3, the identity pose, the same
keypoints tracked).  The JAX side runs op by op on the CPU
(``jax.disable_jit``, as tests/test_torch_solvers.py runs P3P): jitted,
the whole 640x480 step takes minutes to compile on a CPU host, and even
without ``jit`` its ``lax.cond`` branches compile (~70 s against ~40 s)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from alvaar_tpu_torch.entry import entry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    jfn, (jstate, jframe) = __graft_entry__.entry()
    with jax.disable_jit():
        jout = jfn(jstate, jframe)
    fn, (state, frame) = entry(device="cpu")
    return (jout, jframe), (fn(state, frame), frame)


def test_example_frame_is_the_jax_frame(both):
    (_, jframe), (_, frame) = both
    assert frame.dtype == torch.float32 and tuple(frame.shape) == (480, 640)
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))


def test_first_step_matches_jax(both):
    ((_, jout), _), ((state, out), _) = both
    assert int(out.status) == int(jout.status) == 3
    assert bool(out.is_keyframe) == bool(jout.is_keyframe)
    np.testing.assert_array_equal(out.pose_wc.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(jout.pose_wc), np.eye(4, dtype=np.float32))
    assert int(out.num_tracked) == int(jout.num_tracked)
    assert int(out.num_3d) == int(jout.num_3d) == 0
    assert int(state.frame_id) == 1 and int(state.next_kf_id) == 1


def test_entry_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
