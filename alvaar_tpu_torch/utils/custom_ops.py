"""What the port's kernel-backed custom ops share (solvers/ba.py,
solvers/pnp.py, ops/hamming.py, ops/detect.py, ops/orb.py): the device
dispatch of their wrappers, the current stream's handle their launchers
pass on, and the batching rule that turns a ``torch.func.vmap`` of an op
into one launch over all the rows."""

from __future__ import annotations

import torch


def dispatch(x, name: str) -> bool:
    """True to launch the kernel (CUDA tensors), False for the plain
    version (CPU tensors); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")


def raw_stream(dev) -> int:
    """The handle of ``dev``'s current stream, for a launcher's C entry (on
    CUDA without building torch's Stream object)."""
    if dev.type == "cuda" and hasattr(torch._C, "_cuda_getCurrentRawStream"):
        return torch._C._cuda_getCurrentRawStream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def one(x):
    """``x`` as a contiguous stack of one row."""
    return x.contiguous().unsqueeze(0)


def wrapped(x) -> bool:
    """True for a tensor that a ``torch.func`` transform wraps (a batched
    tensor under vmap)."""
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(x)


def rows_rule(op, impl=None):
    """The batching rule of a custom op whose tensors all lead with S rows:
    the vmapped dimension moved to the front and merged with S, one call
    over all the rows, the result split back.  An argument that is not
    batched is repeated for every row.  ``impl``, where given, takes the
    op's place once no transform wraps the merged rows (an implementation
    whose outputs share one buffer, which the op itself may not return).
    An op of one output tensor gives one batched tensor back."""
    def rule(info, in_dims, *args):
        b = info.batch_size
        flat = []
        for a, d in zip(args, in_dims):
            if isinstance(a, torch.Tensor):
                a = a.expand(b, *a.shape) if d is None else a.movedim(d, 0)
                a = a.reshape((-1,) + tuple(a.shape[2:])).contiguous()
            flat.append(a)
        outs = op(*flat) if impl is None or any(map(wrapped, flat)) else impl(*flat)
        if isinstance(outs, torch.Tensor):
            return outs.reshape((b, -1) + tuple(outs.shape[1:])), 0
        return tuple(o.reshape((b, -1) + tuple(o.shape[1:])) for o in outs), (0,) * len(outs)
    return rule
