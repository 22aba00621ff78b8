"""Hypothesize-all-at-once robust estimation (port of
alvaar_tpu/solvers/ransac.py).

All hypotheses are drawn at once, solved as one batch and scored as one
[C, N] pass.  Randomness comes from an explicit ``torch.Generator`` (the
map state's), not a JAX key: the draws differ from the JAX package's, so
the parity tests hand both sides the same sample indices.
"""

from __future__ import annotations

import torch

from alvaar_tpu_torch.ops.index import take_row


def uniform_draw(gen: torch.Generator, num_hyp: int, n: int, device):
    """The uniform draw [num_hyp, n] behind ``num_hyp`` minimal samples
    from a pool of ``n``: what ``sample_minimal`` takes from ``gen``."""
    return torch.rand((num_hyp, n), generator=gen, device=device)


def gumbel_top_k(u, valid, k: int):
    """Minimal samples of ``k`` distinct valid indices from a uniform draw
    ``u`` [num_hyp, n] by the Gumbel-top-k trick (no generator, so it
    runs under ``vmap``).  Returns idx [num_hyp, k] int64 and ok
    [num_hyp] (enough valid slots)."""
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u))
    scores = torch.where(valid[None, :], g, -torch.inf)
    idx = torch.topk(scores, k, dim=-1).indices
    ok = torch.sum(valid) >= k
    return idx, ok.expand(u.shape[0])


def sample_minimal(gen: torch.Generator, valid, k: int, num_hyp: int):
    """``num_hyp`` minimal samples of ``k`` distinct valid indices, drawn
    from ``gen``.  Returns idx [num_hyp, k] int64 and ok [num_hyp]."""
    return gumbel_top_k(uniform_draw(gen, num_hyp, valid.shape[0], valid.device), valid, k)


def minimal_samples(gen, valid, k: int, num_hyp: int, samples=None):
    """A solver's hypotheses: ``samples`` as given, either (idx, ok) or a
    uniform draw [num_hyp, n] (scored here against ``valid``), else a
    fresh draw from ``gen``."""
    if samples is None:
        return sample_minimal(gen, valid, k, num_hyp)
    if isinstance(samples, torch.Tensor):
        return gumbel_top_k(samples, valid, k)
    return samples


def masked_quantile(errs, valid, q: float):
    """Quantile of ``errs`` [..., N] over valid entries (invalid sort to
    +inf; the index comes from the valid count)."""
    masked = torch.where(valid, errs, torch.inf)
    srt = torch.sort(masked, dim=-1).values
    count = torch.sum(valid, dim=-1).to(torch.int32)
    pos = torch.clamp((count.to(torch.float32) * q).to(torch.int64),
                      0, errs.shape[-1] - 1)
    pos = pos.expand(srt.shape[:-1])
    return torch.gather(srt, -1, pos[..., None])[..., 0]


def select_best_by_median(medians, cand_valid):
    """argmin of LMedS scores with a validity mask."""
    m = torch.where(cand_valid, medians, torch.inf)
    i = torch.argmin(m)
    return i, take_row(m, i)
