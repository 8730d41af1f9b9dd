"""Decode-time sampling on the LOMS top-k kernels.

Counterpart of ``repro.serving.sample`` for one int ``k`` per batch: the
candidates come from :func:`repro_torch.topk` (the CUDA vocab kernels on
the card), then temperature, an optional nucleus inside the candidates,
and one categorical draw per row.

All randomness goes through one seam, :func:`categorical`:
``argmax(logits + gumbel)``, which is how ``jax.random.categorical``
draws. The noise comes from a ``torch.Generator``, or is handed in
(``gumbel=``), which lets a test feed both packages the same draws.

The ragged per-request-k path (segmented kernels) and ``k_max=None`` in
:func:`sample_topp` (the sort kernel) wait for later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api import topk


def gumbel_noise(shape, *, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise in float32: ``-log(-log(u))``, u uniform in
    [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One categorical draw per row over the last axis: the index of the
    largest ``logits + gumbel`` (the first one on a tie)."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator=generator,
                              device=logits.device)
    return torch.argmax(gumbel.to(logits.device) + logits, dim=-1)


def nucleus_mask(probs_logits: torch.Tensor, p) -> torch.Tensor:
    """Mask a descending candidate row (..., k) of scaled logits to the
    smallest prefix with probability mass >= p (top-1 always kept)."""
    probs = torch.softmax(probs_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < p], dim=-1)
    return probs_logits.masked_fill(~keep, float("-inf"))


def scored_draw(vals: torch.Tensor, temperature, top_p=None, *,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Categorical draw over descending candidate values (..., k):
    temperature scale, optional nucleus truncation, one draw per row."""
    probs_logits = vals.float() / temperature
    if top_p is not None:
        probs_logits = nucleus_mask(probs_logits, top_p)
    return categorical(probs_logits, generator=generator, gumbel=gumbel)


def canonical_token(logits: torch.Tensor, vals: torch.Tensor,
                    choice: torch.Tensor) -> torch.Tensor:
    """Map a drawn candidate back to a vocab id: the lowest id whose logit
    equals the drawn value, so the token does not depend on how a top-k
    backend orders equal values."""
    chosen = torch.gather(vals, -1, choice[..., None])
    return torch.argmax((logits == chosen).to(torch.int8), dim=-1).to(torch.int32)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topk(logits: torch.Tensor, *, k: int = 64, temperature: float = 1.0,
                top_p: float = 1.0, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k + temperature categorical sampling: (B, V) -> (B,) int32.

    ``top_p < 1.0`` applies the nucleus inside the k candidates.
    ``gumbel`` (B, k) replaces the generator's noise."""
    if not isinstance(k, int):
        raise NotImplementedError("per-request k (the segmented top-k) is not ported yet")
    if temperature <= 0.0 or k == 1:
        return sample_greedy(logits)
    vals, _ = topk(logits, k)
    choice = scored_draw(vals, temperature, top_p if top_p < 1.0 else None,
                         generator=generator, gumbel=gumbel)
    return canonical_token(logits, vals, choice)


def sample_topp(logits: torch.Tensor, *, p: float = 0.9,
                k_max: Optional[int] = 256, temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nucleus sampling on the top-``k_max`` prefix (the kernels hand the
    candidates back descending, so the nucleus is one cumulative sum)."""
    if k_max is None:
        raise NotImplementedError("k_max=None (the full sort kernel) is not ported yet")
    vals, idx = topk(logits, k_max)
    probs = torch.softmax(vals.float() / temperature, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < p], dim=-1)
    masked = torch.log(probs + 1e-30).masked_fill(~keep, float("-inf"))
    choice = categorical(masked, generator=generator, gumbel=gumbel)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
