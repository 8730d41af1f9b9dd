"""Decode-time sampling on the LOMS top-k kernels.

Counterpart of ``repro.serving.sample``. With one int ``k`` the
candidates come from :func:`repro_torch.topk` (the CUDA vocab kernels on
the card); with one ``k`` per request they come from one ragged
:func:`repro_torch.segment_topk` call over the batch's rows (the class
kernels, or the stable top-k for a vocabulary past the class width).
Then temperature, an optional nucleus inside the candidates, and one
categorical draw per row.

All randomness goes through one seam, :func:`categorical`:
``argmax(logits + gumbel)``, which is how ``jax.random.categorical``
draws. The noise comes from a ``torch.Generator``, or is handed in
(``gumbel=``), which lets a test feed both packages the same draws.

With ``par`` (a :class:`~repro_torch.parallel.Parallelism` whose TP axis
divides the vocab) the scoring runs the device-tree top-k over that axis
(``repro_torch.topk(..., par=par)``; a ragged ``k`` scores one uniform
``max(k)`` top-k instead of the segmented call). The token is
:func:`canonical_token` on every mesh, so a draw does not depend on the
mesh or on how the sharded top-k orders tied candidates. The reference
takes the drawn candidate's own index there instead (``sample.py:112``),
because its logits row is sharded over the vocab and the compare would
gather it; here every rank passes the full logits (and a generator
seeded alike), so the compare needs no communication and every rank
returns the same tokens.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api import segment_topk, sort, topk


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


def sample_topk(logits: torch.Tensor, *, k: Union[int, Sequence[int]] = 64,
                temperature: float = 1.0,
                top_p: Union[float, Sequence[float]] = 1.0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None, par=None) -> torch.Tensor:
    """Top-k + temperature categorical sampling: (B, V) -> (B,) int32.

    ``k`` may be one int per request: the scoring then runs as one ragged
    ``segment_topk`` over the rows (:func:`_sample_topk_ragged`), and
    ``top_p`` may then be one per request too. ``top_p < 1.0`` applies
    the nucleus inside the k candidates. ``gumbel`` (B, k) replaces the
    generator's noise (B, max k on the ragged path)."""
    if not isinstance(k, (int, np.integer)):
        ks = tuple(int(x) for x in k)
        tps = ((float(top_p),) * len(ks) if isinstance(top_p, (int, float))
               else tuple(float(x) for x in top_p))
        return _sample_topk_ragged(logits, ks, temperature, tps,
                                  generator=generator, gumbel=gumbel, par=par)
    if not isinstance(top_p, (int, float)):
        raise ValueError("per-request top_p needs per-request k")
    if temperature <= 0.0 or k == 1:
        return sample_greedy(logits)
    vals, _ = topk(logits, k, par=par)
    choice = scored_draw(vals, temperature, top_p if top_p < 1.0 else None,
                         generator=generator, gumbel=gumbel)
    return canonical_token(logits, vals, choice)


def _sample_topk_ragged(logits: torch.Tensor, ks: Sequence[int],
                       temperature: float, top_ps: Optional[Sequence[float]] = None,
                       *, generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None, par=None) -> torch.Tensor:
    """Mixed-k batch (the reference's ``_sample_topk_ragged``, ``sample.py:123``): each
    row's top-``k_r`` through one ``segment_topk`` call, laid out dense as
    (B, max k) with the lanes past a row's own k at -inf, then one
    categorical draw per row over its own prefix. With ``par``: one
    uniform ``max(k)`` top-k through ``topk(..., par=par)`` (the top-k_r of
    a row is the k_r prefix of its top-max(k))."""
    b, v = logits.shape
    ks = tuple(int(x) for x in ks)
    if len(ks) != b or not all(1 <= x <= v for x in ks):
        raise ValueError(f"ks {ks} do not fit logits of shape {tuple(logits.shape)}")
    top_ps = (1.0,) * b if top_ps is None else tuple(float(x) for x in top_ps)
    if len(top_ps) != b or not all(0.0 < x <= 1.0 for x in top_ps):
        raise ValueError(f"top_ps {top_ps} must be one per row in (0, 1]")
    if temperature <= 0.0 or all(x == 1 for x in ks):
        return sample_greedy(logits)
    k_max = max(ks)
    if par is not None:
        dense_v, _ = topk(logits, k_max, par=par)
        cnts = torch.as_tensor(ks, device=logits.device)[:, None]
    else:
        vals, _, out_offs = segment_topk(logits.reshape(-1), tuple(range(0, (b + 1) * v, v)),
                                         ks)
        # CSR -> dense (B, k_max): pad lanes read one appended slot
        gmap = np.full((b, k_max), out_offs[-1], np.int64)
        for r in range(b):
            gmap[r, :out_offs[r + 1] - out_offs[r]] = out_offs[r] + np.arange(
                out_offs[r + 1] - out_offs[r])
        vals_ext = torch.cat([vals, vals.new_zeros((1,))])
        dense_v = vals_ext[torch.as_tensor(gmap, device=logits.device)]
        cnts = torch.as_tensor(np.diff(np.asarray(out_offs)), device=logits.device)[:, None]
    lane = torch.arange(k_max, device=logits.device)[None, :]
    probs_logits = torch.where(lane < cnts, dense_v.float() / temperature,
                               float("-inf"))
    if any(p < 1.0 for p in top_ps):
        probs_logits = nucleus_mask(probs_logits, torch.tensor(
            top_ps, dtype=torch.float32, device=logits.device)[:, None])
    choice = categorical(probs_logits, generator=generator, gumbel=gumbel)
    return canonical_token(logits, dense_v, choice)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topp(logits: torch.Tensor, *, p: float = 0.9,
                k_max: Optional[int] = 256, temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None, par=None) -> torch.Tensor:
    """Nucleus sampling on the top-``k_max`` prefix (the kernels hand the
    candidates back descending, so the nucleus is one cumulative sum).
    ``k_max=None``: the exact nucleus, the whole row ranked by
    ``sort(descending=True)`` with the token ids riding the permutation,
    routed by ``plan`` (at a vocab of 151,936: the schedule executor; with
    ``par`` whose TP axis divides the vocab: the distributed sample-sort,
    and the top-``k_max`` the device tree)."""
    if k_max is None:
        iota = torch.arange(logits.shape[-1], dtype=torch.int32,
                            device=logits.device).expand(logits.shape)
        vals, idx = sort(logits, descending=True, payload=iota, par=par)
    else:
        vals, idx = topk(logits, k_max, par=par)
    probs = torch.softmax(vals.float() / temperature, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < p], dim=-1)
    masked = torch.log(probs + 1e-30).masked_fill(~keep, float("-inf"))
    choice = categorical(masked, generator=generator, gumbel=gumbel)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
