"""Batched serving engine: prefill, decode loop, LOMS top-k sampling.

Counterpart of ``repro.serving.engine``: ``top_k`` / ``top_p`` are one
value for the batch or one per request (the ragged ``segment_topk``
path). Tokens stay on the device until the loop ends and are copied to
the host once: a copy per step would make the host wait for every step.
Per-step times are opt-in (``ServeConfig.time_steps``) because they need
a synchronise per step. The request scheduler is
:mod:`repro_torch.serving.scheduler`; the obs spans and metrics wait for
a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from .sample import sample_greedy, sample_topk


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 16
    #: one int, or one per request (the ragged segment_topk path)
    top_k: Union[int, Sequence[int]] = 64
    #: nucleus truncation within the top-k candidates; one float, or one
    #: per request (which needs a per-request top_k too)
    top_p: Union[float, Sequence[float]] = 1.0
    temperature: float = 1.0
    #: seeds the sampling generator
    seed: int = 0
    #: KV-cache capacity override (>= prompt_len + max_new_tokens); the
    #: scheduler's oracle sets it to the slot capacity
    cache_len: Optional[int] = None
    #: synchronise after every decode step and report per-step times
    time_steps: bool = False


def make_serve_step(cfg: ModelConfig, top_k: Union[int, Sequence[int]] = 64,
                    temperature: float = 1.0,
                    top_p: Union[float, Sequence[float]] = 1.0):
    """(params, tokens (B,1), cache, positions, generator) -> (next (B,1), cache)."""

    def serve_step(params, tokens, cache, positions, generator):
        logits, cache = decode_step(params, tokens, cache, cfg, positions=positions)
        if temperature <= 0.0:
            nxt = sample_greedy(logits)
        else:
            nxt = sample_topk(logits, k=top_k, temperature=temperature,
                              top_p=top_p, generator=generator)
        return nxt[:, None], cache

    return serve_step


def _percentiles_us(times_s) -> Dict[str, float]:
    """Steady-state decode-step percentiles. The first step (which pays
    one-time set-up such as loading the kernels) is reported on its own
    and left out whenever a later step exists."""
    us = np.asarray(times_s, np.float64) * 1e6
    steady = us[1:] if us.size > 1 else us
    return {
        "decode_step_first_us": float(us[0]),
        "decode_step_p50_us": float(np.percentile(steady, 50)),
        "decode_step_p95_us": float(np.percentile(steady, 95)),
        "decode_step_p99_us": float(np.percentile(steady, 99)),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def generate(params: dict, batch: Dict[str, object], cfg: ModelConfig,
             sc: ServeConfig, device: DeviceLike = None) -> Dict[str, object]:
    """Prefill the prompt batch, then decode ``max_new_tokens`` greedily or
    with top-k sampling. Returns the tokens (B, max_new_tokens) and times.

    ``batch["lengths"]`` (B,) marks right-padded ragged prompts: each row
    continues from its own last valid position (attention caches only:
    ``prefill`` refuses the SSM and hybrid families). ``device`` must be where
    ``params`` live; it defaults to the card."""
    dev = resolve_device(device)
    if params["embed"]["emb"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed']['emb'].device}, "
                         f"not on {dev}")
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.int32).to(dev)
    bsz, prompt_len = tokens.shape
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = np.asarray(lengths, np.int32)
        if lengths.shape != (bsz,) or (lengths < 1).any() or (lengths > prompt_len).any():
            raise ValueError(f"lengths {lengths.tolist()} do not fit prompts "
                             f"of shape {tuple(tokens.shape)}")
        lengths = torch.as_tensor(lengths).to(dev)
    total = prompt_len + sc.max_new_tokens
    if sc.cache_len is not None:
        if sc.cache_len < total:
            raise ValueError(f"cache_len {sc.cache_len} < prompt + new tokens {total}")
        total = sc.cache_len
    cache = init_cache(cfg, bsz, total, dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache, cfg, lengths=lengths)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    step = make_serve_step(cfg, top_k=sc.top_k, temperature=sc.temperature,
                           top_p=sc.top_p)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    if sc.temperature <= 0.0:
        tok = sample_greedy(logits)[:, None]
    else:
        tok = sample_topk(logits, k=sc.top_k, temperature=sc.temperature,
                          top_p=sc.top_p, generator=gen)[:, None]
    toks = [tok]
    step_times = [] if sc.time_steps else None
    n_steps = sc.max_new_tokens - 1
    t1 = time.perf_counter()
    for i in range(n_steps):
        if lengths is None:
            positions = torch.full((bsz, 1), prompt_len + i, dtype=torch.int32,
                                   device=dev)
        else:
            positions = (lengths + i)[:, None]
        if step_times is not None:
            _sync(dev)
            ts = time.perf_counter()
            tok, cache = step(params, tok, cache, positions, gen)
            _sync(dev)
            step_times.append(time.perf_counter() - ts)
        else:
            tok, cache = step(params, tok, cache, positions, gen)
        toks.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    out_tokens = torch.cat(toks, dim=1).cpu().numpy()
    out: Dict[str, object] = {
        "tokens": out_tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": bsz * max(n_steps, 1) / max(t_decode, 1e-9),
    }
    if step_times:
        out["step_times_s"] = np.asarray(step_times)
        out.update(_percentiles_us(step_times))
    return out
