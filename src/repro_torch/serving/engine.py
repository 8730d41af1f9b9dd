"""Batched serving engine: prefill, decode loop, LOMS top-k sampling.

Counterpart of ``repro.serving.engine``: ``top_k`` / ``top_p`` are one
value for the batch or one per request (the ragged ``segment_topk``
path). Tokens stay on the device until the loop ends and are copied to
the host once: a copy per step would make the host wait for every step.
Per-step times are opt-in (``ServeConfig.time_steps``) because they need
a synchronise per step. Prefill and decode are timed by
:func:`repro_torch.obs.timing.time_once` and run under the ``serve.prefill``
/ ``serve.decode`` obs spans, which feed the ``serve.*`` metrics when
``REPRO_OBS`` is on. A vlm batch's ``patches`` go in front of the prompt:
the cache holds ``frontend_len`` more positions and decode starts after
them. The request scheduler is :mod:`repro_torch.serving.scheduler`.

With ``par`` (``generate(..., par=...)``, one process a rank, each with
the same batch and seed) the parameters and caches are sharded
(:mod:`repro_torch.models.model`), the logits of each step reach the
sampler as the full array on every rank, and ``par`` rides along to
``sample_topk``: every rank draws the same tokens from identically
seeded generators (``serving/engine.py:62-151`` of the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.timing import block_until_ready, time_once
from repro_torch.obs.trace import span
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


def _full(logits):
    """The logits of a step as the full array (a DTensor's gathered)."""
    from torch.distributed.tensor import DTensor

    return logits.full_tensor() if isinstance(logits, DTensor) else logits


def _sample(logits, top_k, temperature, top_p, generator, par):
    """The step's draw; ``par`` rides along to the sampler."""
    if temperature <= 0.0:
        return sample_greedy(logits)
    return sample_topk(logits, k=top_k, temperature=temperature, top_p=top_p,
                       generator=generator, par=par)


def make_serve_step(cfg: ModelConfig, top_k: Union[int, Sequence[int]] = 64,
                    temperature: float = 1.0,
                    top_p: Union[float, Sequence[float]] = 1.0, par=None):
    """(params, tokens (B,1), cache, positions, generator) -> (next (B,1), cache).
    With ``par`` the full tokens come back on every rank."""

    def serve_step(params, tokens, cache, positions, generator):
        logits, cache = decode_step(params, tokens, cache, cfg, positions=positions, par=par)
        nxt = _sample(_full(logits), top_k, temperature, top_p, generator, par)
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


def _param_device(params: dict) -> torch.device:
    """Where a parameter tree lives (every family has ``final_norm``)."""
    return params["final_norm"]["scale"].device


def generate(params: dict, batch: Dict[str, object], cfg: ModelConfig,
             sc: ServeConfig, device: DeviceLike = None, par=None) -> Dict[str, object]:
    """:func:`_generate` without autograd: ``torch.inference_mode`` on one
    device, ``torch.no_grad`` under ``par`` (DTensor's ``from_local`` /
    ``to_local`` take no inference tensors)."""
    with (torch.inference_mode() if par is None else torch.no_grad()):
        return _generate(params, batch, cfg, sc, device, par)


def _generate(params: dict, batch: Dict[str, object], cfg: ModelConfig,
              sc: ServeConfig, device: DeviceLike = None, par=None) -> Dict[str, object]:
    """Prefill the prompt batch, then decode ``max_new_tokens`` greedily or
    with top-k sampling. Returns the tokens (B, max_new_tokens) and times.

    ``batch["lengths"]`` (B,) marks right-padded ragged prompts: each row
    continues from its own last valid position (attention caches of token
    prompts only: ``prefill`` refuses the SSM, hybrid and frontend
    families). ``batch["patches"]`` (B, frontend_len, frontend_dim) are a
    vlm batch's image patches. An encoder-only config (audio) has no
    decode and raises. ``device`` must be where ``params`` live; it
    defaults to the card. ``par``: the module docstring."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode")
    dev = resolve_device(device)
    if _param_device(params).type != dev.type:
        raise ValueError(f"params live on {_param_device(params)}, not on {dev}")
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.int32).to(dev)
    bsz, prompt_len = tokens.shape
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = np.asarray(lengths, np.int32)
        if lengths.shape != (bsz,) or (lengths < 1).any() or (lengths > prompt_len).any():
            raise ValueError(f"lengths {lengths.tolist()} do not fit prompts "
                             f"of shape {tuple(tokens.shape)}")
        lengths = torch.as_tensor(lengths).to(dev)
    inputs = {"tokens": tokens}
    total = prompt_len + sc.max_new_tokens
    if cfg.family == "vlm":
        inputs["patches"] = torch.as_tensor(np.asarray(batch["patches"]),
                                            dtype=torch.float32).to(dev)
        total += cfg.frontend_len
        prompt_len += cfg.frontend_len
    if sc.cache_len is not None:
        if sc.cache_len < total:
            raise ValueError(f"cache_len {sc.cache_len} < prompt + new tokens {total}")
        total = sc.cache_len
    cache = block_until_ready(init_cache(cfg, bsz, total, dev, par=par))

    with span("serve.prefill", kind="run", batch=bsz, prompt_len=prompt_len):
        (logits, cache), t_prefill = time_once(prefill, params, inputs, cache, cfg,
                                               lengths=lengths, par=par)
    logits = _full(logits)

    step = make_serve_step(cfg, top_k=sc.top_k, temperature=sc.temperature,
                           top_p=sc.top_p, par=par)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    tok = _sample(logits, sc.top_k, sc.temperature, sc.top_p, gen, par)[:, None]
    toks = [tok]
    step_times = [] if sc.time_steps else None
    n_steps = sc.max_new_tokens - 1

    def decode():
        nonlocal tok, cache
        if step_times is not None:
            block_until_ready(tok)
        for i in range(n_steps):
            if lengths is None:
                positions = torch.full((bsz, 1), prompt_len + i, dtype=torch.int32,
                                       device=dev)
            else:
                positions = (lengths + i)[:, None]
            if step_times is not None:
                (tok, cache), dt = time_once(step, params, tok, cache, positions, gen)
                step_times.append(dt)
            else:
                tok, cache = step(params, tok, cache, positions, gen)
            toks.append(tok)
        return tok

    with span("serve.decode", kind="run", batch=bsz, steps=n_steps):
        _, t_decode = time_once(decode)
    out_tokens = torch.cat(toks, dim=1).cpu().numpy()
    tok_per_s = bsz * max(n_steps, 1) / max(t_decode, 1e-9)
    obs_metrics.counter("serve.requests").inc(bsz)
    obs_metrics.counter("serve.decode_steps").inc(max(n_steps, 0))
    obs_metrics.counter("serve.tokens").inc(int(out_tokens.size))
    obs_metrics.histogram("serve.tok_per_s").observe(tok_per_s)
    out: Dict[str, object] = {
        "tokens": out_tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": tok_per_s,
    }
    if step_times:
        out["step_times_s"] = np.asarray(step_times)
        out.update(_percentiles_us(step_times))
    return out
