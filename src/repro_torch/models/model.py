"""LM wrapper: init / forward / loss / prefill / decode for the dense and
MoE families, on GQA or MLA attention (each layer's cache a dict with its
``pos``: ``k`` / ``v``, or MLA's ``ckv`` / ``kpe``), the SSM family
(each layer's cache ``conv``, the last ``d_conv - 1`` pre-convolution
rows, and ``ssm``, the float32 state; no ``pos``), the hybrid (SSM
caches in ``body``, one KV cache a group of ``attn_every`` layers in
``shared``) and the two frontends.

Batch dicts by family (the reference's):
  LM (dense/moe/ssm/hybrid): {"tokens": (B, S) int32, "targets": (B, S)}
  vlm:   + {"patches": (B, frontend_len, frontend_dim)}: projected by
         ``patch_proj`` and put in front of the text
  audio: {"frames": (B, S, frontend_dim), "targets": (B, S)}: projected
         by ``frontend`` in place of the embedding; an encoder
         (``causal=False``) with no cache and no decode step

Counterpart of ``repro.models.model``. Parameters are a nested dict with
the reference's names and layouts; the layer stack is a list of per-layer
dicts (``params["stack"]["body"][i]``, and ``["head"][i]`` for the leading
dense blocks of a MoE stack) where the reference stacks them on a leading
layer axis.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .layers import dense, dense_init, embed, rmsnorm
from .transformer import stack_apply, stack_cache_init, stack_init


#: decode pads its batch to a multiple of this many rows (see decode_step)
DECODE_TILE = 8


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def model_init(generator: Optional[torch.Generator], cfg: ModelConfig,
               device: DeviceLike = None) -> dict:
    """Random weights with the distributions of ``repro.models.model_init``:
    embedding normal x 0.02, dense weights normal x 1/sqrt(fan_in), norms
    ones. Each tensor is drawn in float32 and stored in ``cfg.dtype`` one
    at a time, so the full-width model never holds a float32 copy of all
    its weights. ``generator`` (on ``device``) makes the draw
    reproducible; ``None`` seeds one with 0. The audio family has a
    ``frontend`` dense (``frontend_dim`` -> ``d_model``) in place of the
    embedding; the vlm family adds ``patch_proj`` (``model.py:22``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = _dtype(cfg)
    if cfg.family == "audio":
        p = {"frontend": dense_init(generator, cfg.frontend_dim, cfg.d_model, dt, dev)}
    else:
        emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                          device=dev, dtype=torch.float32)
        p = {"embed": {"emb": emb.mul_(0.02).to(dt)}}
        del emb
        if cfg.family == "vlm":
            p["patch_proj"] = dense_init(generator, cfg.frontend_dim, cfg.d_model, dt, dev)
    p["stack"] = stack_init(generator, cfg, dt, dev)
    p["final_norm"] = {"scale": torch.ones(cfg.d_model, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt, dev)
    return p


def _logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, p["embed"]["emb"].to(x.dtype).t())
    return dense(p["lm_head"], x)


def _input(x, like: torch.Tensor) -> torch.Tensor:
    """A batch entry (tensor or array) on ``like``'s device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(like.device)


def _embed_inputs(p: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The stack's input (``model.py:45``): audio frames through
    ``frontend``; tokens through the embedding, behind the vlm patches
    projected by ``patch_proj``. Frames and patches are cast to
    ``cfg.dtype`` before their product, as the reference casts them."""
    dt = _dtype(cfg)
    if cfg.family == "audio":
        w = p["frontend"]["w"]
        return dense(p["frontend"], _input(batch["frames"], w).to(dt))
    x = embed(p["embed"], batch["tokens"], dt)
    if cfg.family == "vlm" and "patches" in batch:
        w = p["patch_proj"]["w"]
        px = dense(p["patch_proj"], _input(batch["patches"], w).to(dt))
        x = torch.cat([px, x], dim=1)  # the patches prefix the text
    return x


def forward(p: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S_out, V); the vlm family
    drops its ``frontend_len`` patch positions (``model.py:77``). Forward
    only: no autograd checkpointing (``remat``) and no ``par`` yet
    (ROADMAP Queue 1, items 9 and 10)."""
    x = _embed_inputs(p, batch, cfg)
    x, _ = stack_apply(p["stack"], x, cfg, mode="train")
    if cfg.family == "vlm":
        x = x[:, cfg.frontend_len:]  # logits over the text positions only
    return _logits(p, x, cfg)


def loss_fn(p: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token (LM) or per-frame (encoder) cross entropy in
    float32 (``model.py:87``): log-sum-exp minus the target's logit,
    averaged over ``batch["mask"]`` where one is given."""
    logits = forward(p, batch, cfg).float()
    targets = _input(batch["targets"], logits).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        mask = _input(mask, logits).float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> dict:
    """The decode caches; an encoder-only config has none (``model.py:100``)."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step, no cache")
    dev = resolve_device(device)
    dt = getattr(torch, cfg.cache_dtype) if cfg.cache_dtype else _dtype(cfg)
    return stack_cache_init(cfg, batch, max_len, dt, dev)


def prefill(p: dict, batch: dict, cache: dict, cfg: ModelConfig, *,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt through the stack, filling the cache
    (``model.py:137``). Returns (last-position logits (B, V), cache).
    With ``lengths`` (B,) the prompts are right-padded: logits come from
    each row's position ``lengths - 1`` (causal attention keeps the valid
    positions exact) and every layer's ``pos`` becomes ``lengths``. The
    SSM and hybrid families refuse ``lengths``: a pad token would enter
    the recurrent state (as ``repro.serving.engine.generate`` refuses
    them); so do the frontends, whose prompts are not tokens only
    (``model.py:150``). A vlm batch's ``patches`` fill the first
    ``frontend_len`` positions of the cache."""
    if lengths is not None and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: ragged prompts need attention caches, not the "
                         f"{cfg.family} family's recurrent state")
    if lengths is not None and cfg.family in ("vlm", "audio"):
        raise ValueError(f"{cfg.name}: ragged prefill covers token-only prompts, not the "
                         f"{cfg.family} family's")
    x = _embed_inputs(p, batch, cfg)
    x, cache = stack_apply(p["stack"], x, cfg, mode="prefill", caches=cache)
    if lengths is None:
        return _logits(p, x[:, -1:], cfg)[:, 0], cache
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, (lengths - 1).long()][:, None]
    for lc in cache.get("head", []) + cache["body"]:
        lc["pos"] = lengths.clone()
    return _logits(p, last, cfg)[:, 0], cache


def decode_step(p: dict, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
                *, positions: Optional[torch.Tensor] = None):
    """One decode step (``model.py:157``). tokens (B, 1) -> (logits (B, V),
    cache); ``positions`` (B, 1) are the RoPE positions of the tokens.

    The rows run padded to a multiple of :data:`DECODE_TILE` (pad rows
    take token 0 at position 0, have no cache and are dropped): every
    weight product then has the same shape for one row as for a full
    tile, so a row's logits do not depend on how many rows share the
    step. Decode attention is one batched call over the cache's rows;
    its result for a row does not depend on the batch either, and neither
    does an SSM layer's recurrence, which runs on the cache's rows. It
    embeds tokens only, as the reference's does (``model.py:157``)."""
    b = tokens.shape[0]
    pad = -b % DECODE_TILE
    if positions is None:  # as attn_apply's default: position 0
        positions = torch.zeros((b, 1), dtype=torch.int32, device=tokens.device)
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, 1))])
        positions = torch.cat([positions, positions.new_zeros((pad, 1))])
    x = embed(p["embed"], tokens, _dtype(cfg))
    x, cache = stack_apply(p["stack"], x, cfg, mode="decode", caches=cache,
                           positions=positions, rows=b)
    return _logits(p, x, cfg)[:b, 0], cache
