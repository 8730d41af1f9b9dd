"""Block assembly and the dense layer stack.

Counterpart of ``repro.models.transformer`` for the dense family: the
reference scans stacked layer parameters; the port keeps one parameter
dict per layer and runs the layers in a Python loop. MoE, SSM and hybrid
stacks wait for later slices.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from .attention import attn_apply, attn_cache_init, attn_init
from .layers import mlp, mlp_init, rmsnorm


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port's model stack runs dense GQA models only")


def block_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    ones = lambda: {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}  # noqa: E731
    return {
        "ln1": ones(),
        "attn": attn_init(generator, cfg, dtype, device),
        "ln2": ones(),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device),
    }


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict] = None, positions=None):
    """Pre-norm residual block (``transformer.py:55``)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, cache = attn_apply(p["attn"], h, cfg, cache=cache, mode=mode,
                          positions=positions)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.mlp_act), cache


def stack_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    check_dense(cfg)
    return {"body": [block_init(generator, cfg, dtype, device)
                     for _ in range(cfg.n_layers)]}


def stack_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", caches: Optional[dict] = None,
                positions=None):
    """Run every layer (``stack_apply``, ``transformer.py:131``);
    ``caches`` mirrors the parameters: ``{"body": [cache per layer]}``."""
    new: List[Optional[dict]] = []
    for i, lp in enumerate(p["body"]):
        c = caches["body"][i] if caches is not None else None
        x, c = block_apply(lp, x, cfg, mode=mode, cache=c, positions=positions)
        new.append(c)
    return x, ({"body": new} if caches is not None else None)


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> dict:
    check_dense(cfg)
    return {"body": [attn_cache_init(cfg, batch, max_len, dtype, device)
                     for _ in range(cfg.n_layers)]}
