"""Block assembly and the layer stack of the dense and MoE families.

Counterpart of ``repro.models.transformer``: the reference scans stacked
layer parameters; the port keeps one parameter dict per layer and runs
the layers in a Python loop. The unscanned leading dense blocks of a MoE
stack (``first_dense_layers``) are its ``head``, as in the reference.
A config with ``mla`` runs MLA in every block, the head's included
(DeepSeek-V2-Lite). SSM, hybrid and the frontends wait for later slices.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from .attention import (attn_apply, attn_cache_init, attn_init, mla_apply, mla_cache_init,
                        mla_init)
from .layers import mlp, mlp_init, rmsnorm
from .moe import moe_apply, moe_init


def check_family(cfg: ModelConfig) -> None:
    """The stacks the port runs: dense and MoE families on GQA or MLA
    attention. The others raise with the ROADMAP item that brings them."""
    if cfg.family in ("ssm", "hybrid") or cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} stack is not ported yet (ROADMAP Queue 1, "
            "item 7: SSM with mamba2-780m, then hybrid with zamba2-2.7b)")
    if cfg.family in ("vlm", "audio") or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} frontend is not ported yet (ROADMAP Queue 1, "
            "item 7: the vlm and audio frontends)")
    if cfg.family not in ("dense", "moe") or (cfg.family == "moe") != (cfg.moe is not None):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with moe={cfg.moe}")


def _layer_ffn_kind(cfg: ModelConfig, layer: int) -> str:
    """``transformer.py:92``: MoE from ``first_dense_layers`` on."""
    if cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
        return "moe"
    return "dense"


def block_init(generator, cfg: ModelConfig, dtype, device, *, ffn: str = "dense") -> dict:
    ones = lambda: {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}  # noqa: E731
    attn = mla_init if cfg.mla is not None else attn_init  # transformer.py:43
    p = {"ln1": ones(), "attn": attn(generator, cfg, dtype, device), "ln2": ones()}
    if ffn == "moe":
        p["ffn"] = moe_init(generator, cfg, dtype, device)
    else:
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device)
    return p


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict] = None, positions=None, ffn: str = "dense",
                rows: Optional[int] = None):
    """Pre-norm residual block (``transformer.py:55``); ``rows``: the real
    rows of a padded decode batch (the MoE capacity counts those)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn = mla_apply if cfg.mla is not None else attn_apply
    a, cache = attn(p["attn"], h, cfg, cache=cache, mode=mode, positions=positions)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if ffn == "moe":
        return x + moe_apply(p["ffn"], h, cfg, rows=rows), cache
    return x + mlp(p["ffn"], h, cfg.mlp_act), cache


def _n_head(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def stack_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    """``{"head": [dense block ...]}`` (MoE stacks with leading dense
    layers only) and ``{"body": [block per layer]}``."""
    check_family(cfg)
    n_head = _n_head(cfg)
    p = {}
    if n_head:
        p["head"] = [block_init(generator, cfg, dtype, device) for _ in range(n_head)]
    p["body"] = [block_init(generator, cfg, dtype, device, ffn=_layer_ffn_kind(cfg, i))
                 for i in range(n_head, cfg.n_layers)]
    return p


def stack_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", caches: Optional[dict] = None,
                positions=None, rows: Optional[int] = None):
    """Run every layer (``stack_apply``, ``transformer.py:131``): the head
    blocks, then the body; ``caches`` mirrors the parameters."""
    out = {}
    head = p.get("head", [])
    ffn_kind = _layer_ffn_kind(cfg, len(head))
    for part, kind in (("head", "dense"), ("body", ffn_kind)):
        if part not in p:
            continue
        new: List[Optional[dict]] = []
        for i, lp in enumerate(p[part]):
            c = caches[part][i] if caches is not None else None
            x, c = block_apply(lp, x, cfg, mode=mode, cache=c, positions=positions,
                               ffn=kind, rows=rows)
            new.append(c)
        out[part] = new
    return x, (out if caches is not None else None)


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> dict:
    check_family(cfg)
    n_head = _n_head(cfg)
    cache_init = mla_cache_init if cfg.mla is not None else attn_cache_init
    out = {}
    if n_head:
        out["head"] = [cache_init(cfg, batch, max_len, dtype, device) for _ in range(n_head)]
    out["body"] = [cache_init(cfg, batch, max_len, dtype, device)
                   for _ in range(cfg.n_layers - n_head)]
    return out
