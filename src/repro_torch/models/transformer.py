"""Block assembly and the layer stacks of the dense, MoE, SSM and hybrid
families.

Counterpart of ``repro.models.transformer``: the reference scans stacked
layer parameters; the port keeps one parameter dict per layer and runs
the layers in a Python loop. The unscanned leading dense blocks of a MoE
stack (``first_dense_layers``) are its ``head``, as in the reference.
A config with ``mla`` runs MLA in every block, the head's included
(DeepSeek-V2-Lite). An SSM block is a norm, the Mamba2 mixer and the
residual add (mamba2-780m). The hybrid stack (zamba2-2.7b) runs its
``n_layers`` SSM blocks in groups of ``attn_every``, each group followed
by one shared attention + MLP block whose weights every group reuses and
whose KV cache is the group's own. The frontends' stacks are dense: vlm
(internvl2-26b) a GQA stack behind its patch prefix, audio (hubert-xlarge)
a non-causal encoder with a gelu MLP; their input projections live in
``models.model``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from .attention import (attn_apply, attn_cache_init, attn_init, mla_apply, mla_cache_init,
                        mla_init)
from .layers import mlp, mlp_init, rmsnorm
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_cache_init, ssm_init


#: the frontend each frontend family takes
_FRONTENDS = {"vlm": "patch", "audio": "frame"}


def check_family(cfg: ModelConfig) -> None:
    """The stacks the port runs: dense and MoE families on GQA or MLA
    attention, the SSM family, the hybrid, and the frontends' dense stacks
    (vlm: patches in front of the text; audio: frames, an encoder)."""
    if cfg.frontend != _FRONTENDS.get(cfg.family, "none"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with frontend {cfg.frontend!r}")
    if cfg.family in _FRONTENDS:
        if cfg.moe is not None or cfg.ssm is not None or cfg.mla is not None \
                or cfg.frontend_dim < 1:
            raise ValueError(f"{cfg.name}: the {cfg.family} stack is dense GQA with a "
                             f"frontend, got moe={cfg.moe}, ssm={cfg.ssm}, mla={cfg.mla}, "
                             f"frontend_dim={cfg.frontend_dim}")
        return
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm is None or cfg.moe is not None:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} with ssm={cfg.ssm}, "
                             f"moe={cfg.moe}")
        if cfg.family == "hybrid" and (cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups "
                             f"of attn_every = {cfg.attn_every}")
        return
    if cfg.family not in ("dense", "moe") or (cfg.family == "moe") != (cfg.moe is not None) \
            or cfg.ssm is not None:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with moe={cfg.moe}, ssm={cfg.ssm}")


def _layer_ffn_kind(cfg: ModelConfig, layer: int) -> str:
    """``transformer.py:92``: SSM blocks in the ssm family (and in the
    hybrid's body), MoE from ``first_dense_layers`` on."""
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    if cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
        return "moe"
    return "dense"


def block_init(generator, cfg: ModelConfig, dtype, device, *, ffn: str = "dense") -> dict:
    """An attention block (``ffn`` dense or moe) or an SSM block (``ffn``
    ssm: ``norm`` and ``mixer``, ``transformer.py:38``)."""
    ones = lambda: {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}  # noqa: E731
    if ffn == "ssm":
        return {"norm": ones(), "mixer": ssm_init(generator, cfg, dtype, device)}
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
    rows of a padded decode batch (the MoE capacity counts those). An SSM
    block's decode takes its real rows from its cache."""
    if ffn == "ssm":
        y, cache = ssm_apply(p["mixer"], rmsnorm(p["norm"], x, cfg.norm_eps), cfg,
                             cache=cache, mode=mode)
        return x + y, cache
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
    layers only) and ``{"body": [block per layer]}``; the hybrid's
    ``{"body": [SSM block ...], "shared": attention + MLP block}``."""
    check_family(cfg)
    n_head = _n_head(cfg)
    p = {}
    if n_head:
        p["head"] = [block_init(generator, cfg, dtype, device) for _ in range(n_head)]
    p["body"] = [block_init(generator, cfg, dtype, device, ffn=_layer_ffn_kind(cfg, i))
                 for i in range(n_head, cfg.n_layers)]
    if cfg.family == "hybrid":
        p["shared"] = block_init(generator, cfg, dtype, device)
    return p


def stack_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", caches: Optional[dict] = None,
                positions=None, rows: Optional[int] = None):
    """Run every layer (``stack_apply``, ``transformer.py:131``): the head
    blocks, then the body; in the hybrid, the shared block after every
    ``attn_every`` body layers, with the group's cache (``:153-227``).
    ``caches`` mirrors the parameters; the hybrid's ``shared`` caches are
    one a group."""
    if cfg.family == "hybrid":
        return _hybrid_apply(p, x, cfg, mode=mode, caches=caches, positions=positions)
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


def _hybrid_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                  caches: Optional[dict], positions):
    out = {"body": [], "shared": []}
    for i, lp in enumerate(p["body"]):
        c = caches["body"][i] if caches is not None else None
        x, c = block_apply(lp, x, cfg, mode=mode, cache=c, ffn="ssm")
        out["body"].append(c)
        if (i + 1) % cfg.attn_every == 0:
            c = caches["shared"][i // cfg.attn_every] if caches is not None else None
            x, c = block_apply(p["shared"], x, cfg, mode=mode, cache=c, positions=positions)
            out["shared"].append(c)
    return x, (out if caches is not None else None)


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> dict:
    """The caches in the parameters' layout: an attention or latent cache a
    block, an SSM cache (``conv``, ``ssm``) an SSM block, and the hybrid's
    ``shared`` KV caches, one a group (``transformer.py:281``)."""
    check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        out = {"body": [ssm_cache_init(cfg, batch, dtype, device)
                        for _ in range(cfg.n_layers)]}
        if cfg.family == "hybrid":
            out["shared"] = [attn_cache_init(cfg, batch, max_len, dtype, device)
                             for _ in range(cfg.n_layers // cfg.attn_every)]
        return out
    n_head = _n_head(cfg)
    cache_init = mla_cache_init if cfg.mla is not None else attn_cache_init
    out = {}
    if n_head:
        out["head"] = [cache_init(cfg, batch, max_len, dtype, device) for _ in range(n_head)]
    out["body"] = [cache_init(cfg, batch, max_len, dtype, device)
                   for _ in range(cfg.n_layers - n_head)]
    return out
