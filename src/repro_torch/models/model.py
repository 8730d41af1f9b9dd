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
layer axis. :func:`param_specs` is the tree of logical axes, leaf for
leaf, that the reference's ``model_init`` returns beside its parameters.

With ``par`` (a :class:`~repro_torch.parallel.Parallelism`) every entry
point runs SPMD, one process a rank, each passing the same full batch:
parameters and caches are DTensors placed by their specs
(:func:`~repro_torch.parallel.shard_params`, :func:`init_cache`), the
rows split over the dp axes, the heads, the MLP width, the experts and
the vocabulary over the TP axis where they divide it
(:mod:`repro_torch.parallel.spmd`). Logits come back as the logical
array, a DTensor (``.full_tensor()`` gives the full one); ``loss_fn``
the mean over the whole batch on every rank.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .layers import NORM_SPEC, dense, dense_init, dense_spec, embed, rmsnorm
from .transformer import stack_apply, stack_cache_init, stack_init, stack_specs


#: decode pads its batch to a multiple of this many rows (see decode_step)
DECODE_TILE = 8


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def model_init(generator: Optional[torch.Generator], cfg: ModelConfig,
               device: DeviceLike = None, dtype: Optional[torch.dtype] = None, *,
               par=None) -> dict:
    """Random weights with the distributions of ``repro.models.model_init``:
    embedding normal x 0.02, dense weights normal x 1/sqrt(fan_in), norms
    ones. Each tensor is drawn in float32 and stored in ``dtype`` one at a
    time, so the full-width model never holds a float32 copy of all its
    weights when it serves. ``dtype`` defaults to ``cfg.dtype`` (serving);
    the trainer asks for float32 master weights, as the reference's
    ``model_init`` returns them, and :func:`forward` casts them to
    ``cfg.dtype``. The draws do not depend on ``dtype``. ``generator`` (on
    ``device``) makes the draw reproducible; ``None`` seeds one with 0. The
    audio family has a ``frontend`` dense (``frontend_dim`` -> ``d_model``)
    in place of the embedding; the vlm family adds ``patch_proj``
    (``model.py:22``). ``device="meta"`` gives the shapes and types only
    (no draw, no memory), as the reference's ``jax.eval_shape`` does.

    ``par``: the same draws, each part (the embedding, a layer, the head)
    placed by :func:`param_specs` as soon as it is drawn
    (:func:`~repro_torch.parallel.shard_params`'s placement), so the rank
    holds its shards and at most one full part: a model whose weights
    exceed one card starts on a mesh that holds it."""
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = dtype or _dtype(cfg)
    put = _placer(cfg, par, dt)
    if cfg.family == "audio":
        p = {"frontend": put(dense_init(generator, cfg.frontend_dim, cfg.d_model, dt, dev),
                             "frontend")}
    else:
        emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                          device=dev, dtype=torch.float32)
        p = {"embed": {"emb": emb.mul_(0.02).to(dt)}}
        del emb
        p["embed"] = put(p["embed"], "embed")
        if cfg.family == "vlm":
            p["patch_proj"] = put(dense_init(generator, cfg.frontend_dim, cfg.d_model, dt,
                                             dev), "patch_proj")
    p["stack"] = stack_init(generator, cfg, dt, dev,
                            put=lambda blk, *path: put(blk, "stack", *path))
    p["final_norm"] = put({"scale": torch.ones(cfg.d_model, dtype=dt, device=dev)},
                          "final_norm")
    if not cfg.tie_embeddings:
        p["lm_head"] = put(dense_init(generator, cfg.d_model, cfg.vocab_size, dt, dev),
                           "lm_head")
    return p


def _placer(cfg: ModelConfig, par, dtype):
    """``put(part, *path)``: the part of :func:`model_init`'s tree at
    ``path`` placed by its specs under ``par``; as it is without."""
    if par is None:
        return lambda part, *path: part
    from repro_torch.parallel.sharding import build_param_pspecs, shard_tree

    _check_par(par)
    pspecs = build_param_pspecs(model_init(None, cfg, "meta", dtype), param_specs(cfg),
                                par.mesh)

    def put(part, *path):
        spec = pspecs
        for key in path:
            spec = spec[key]
        return shard_tree(part, spec, par.mesh)

    return put


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`model_init`'s tree (the
    reference's ``model_init`` returns them as its second value,
    ``model.py:22-38``): the tree :func:`repro_torch.parallel.build_param_pspecs`
    and :func:`~repro_torch.parallel.shard_params` read. It allocates
    nothing; the shapes are ``model_init(..., device="meta")``'s."""
    if cfg.family == "audio":
        s = {"frontend": dense_spec(("frontend", "embed"))}
    else:
        s = {"embed": {"emb": ("vocab", "embed")}}
        if cfg.family == "vlm":
            s["patch_proj"] = dense_spec(("frontend", "embed"))
    s["stack"] = stack_specs(cfg)
    s["final_norm"] = dict(NORM_SPEC)
    if not cfg.tie_embeddings:
        s["lm_head"] = dense_spec(("embed", "vocab"))
    return s


def _check_par(par) -> None:
    from repro_torch.parallel.sharding import Parallelism

    if par is not None and not isinstance(par, Parallelism):
        raise TypeError(f"par must be a repro_torch.parallel.Parallelism, not "
                        f"{type(par).__name__}")


def _spmd(par, batch: int):
    from repro_torch.parallel.spmd import SpmdContext

    return SpmdContext(par, batch)


def _cast_params(p, cfg: ModelConfig):
    """Every float32 leaf cast to ``cfg.dtype`` once, before the stack
    (``model.py:58``): float32 master weights compute as the serving
    weights do, and the cast is part of the graph, so their gradients are
    float32. Weights already in ``cfg.dtype`` pass as they are."""
    dt = _dtype(cfg)
    if isinstance(p, dict):
        return {k: _cast_params(v, cfg) for k, v in p.items()}
    if isinstance(p, list):
        return [_cast_params(v, cfg) for v in p]
    return p.to(dt) if p.dtype == torch.float32 else p


def _logits(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """The logits; under ``ctx`` this rank's rows and, where the
    vocabulary splits over the TP axis, its block of the vocabulary."""
    if ctx is not None:
        split = ctx.split(cfg.vocab_size)
        x = rmsnorm({"scale": ctx.fetch(p["final_norm"]["scale"])}, x, cfg.norm_eps)
        x = ctx.copy_to(x) if split else x
        if cfg.tie_embeddings:
            w = ctx.fetch(p["embed"]["emb"], 0 if split else None)
            return torch.matmul(x, w.to(x.dtype).t())
        return dense({"w": ctx.fetch(p["lm_head"]["w"], 1 if split else None)}, x)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, p["embed"]["emb"].to(x.dtype).t())
    return dense(p["lm_head"], x)


def _embed_tokens(p: dict, tokens: torch.Tensor, dtype, cfg: ModelConfig, ctx=None):
    """The token embedding; under ``ctx`` of this rank's rows, the table
    split over the TP axis by vocabulary where it divides: each rank
    looks up the ids in its block, zeros the others, and one all-reduce
    sums the blocks (exact: one term is not zero)."""
    if ctx is None:
        return embed(p["embed"], tokens, dtype)
    split = ctx.split(cfg.vocab_size)
    emb = ctx.fetch(p["embed"]["emb"], 0 if split else None)
    if not split:
        return embed({"emb": emb}, tokens, dtype)
    v_loc = emb.shape[0]
    ids = tokens.long() - ctx.tp_rank * v_loc
    ok = (ids >= 0) & (ids < v_loc)
    x = embed({"emb": emb}, ids.clamp(0, v_loc - 1), dtype)
    return ctx.reduce_from(x * ok[..., None].to(x.dtype))


def _input(x, like: torch.Tensor) -> torch.Tensor:
    """A batch entry (tensor or array) on ``like``'s device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(like.device)


def _embed_inputs(p: dict, batch: dict, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """The stack's input (``model.py:45``): audio frames through
    ``frontend``; tokens through the embedding, behind the vlm patches
    projected by ``patch_proj``. Frames and patches are cast to
    ``cfg.dtype`` before their product, as the reference casts them.
    Under ``ctx``, of this rank's rows of the batch."""
    dt = _dtype(cfg)
    rows = (lambda v: v) if ctx is None else ctx.rows  # noqa: E731
    fetch = (lambda d: d) if ctx is None else ctx.local  # noqa: E731
    if cfg.family == "audio":
        fp = fetch(p["frontend"])
        return dense(fp, _input(rows(batch["frames"]), fp["w"]).to(dt))
    x = _embed_tokens(p, rows(batch["tokens"]), dt, cfg, ctx)
    if cfg.family == "vlm" and "patches" in batch:
        pp = fetch(p["patch_proj"])
        px = dense(pp, _input(rows(batch["patches"]), pp["w"]).to(dt))
        x = torch.cat([px, x], dim=1)  # the patches prefix the text
    return x


def _forward_local(p: dict, batch: dict, cfg: ModelConfig, ctx, remat: str):
    """The logits of this rank's rows (and vocabulary block) under
    ``ctx``; all of them without."""
    p = _cast_params(p, cfg)
    x = _embed_inputs(p, batch, cfg, ctx)
    x, _ = stack_apply(p["stack"], x, cfg, mode="train", remat=remat, ctx=ctx)
    if cfg.family == "vlm":
        x = x[:, cfg.frontend_len:]  # logits over the text positions only
    return _logits(p, x, cfg, ctx)


def _batch_rows(batch: dict, cfg: ModelConfig) -> int:
    return (batch["frames"] if cfg.family == "audio" else batch["tokens"]).shape[0]


def forward(p: dict, batch: dict, cfg: ModelConfig, *, par=None,
            remat: str = "none") -> torch.Tensor:
    """Full-sequence forward -> logits (B, S_out, V); the vlm family
    drops its ``frontend_len`` patch positions (``model.py:77``).
    ``remat`` (none | full | dots) checkpoints each block for the
    backward (:func:`~.transformer.stack_apply`). With ``par`` the
    logits are a DTensor: rows over the dp axes, the vocabulary over the
    TP axis, each where it divides."""
    _check_par(par)
    if par is None:
        return _forward_local(p, batch, cfg, None, remat)
    ctx = _spmd(par, _batch_rows(batch, cfg))
    logits = _forward_local(p, batch, cfg, ctx, remat)
    return ctx.to_global(logits, 2 if ctx.split(cfg.vocab_size) else None)


def _nll_split(logits: torch.Tensor, targets: torch.Tensor, ctx) -> torch.Tensor:
    """Cross entropy of logits whose vocabulary is split over the TP
    axis: the max and the sum of exponentials all-reduced, the target's
    logit taken where it lies."""
    m = ctx.tp_max(logits.detach().amax(dim=-1))
    se = ctx.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1))
    logz = m + torch.log(se)
    v_loc = logits.shape[-1]
    t = targets - ctx.tp_rank * v_loc
    ok = (t >= 0) & (t < v_loc)
    gold = torch.gather(logits, -1, t.clamp(0, v_loc - 1)[..., None])[..., 0]
    return logz - ctx.reduce_from(gold * ok)


def loss_fn(p: dict, batch: dict, cfg: ModelConfig, *, par=None,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token (LM) or per-frame (encoder) cross entropy in
    float32 (``model.py:87``): log-sum-exp minus the target's logit,
    averaged over ``batch["mask"]`` where one is given. With ``par`` each
    rank takes its rows, and the mean over the whole batch comes back
    on every rank."""
    _check_par(par)
    ctx = None if par is None else _spmd(par, _batch_rows(batch, cfg))
    logits = _forward_local(p, batch, cfg, ctx, remat).float()
    rows = (lambda v: v) if ctx is None else ctx.rows  # noqa: E731
    targets = _input(rows(batch["targets"]), logits).long()
    if ctx is not None and ctx.split(cfg.vocab_size):
        nll = _nll_split(logits, targets, ctx)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        mask = _input(rows(mask), logits).float()
        if ctx is not None and ctx.dp:
            return ctx.reduce_dp((nll * mask).sum()) / torch.clamp(
                ctx.reduce_dp(mask.sum()), min=1.0)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if ctx is not None and ctx.dp:
        return ctx.reduce_dp(nll.sum()) / (nll.numel() * par.dp_size)
    return nll.mean()


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None, *, par=None) -> dict:
    """The decode caches; an encoder-only config has none (``model.py:100``).
    With ``par`` each leaf is a DTensor placed by
    :func:`~repro_torch.parallel.cache_pspecs`."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step, no cache")
    _check_par(par)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.cache_dtype) if cfg.cache_dtype else _dtype(cfg)
    cache = stack_cache_init(cfg, batch, max_len, dt, dev)
    if par is None:
        return cache
    from repro_torch.parallel.sharding import cache_pspecs, shard_tree

    return shard_tree(cache, cache_pspecs(cfg, par, cache), par.mesh)


def prefill(p: dict, batch: dict, cache: dict, cfg: ModelConfig, *,
            lengths: Optional[torch.Tensor] = None, par=None):
    """Run the prompt through the stack, filling the cache
    (``model.py:137``). Returns (last-position logits (B, V), cache).
    With ``lengths`` (B,) the prompts are right-padded: logits come from
    each row's position ``lengths - 1`` (causal attention keeps the valid
    positions exact) and every layer's ``pos`` becomes ``lengths``. The
    SSM and hybrid families refuse ``lengths``: a pad token would enter
    the recurrent state (as ``repro.serving.engine.generate`` refuses
    them); so do the frontends, whose prompts are not tokens only
    (``model.py:150``). A vlm batch's ``patches`` fill the first
    ``frontend_len`` positions of the cache. With ``par`` the logits are
    a DTensor (as :func:`forward`'s) and ``cache`` is :func:`init_cache`'s
    with the same ``par``."""
    if lengths is not None and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: ragged prompts need attention caches, not the "
                         f"{cfg.family} family's recurrent state")
    if lengths is not None and cfg.family in ("vlm", "audio"):
        raise ValueError(f"{cfg.name}: ragged prefill covers token-only prompts, not the "
                         f"{cfg.family} family's")
    _check_par(par)
    ctx = None if par is None else _spmd(par, _batch_rows(batch, cfg))
    x = _embed_inputs(p, batch, cfg, ctx)
    x, cache = stack_apply(p["stack"], x, cfg, mode="prefill", caches=cache, ctx=ctx)
    if lengths is None:
        return _global(ctx, _logits(p, x[:, -1:], cfg, ctx)[:, 0], cfg), cache
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
    if ctx is not None:
        lengths = ctx.rows(lengths)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, (lengths - 1).long()][:, None]
    cache = cache_with_lengths(cache, lengths if ctx is None else ctx.to_global(lengths))
    return _global(ctx, _logits(p, last, cfg, ctx)[:, 0], cfg), cache


def _map_layer_caches(tree, fn):
    """``fn`` applied to every layer's attention cache (a dict with a
    ``pos`` leaf) of a cache tree, other nodes as they are."""
    if isinstance(tree, dict) and "pos" in tree:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_layer_caches(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_layer_caches(v, fn) for v in tree)
    return tree


def cache_with_lengths(cache, lengths):
    """``cache`` with every layer's ``pos`` set to the rows' valid lengths
    (B,) (``model.py:118``), so that after a right-padded ragged prefill
    each row's next decode step writes at its own prompt length. Each
    layer gets its own int32 copy; a tensor stays where it is, a sequence
    of ints goes to the device of the layer's positions."""
    def fix(lc):
        new = lengths if isinstance(lengths, torch.Tensor) else torch.as_tensor(
            np.asarray(lengths), device=lc["pos"].device)
        return {**lc, "pos": new.to(torch.int32).clone()}

    return _map_layer_caches(cache, fix)


def _global(ctx, logits: torch.Tensor, cfg: ModelConfig):
    """(B, V) logits as the caller gets them: as they are without ``ctx``,
    else the logical array."""
    if ctx is None:
        return logits
    return ctx.to_global(logits, 1 if ctx.split(cfg.vocab_size) else None)


def decode_step(p: dict, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
                *, positions: Optional[torch.Tensor] = None, par=None):
    """One decode step (``model.py:157``). tokens (B, 1) -> (logits (B, V),
    cache); ``positions`` (B, 1) are the RoPE positions of the tokens.

    The rows run padded to a multiple of :data:`DECODE_TILE` (pad rows
    take token 0 at position 0, have no cache and are dropped): every
    weight product then has the same shape for one row as for a full
    tile, so a row's logits do not depend on how many rows share the
    step. Decode attention (GQA and MLA) takes the padded rows too, the
    caches padded with zero rows; an SSM layer's recurrence runs on the
    cache's rows, and its result for a row does not depend on the batch. It
    embeds tokens only, as the reference's does (``model.py:157``).
    With ``par`` each rank pads its own rows (the batch's block on the dp
    axes) to the tile, so its products run at the one-card shapes; the
    logits are a DTensor (as :func:`forward`'s)."""
    _check_par(par)
    ctx = None
    if par is not None:
        ctx = _spmd(par, tokens.shape[0])
        tokens = ctx.rows(tokens)
        positions = None if positions is None else ctx.rows(positions)
    b = tokens.shape[0]
    pad = -b % DECODE_TILE
    if positions is None:  # as attn_apply's default: position 0
        positions = torch.zeros((b, 1), dtype=torch.int32, device=tokens.device)
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, 1))])
        positions = torch.cat([positions, positions.new_zeros((pad, 1))])
    x = _embed_tokens(p, tokens, _dtype(cfg), cfg, ctx)
    x, cache = stack_apply(p["stack"], x, cfg, mode="decode", caches=cache,
                           positions=positions, rows=b, ctx=ctx)
    return _global(ctx, _logits(p, x, cfg, ctx)[:b, 0], cfg), cache
