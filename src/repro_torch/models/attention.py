"""GQA attention with qk-norm and RoPE, MLA, and their caches.

Counterpart of ``repro.models.attention``. All of it is plain torch ops;
the JAX package has no Pallas kernel here.

* Train and prefill run the reference's chunked online softmax
  (``_flash_fwd_impl``, ``attention.py:49``), so a long prompt never
  materialises an S x S score matrix, and its flash backward
  (``_flash_bwd``, ``attention.py:102``) recomputes each chunk's
  probabilities from the saved log-sum-exp. Scores and sums are float32.
* Decode attends one query against the cache with float32 logits
  (``decode_attention``, ``attention.py:185``).
* The cache layout is the reference's: k ``(B, Hkv, D, S)``, v
  ``(B, Hkv, S, D)``, ``pos`` a scalar or one write position per row.
  The port writes the cache in place (the reference returns an updated
  copy); the returned dict holds the same tensors.
* MLA (DeepSeek-V2's multi-head latent attention, ``attention.py:363``)
  caches the compressed latent ``ckv`` (B, kv_lora, S) and the RoPE key
  ``kpe`` (B, rope, S): 576 elements a token a layer at DeepSeek-V2-Lite's
  width, where GQA at 16 kv-heads of 128 would cache 4,096. Train and
  prefill expand the latent to per-head keys and values and run
  :func:`flash_attention` (16 heads, d 192, dv 128); decode attends in
  the absorbed form, the query folded through ``wuk`` into the latent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import HEAD_NORM_SPEC, apply_rope, dense, dense_init, dense_spec, rmsnorm

_NEG = -1e30  # the reference's mask value


def _fit_chunk(size: int, want: int) -> int:
    """Largest divisor of ``size`` that is <= ``want``."""
    c = min(want, size)
    while size % c:
        c -= 1
    return c


def _flash_fwd(q, k, v, causal: bool, q_offset: int, chunk: int, scale: float):
    """The reference's ``_flash_fwd_impl`` (``attention.py:49``): the
    output and each query row's log-sum-exp (B, Sq, Hkv, G), float32.

    A causal key chunk that lies wholly after a query chunk is skipped:
    its probabilities are exactly zero and its correction factor exactly
    one, so the result is the reference's."""
    b, sq, hkv, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    cq, ck = _fit_chunk(sq, chunk), _fit_chunk(sk, chunk)
    f32 = torch.float32
    outs, lses = [], []
    for iq in range(sq // cq):
        qi = q[:, iq * cq:(iq + 1) * cq].to(f32)
        qpos = q_offset + iq * cq + torch.arange(cq, device=q.device)
        m = torch.full((b, cq, hkv, g), _NEG, dtype=f32, device=q.device)
        l = torch.zeros((b, cq, hkv, g), dtype=f32, device=q.device)
        acc = torch.zeros((b, cq, hkv, g, dv), dtype=f32, device=q.device)
        for ik in range(sk // ck):
            if causal and ik * ck > q_offset + (iq + 1) * cq - 1:
                break
            ki = k[:, ik * ck:(ik + 1) * ck].to(f32)
            vi = v[:, ik * ck:(ik + 1) * ck]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
            if causal:
                kpos = ik * ck + torch.arange(ck, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vi.dtype).to(f32), vi.to(f32))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, q_offset: int, chunk: int,
               scale: float):
    """The reference's ``_flash_bwd`` (``attention.py:102``): each chunk's
    probabilities recomputed from q, k and the log-sum-exp, so the
    backward holds O(S) state, not the S x S matrices. Float32
    throughout; the causal chunks the forward skipped add exact zeros
    there, so they are skipped here too."""
    b, sq, hkv, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    cq, ck = _fit_chunk(sq, chunk), _fit_chunk(sk, chunk)
    f32 = torch.float32
    dout = dout.to(f32)
    delta = (dout * out.to(f32)).sum(-1)  # (b, sq, hkv, g)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, sk, hkv, d), dtype=f32, device=q.device)
    dvs = torch.zeros((b, sk, hkv, dv), dtype=f32, device=q.device)
    for iq in range(sq // cq):
        rq = slice(iq * cq, (iq + 1) * cq)
        qi, doi, lsei, di = q[:, rq].to(f32), dout[:, rq], lse[:, rq], delta[:, rq]
        qpos = q_offset + iq * cq + torch.arange(cq, device=q.device)
        for ik in range(sk // ck):
            if causal and ik * ck > q_offset + (iq + 1) * cq - 1:
                break
            rk = slice(ik * ck, (ik + 1) * ck)
            ki, vi = k[:, rk].to(f32), v[:, rk].to(f32)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, ki) * scale
            if causal:
                kpos = ik * ck + torch.arange(ck, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
            p = torch.exp(s - lsei[..., None])  # (b, cq, hkv, g, ck)
            dvs[:, rk] += torch.einsum("bqhgk,bqhgv->bkhv", p, doi)
            dp = torch.einsum("bqhgv,bkhv->bqhgk", doi, vi)
            ds = p * (dp - di[..., None]) * scale
            dq[:, rq] += torch.einsum("bqhgk,bkhd->bqhgd", ds, ki)
            dk[:, rk] += torch.einsum("bqhgk,bqhgd->bkhd", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dvs.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Chunked attention with the flash gradient (the reference's
    ``_flash`` custom VJP): forward keeps q, k, v, the output and the
    per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, chunk: int, scale: float):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, chunk, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _flash_bwd(q, k, v, out, lse, dout, *ctx.args) + (None,) * 4


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0, chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention. q (B, Sq, Hkv, G, D), k (B, Sk, Hkv, D), v (B,
    Sk, Hkv, Dv) -> (B, Sq, Hkv, G, Dv); differentiable with the flash
    backward (:func:`_flash_bwd`)."""
    scale = scale if scale is not None else float(1.0 / np.sqrt(q.shape[-1]))
    return _Flash.apply(q, k, v, bool(causal), int(q_offset), int(chunk), float(scale))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hkv, G, D) single query; k_cache (B, Hkv, D, S); v_cache (B,
    Hkv, S, Dv); ``valid_len`` () or (B,) valid cache slots. The logits
    are the product in the working type, widened to float32."""
    d = q.shape[-1]
    s = k_cache.shape[-1]
    scale = scale if scale is not None else float(1.0 / np.sqrt(d))
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    logits = torch.matmul(q, k_cache).float() * scale  # (B, Hkv, G, S)
    valid = valid_len.reshape(-1, 1).expand(q.shape[0], 1)
    mask = torch.arange(s, device=q.device)[None, :] < valid  # (B, S)
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(v_cache.dtype), v_cache).to(q.dtype)


def pad_decode_rows(b: int, valid_len: torch.Tensor, *caches: torch.Tensor):
    """Decode attention's batch-invariance rule, for GQA and MLA: every
    product takes all ``b`` rows of the step (``decode_step`` pads them to
    a multiple of ``DECODE_TILE``, so the count is fixed), the caches'
    ``nc <= b`` rows padded with zero rows of valid length 0, which attend
    nothing and give zeros. A batched product over the nc real rows alone
    gave rows 0-2 other bits at 3 rows than at 4 on the H100 (qwen1.5-32b,
    one query a kv-head). The pad copies each cache once a step, one op a
    tensor (PERF.md gives its measured cost). Returns ``(valid (b,),
    *caches)``."""
    nc = caches[0].shape[0]
    valid = valid_len.reshape(-1).expand(nc)
    if nc == b:
        return (valid,) + caches
    return tuple(F.pad(t, (0, 0) * (t.ndim - 1) + (0, b - nc)) for t in (valid,) + caches)


def attn_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, (h, hd), dtype, device, bias=cfg.qkv_bias),
        "wk": dense_init(generator, d, (hkv, hd), dtype, device, bias=cfg.qkv_bias),
        "wv": dense_init(generator, d, (hkv, hd), dtype, device, bias=cfg.qkv_bias),
        "wo": dense_init(generator, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
        p["kn"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
    return p


def attn_specs(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`attn_init`'s leaves (``attention.py:239``)."""
    b = cfg.qkv_bias
    p = {"wq": dense_spec(("embed", "heads", "head_dim"), b),
         "wk": dense_spec(("embed", "kv_heads", "head_dim"), b),
         "wv": dense_spec(("embed", "kv_heads", "head_dim"), b),
         "wo": dense_spec(("heads_flat", "embed"))}
    if cfg.qk_norm:
        p["qn"] = dict(HEAD_NORM_SPEC)
        p["kn"] = dict(HEAD_NORM_SPEC)
    return p


def _heads_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's heads under TP over them."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp, d_head=cfg.head_dim)


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[dict] = None, mode: str = "train", ctx=None):
    """x (B, S, D) -> (out (B, S, D), cache). ``mode``: train | prefill |
    decode, as in ``attn_apply`` (``attention.py:266``). Under ``ctx`` (a
    call under ``par``): :func:`_attn_spmd`."""
    if ctx is not None:
        return _attn_spmd(p, x, cfg, ctx, positions, cache, mode)
    b, sq, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    q = dense(p["wq"], x)  # (b, s, h, hd)
    k = dense(p["wk"], x)
    v = dense(p["wv"], x)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)

    new_cache = cache
    if mode == "decode":
        assert sq == 1 and cache is not None
        idx = cache["pos"]  # int32 write slot: scalar, or (B,) per row
        kc, vc = cache["k"], cache["v"]
        nc = kc.shape[0]  # rows past the cache's are pads (decode_step)
        k_t = k[:nc, 0].to(kc.dtype)  # (nc, hkv, d)
        v_t = v[:nc, 0].to(vc.dtype)
        if idx.ndim == 0:  # a one-element index: no read of the slot on the host
            slot = idx.long().reshape(1)
            kc[:, :, :, slot] = k_t[..., None]
            vc[:, :, slot, :] = v_t[:, :, None, :]
        else:
            rows = torch.arange(nc, device=x.device)
            kc[rows, :, :, idx.long()] = k_t
            vc[rows, :, idx.long(), :] = v_t
        new_cache = {"k": kc, "v": vc, "pos": idx + 1}
        valid, kc, vc = pad_decode_rows(b, idx + 1, kc, vc)
        qh = q[:, 0].reshape(b, hkv, g, hd)
        out = decode_attention(qh, kc, vc, valid_len=valid).reshape(b, 1, h * hd)
    else:
        if mode == "prefill" and cache is not None:
            kc, vc = cache["k"], cache["v"]
            kc[:, :, :, :sq] = k.permute(0, 2, 3, 1).to(kc.dtype)
            vc[:, :, :sq, :] = v.permute(0, 2, 1, 3).to(vc.dtype)
            new_cache = {"k": kc, "v": vc,
                         "pos": torch.full((), sq, dtype=torch.int32, device=x.device)}
        qg = q.reshape(b, sq, hkv, g, hd)
        out = flash_attention(qg, k, v, causal=cfg.causal, chunk=cfg.attn_chunk)
        out = out.reshape(b, sq, h * hd)
    return dense(p["wo"], out), new_cache


def _attn_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx, positions, cache, mode):
    """GQA under ``par``: the reference's anchors (``attention.py:315-341``)
    carried out on this rank's local tensors, each tier on the layout the
    parameter and cache specs already give, so no sharded leaf is
    gathered whole:

    * **kv heads** divide the TP axis: ``wq`` / ``wk`` / ``wv`` by heads,
      ``wo`` by rows, the cache by kv heads; the rank runs
      :func:`attn_apply` on its heads and one all-reduce sums the output.
    * **heads** divide it (the reference's q-group split and its GQA-TP
      repair, ``attention.py:315-322``): ``wq`` by heads and ``wo`` by
      rows, ``wk`` / ``wv`` replicated (their spec's layout); the rank
      computes every kv head and repeats to its own query heads the kv
      heads they read (``repeat(k, g)`` and the head-wise shard of the
      repair, taken for this rank's heads only). Both of the reference's
      tiers shard the flat heads ``h``; in the port's contiguous head
      layout a rank's ``h / TP`` heads read ``ceil(h / TP / g)`` kv heads,
      never more than the group split's every one, and ``q`` stays where
      ``wq`` put it.
    * neither: **rows** (the reference's sequence-parallel q with
      replicated kv): the rank takes ``ceil(S / TP)`` query rows (the last
      rank's padded), every key; the output returns to every rank by one
      all_to_all into ``wo``'s row blocks (``heads_flat`` sharded) or one
      all-gather after it (replicated).
    * **decode** where the kv heads do not divide: the cache is sharded
      over the contraction dim (``head_dim``, :func:`cache_pspecs`), as the
      reference's decode reads it (``decode_attention``'s partial logits
      and one psum): each rank holds the full query (its heads
      all-gathered), writes its block of the new key and value, sums the
      partial logits with one all-reduce and all-gathers the values'
      blocks. The cache is never gathered. A cache the spec leaves
      replicated over the TP axis (``head_dim`` not divisible) has no
      decode layout here and raises.

    Prefill writes each rank's block of the cache in the stored layout."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if ctx.tp == 1 or ctx.split(hkv):
        heads = ctx.split(hkv)
        lp = ctx.local(p, {"wq": 1, "wk": 1, "wv": 1, "wo": 0} if heads else None,
                       inside=heads)
        if heads:
            ctx.expect_split(cache, {"k": 1, "v": 1})
        c, plan = ctx.cache_local(cache)
        out, c = attn_apply(lp, ctx.copy_to(x) if heads else x,
                            _heads_cfg(cfg, ctx.tp) if heads else cfg,
                            positions=positions, cache=c, mode=mode)
        return (ctx.reduce_from(out) if heads else out), ctx.cache_store(cache, c, plan)
    if mode == "decode":
        return _attn_decode_contract(p, x, cfg, ctx, positions, cache)
    b, sq, _ = x.shape
    by_heads = ctx.split(h)
    wo_rows = ctx.split(h * hd)
    lp = ctx.local(p, {"wq": 1 if by_heads else None, "wo": 0 if wo_rows else None},
                   inside=True)
    x = ctx.copy_to(x)
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    k, v = _attn_kv(lp, x, cfg, positions)
    kd = None if cache is None else (ctx.tp_dim(cache["k"]), ctx.tp_dim(cache["v"]))
    c, plan = ctx.cache_local(cache)
    if mode == "prefill" and c is not None:
        c["k"][:, :, :, :sq] = ctx.block(k.permute(0, 2, 3, 1), kd[0]).to(c["k"].dtype)
        c["v"][:, :, :sq, :] = ctx.block(v.permute(0, 2, 1, 3), kd[1]).to(c["v"].dtype)
        c["pos"] = torch.full((), sq, dtype=torch.int32, device=x.device)
    r = ctx.tp_rank
    if by_heads:  # this rank's query heads, each with the kv head it reads
        hl = h // ctx.tp
        q = _attn_q(lp, x, cfg, positions)
        kv = (r * hl + torch.arange(hl, device=x.device)) // (h // hkv)
        out = flash_attention(q[:, :, :, None], k[:, :, kv], v[:, :, kv], causal=cfg.causal,
                              chunk=cfg.attn_chunk).reshape(b, sq, hl * hd)
        return ctx.reduce_from(dense(lp["wo"], out)), ctx.cache_store(cache, c, plan)
    rl = -(-sq // ctx.tp)  # this rank's query rows, the last rank's padded
    pad = rl * ctx.tp - sq
    xq = F.pad(x, (0, 0, 0, pad)) if pad else x
    pq = positions.expand(b, sq)
    pq = torch.cat([pq, pq[:, -1:].expand(b, pad)], 1) if pad else pq
    q = _attn_q(lp, xq[:, r * rl:(r + 1) * rl], cfg, pq[:, r * rl:(r + 1) * rl])
    out = flash_attention(q.reshape(b, rl, hkv, h // hkv, hd), k, v, causal=cfg.causal,
                          q_offset=r * rl, chunk=cfg.attn_chunk).reshape(b, rl, h * hd)
    if wo_rows:  # every row's block of columns of this rank's, into wo's row block
        y = ctx.reduce_from(dense(lp["wo"], ctx.rows_to_cols(out)[:, :sq]))
    else:
        y = ctx.gather_from(dense(lp["wo"], out), 1)[:, :sq]
    return y, ctx.cache_store(cache, c, plan)


def _attn_q(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    """The queries of x (B, S, D) by ``p["wq"]``'s heads: normed, rotated."""
    q = dense(p["wq"], x)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)


def _attn_kv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """The keys (normed, rotated) and values of x (B, S, D)."""
    k = dense(p["wk"], x)
    if cfg.qk_norm:
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta), dense(p["wv"], x)


@torch.no_grad()
def _attn_decode_contract(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx, positions,
                          cache: dict):
    """:func:`_attn_spmd`'s decode over a cache sharded on ``head_dim``
    (no gradient: decode writes its cache in place)."""
    from repro_torch.parallel.spmd import all_gather, all_reduce

    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kd, vd = ctx.tp_dim(cache["k"]), ctx.tp_dim(cache["v"])
    if kd != 2 or vd != 3:
        raise ValueError(f"{cfg.name}: decode with {hkv} kv heads of {hd} on a TP axis of "
                         f"{ctx.tp} needs the cache sharded over head_dim (cache_pspecs)")
    b = x.shape[0]
    by_heads, wo_rows = ctx.split(h), ctx.split(h * hd)
    lp = ctx.local(p, {"wq": 1 if by_heads else None, "wo": 0 if wo_rows else None})
    q = _attn_q(lp, x, cfg, positions)  # (b, 1, h or h / TP, hd)
    if by_heads:
        q = all_gather(q, ctx.tp_group, 2)
    k, v = _attn_kv(lp, x, cfg, positions)
    c, plan = ctx.cache_local(cache)
    kc, vc, idx = c["k"], c["v"], c["pos"]
    nc = kc.shape[0]
    k_t = ctx.block(k[:nc, 0], 2).to(kc.dtype)  # (nc, hkv, hd / TP)
    v_t = ctx.block(v[:nc, 0], 2).to(vc.dtype)
    if idx.ndim == 0:
        slot = idx.long().reshape(1)
        kc[:, :, :, slot] = k_t[..., None]
        vc[:, :, slot, :] = v_t[:, :, None, :]
    else:
        rows = torch.arange(nc, device=x.device)
        kc[rows, :, :, idx.long()] = k_t
        vc[rows, :, idx.long(), :] = v_t
    c["pos"] = idx + 1
    valid, kcp, vcp = pad_decode_rows(b, idx + 1, kc, vc)
    qh = ctx.block(q[:, 0].reshape(b, hkv, h // hkv, hd), 3)
    logits = all_reduce(torch.matmul(qh, kcp.to(q.dtype)).float(), ctx.tp_group)
    logits = logits * float(1.0 / np.sqrt(hd))
    mask = torch.arange(kcp.shape[-1], device=x.device)[None, :] < valid.reshape(-1, 1)
    w = torch.softmax(logits.masked_fill(~mask[:, None, None, :], _NEG), dim=-1)
    out = all_gather(torch.matmul(w.to(q.dtype), vcp.to(q.dtype)), ctx.tp_group, 3)
    out = out.to(q.dtype).reshape(b, 1, h * hd)
    if wo_rows:
        y = ctx.reduce_from(dense(lp["wo"], ctx.block(out, 2)))
    else:
        y = dense(lp["wo"], out)
    return y, ctx.cache_store(cache, c, plan)


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, hd, max_len), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    """``mla_init`` (``attention.py:363``): ``wq`` (d, h, nope + rope),
    ``wdkv`` (d, kv_lora + rope), ``kv_norm`` (float32 ones, as the
    reference keeps it), ``wuk`` (kv_lora, h, nope), ``wuv`` (kv_lora, h, v),
    ``wo`` (h v, d)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(generator, d, (h, qd), dtype, device),
        "wdkv": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype, device),
        "kv_norm": {"scale": torch.ones(m.kv_lora_rank, dtype=torch.float32, device=device)},
        "wuk": dense_init(generator, m.kv_lora_rank, (h, m.qk_nope_head_dim), dtype, device),
        "wuv": dense_init(generator, m.kv_lora_rank, (h, m.v_head_dim), dtype, device),
        "wo": dense_init(generator, h * m.v_head_dim, d, dtype, device),
    }


def mla_specs(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`mla_init`'s leaves (``attention.py:363``)."""
    return {"wq": dense_spec(("embed", "heads", "head_dim")),
            "wdkv": dense_spec(("embed", "kv_lora")),
            "kv_norm": {"scale": ("kv_lora",)},
            "wuk": dense_spec(("kv_lora", "heads", "head_dim")),
            "wuv": dense_spec(("kv_lora", "heads", "head_dim")),
            "wo": dense_spec(("heads_flat", "embed"))}


def _mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope, q_pe, ckv, k_pe) of x (B, S, D) (``attention.py:382``):
    RoPE over the whole of ``q_pe`` and ``k_pe``; ``ckv`` RMS-normed in
    float32."""
    m = cfg.mla
    q = dense(p["wq"], x)  # (b, s, h, nope + rope)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, 1.0, cfg.rope_theta)
    dkv = dense(p["wdkv"], x)  # (b, s, kv_lora + rope)
    ckv, k_pe = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    ckv = rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, 1.0, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_pe, ckv, k_pe


def _mla_decode(p: dict, q_nope: torch.Tensor, q_pe: torch.Tensor, ckv_c: torch.Tensor,
                kpe_c: torch.Tensor, valid_len: torch.Tensor, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """The absorbed form (``attention.py:413-440``) for one query a row:
    q_nope (B, h, nope), q_pe (B, h, rope), the caches (nc, kv_lora, S)
    and (nc, rope, S) of the first nc <= B rows -> ctx (B, h, v), zero for
    the rows past nc (``decode_step``'s pads). The query's latent and
    both score products are in the working type, then widened; a float32
    softmax, its weights in the cache's type; the latent context back in
    the working type before ``wuv``. Every product takes all B rows
    (:func:`pad_decode_rows`)."""
    q_lat = torch.einsum("bhq,lhq->bhl", q_nope, p["wuk"]["w"].to(dtype))
    valid, ckv_r, kpe_r = pad_decode_rows(q_nope.shape[0], valid_len, ckv_c.to(dtype),
                                          kpe_c.to(dtype))
    s_lat = torch.matmul(q_lat, ckv_r).float()  # (b, h, S)
    s_pe = torch.matmul(q_pe, kpe_r).float()
    logits = (s_lat + s_pe) * scale
    mask = torch.arange(ckv_c.shape[-1], device=q_nope.device)[None, :] < valid[:, None]
    logits = logits.masked_fill(~mask[:, None, :], _NEG)
    w = torch.softmax(logits, dim=-1).to(ckv_r.dtype)
    ctx_lat = torch.matmul(w, ckv_r.transpose(1, 2)).to(dtype)  # pad rows: zero
    return torch.einsum("bhl,lhv->bhv", ctx_lat, p["wuv"]["w"].to(dtype))


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, mode: str = "train", ctx=None):
    """x (B, S, D) -> (out (B, S, D), cache) (``mla_apply``,
    ``attention.py:394``). Decode rows past the cache's are
    ``decode_step``'s pads: they attend nothing and give zeros. Under
    ``ctx`` (a call under ``par``): :func:`_mla_spmd`."""
    if ctx is not None:
        return _mla_spmd(p, x, cfg, ctx, positions, cache, mode)
    m = cfg.mla
    b, sq, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    q_nope, q_pe, ckv, k_pe = _mla_qkv(p, x, cfg, positions)
    scale = float(1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))

    new_cache = cache
    if mode == "decode":
        assert sq == 1 and cache is not None
        idx = cache["pos"]
        ckv_c, kpe_c = cache["ckv"], cache["kpe"]
        nc = ckv_c.shape[0]
        ckv_t = ckv[:nc, 0].to(ckv_c.dtype)  # (nc, kv_lora)
        kpe_t = k_pe[:nc, 0].to(kpe_c.dtype)
        if idx.ndim == 0:  # a one-element index: no read of the slot on the host
            slot = idx.long().reshape(1)
            ckv_c[:, :, slot] = ckv_t[..., None]
            kpe_c[:, :, slot] = kpe_t[..., None]
        else:
            rows = torch.arange(nc, device=x.device)
            ckv_c[rows, :, idx.long()] = ckv_t
            kpe_c[rows, :, idx.long()] = kpe_t
        new_cache = {"ckv": ckv_c, "kpe": kpe_c, "pos": idx + 1}
        ctx = _mla_decode(p, q_nope[:, 0], q_pe[:, 0], ckv_c, kpe_c, idx + 1, scale, x.dtype)
        out = ctx.reshape(b, 1, h * m.v_head_dim)
    else:
        if mode == "prefill" and cache is not None:
            ckv_c, kpe_c = cache["ckv"], cache["kpe"]
            ckv_c[:, :, :sq] = ckv.transpose(1, 2).to(ckv_c.dtype)
            kpe_c[:, :, :sq] = k_pe.transpose(1, 2).to(kpe_c.dtype)
            new_cache = {"ckv": ckv_c, "kpe": kpe_c,
                         "pos": torch.full((), sq, dtype=torch.int32, device=x.device)}
        out = _mla_attend(p, q_nope, q_pe, ckv, k_pe, cfg)
    return dense(p["wo"], out), new_cache


def _mla_attend(p: dict, q_nope, q_pe, ckv, k_pe, cfg: ModelConfig) -> torch.Tensor:
    """Train / prefill attention of :func:`mla_apply`: the latent expanded
    to ``p``'s heads, one flash attention -> (B, S, h * v)."""
    m = cfg.mla
    b, sq, h = q_nope.shape[:3]
    scale = float(1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    k_nope = dense(p["wuk"], ckv)  # (b, s, h, nope): the latent expanded
    v = dense(p["wuv"], ckv)
    k_pe_b = k_pe[:, :, None, :].expand(b, sq, h, m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_pe_b], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)[:, :, :, None, :]  # MHA: hkv = h, g = 1
    out = flash_attention(q, k, v, causal=cfg.causal, chunk=cfg.attn_chunk, scale=scale)
    return out.reshape(b, sq, h * m.v_head_dim)


def _mla_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx, positions, cache, mode):
    """MLA under ``par``: the heads split over the TP axis (the reference's
    head anchors, ``attention.py:448-456``): ``wq``, ``wuk``, ``wuv`` by
    heads, ``wo`` by rows, one all-reduce of the output; ``wdkv`` and
    ``kv_norm`` replicated (the latent is every head's, computed on every
    rank). The latent cache stays in the layout :func:`cache_pspecs` gives
    it (``ckv`` over the latent, ``kpe`` over the rope dim): prefill
    writes each rank's block; decode contracts over the blocks, as the
    reference's decode reads them (:func:`_mla_decode_spmd`). Heads that
    do not divide the TP axis have no layout here and raise."""
    h = cfg.n_heads
    if ctx.tp > 1 and not ctx.split(h):
        raise ValueError(f"{cfg.name}: MLA's {h} heads do not split over a TP axis of "
                         f"{ctx.tp}")
    lp = ctx.local(p, {"wq": 1, "wuk": 1, "wuv": 1, "wo": 0}, inside=True)
    dims = None if cache is None else {n: ctx.tp_dim(cache[n]) for n in ("ckv", "kpe")}
    c, plan = ctx.cache_local(cache)
    lcfg = dataclasses.replace(cfg, n_heads=h // ctx.tp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if mode == "decode":
        out = _mla_decode_spmd(lp, x, lcfg, ctx, positions, c, dims)
    else:
        x = ctx.copy_to(x)
        q_nope, q_pe, ckv, k_pe = _mla_qkv(lp, x, lcfg, positions)
        if mode == "prefill" and c is not None:
            sq = x.shape[1]
            c["ckv"][:, :, :sq] = ctx.block(ckv.transpose(1, 2), dims["ckv"]).to(c["ckv"].dtype)
            c["kpe"][:, :, :sq] = ctx.block(k_pe.transpose(1, 2), dims["kpe"]).to(c["kpe"].dtype)
            c["pos"] = torch.full((), sq, dtype=torch.int32, device=x.device)
        out = _mla_attend(lp, q_nope, q_pe, ckv, k_pe, lcfg)
    return ctx.reduce_from(dense(lp["wo"], out)), ctx.cache_store(cache, c, plan)


@torch.no_grad()
def _mla_decode_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx, positions, c: dict,
                     dims: dict) -> torch.Tensor:
    """:func:`_mla_spmd`'s decode step (``cfg``: this rank's heads) ->
    (B, 1, h / TP * v). Where the latent cache is sharded (``ckv`` over
    the latent, ``kpe`` over the rope dim) every rank holds every head's
    query latent (all-gathered), sums the partial scores of its blocks
    with one all-reduce, and all-gathers the context's latent blocks
    before its own heads' ``wuv``; the cache is never gathered. Where
    neither is sharded: :func:`_mla_decode` on this rank's heads."""
    from repro_torch.parallel.spmd import all_gather, all_reduce

    m = cfg.mla
    b = x.shape[0]
    q_nope, q_pe, ckv, k_pe = _mla_qkv(p, x, cfg, positions)
    ckv_c, kpe_c, idx = c["ckv"], c["kpe"], c["pos"]
    nc = ckv_c.shape[0]
    ckv_t = ctx.block(ckv[:nc, 0], dims["ckv"]).to(ckv_c.dtype)
    kpe_t = ctx.block(k_pe[:nc, 0], dims["kpe"]).to(kpe_c.dtype)
    if idx.ndim == 0:
        slot = idx.long().reshape(1)
        ckv_c[:, :, slot] = ckv_t[..., None]
        kpe_c[:, :, slot] = kpe_t[..., None]
    else:
        rows = torch.arange(nc, device=x.device)
        ckv_c[rows, :, idx.long()] = ckv_t
        kpe_c[rows, :, idx.long()] = kpe_t
    c["pos"] = idx + 1
    scale = float(1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    dt = x.dtype
    if dims["ckv"] is None and dims["kpe"] is None:
        out = _mla_decode(p, q_nope[:, 0], q_pe[:, 0], ckv_c, kpe_c, idx + 1, scale, dt)
        return out.reshape(b, 1, -1)
    if dims["ckv"] != 1 or dims["kpe"] != 1:
        raise ValueError(f"{cfg.name}: the latent cache is sharded over one of its two "
                         f"leaves only ({dims}); decode needs both or neither")
    q_lat = torch.einsum("bhq,lhq->bhl", q_nope[:, 0], p["wuk"]["w"].to(dt))
    q_lat = ctx.block(all_gather(q_lat, ctx.tp_group, 1), 2)  # every head, this latent block
    q_pe = ctx.block(all_gather(q_pe[:, 0], ctx.tp_group, 1), 2)
    valid, ckv_r, kpe_r = pad_decode_rows(b, idx + 1, ckv_c.to(dt), kpe_c.to(dt))
    part = torch.matmul(q_lat, ckv_r).float() + torch.matmul(q_pe, kpe_r).float()
    logits = all_reduce(part, ctx.tp_group) * scale  # (b, h, S)
    mask = torch.arange(ckv_c.shape[-1], device=x.device)[None, :] < valid[:, None]
    w = torch.softmax(logits.masked_fill(~mask[:, None, :], _NEG), dim=-1).to(ckv_r.dtype)
    ctx_lat = all_gather(torch.matmul(w, ckv_r.transpose(1, 2)), ctx.tp_group, 2).to(dt)
    ctx_lat = ctx.block(ctx_lat, 1)  # this rank's heads
    out = torch.einsum("bhl,lhv->bhv", ctx_lat, p["wuv"]["w"].to(dt))
    return out.reshape(b, 1, -1)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """The latent cache: ``ckv`` (B, kv_lora, S), ``kpe`` (B, rope, S)."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, m.kv_lora_rank, max_len), dtype=dtype, device=device),
        "kpe": torch.zeros((batch, m.qk_rope_head_dim, max_len), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
