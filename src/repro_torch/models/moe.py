"""Mixture-of-Experts with LOMS routing (counterpart of ``repro.models.moe``).

Router: the top-k of the expert logits by the blockwise LOMS network of
the schedule executor (``repro_torch.topk(backend="schedule")``), as the
reference routes it; the router kernel (row 3) orders tied logits
otherwise, so the expert ids would differ. Dispatch: capacity-bounded
per-expert buffers filled in arrival order, the expert FFNs as batched
products over all experts, the outputs gathered back and weighted by the
gates. ``dispatch="sorted"`` takes the positions from a sort of the
unique keys ``expert * n + arrival`` (the class sort, kernel row 6, on
the card where ``n`` fits one class; the executor otherwise), bit-equal
to the cumsum's.

Expert parallelism (``moe_apply(par=...)`` with ``par.ep_enabled``):
the experts split over the TP axis, ``E / P`` a rank. Every rank passes
the full tokens and weights, takes its experts, and, where the sequence
divides the axis (prefill, training), its slice of the sequence: its
tokens' (E, C, D) buckets go to the expert owners as (E/P, P*C, D) by one
all_to_all and come back by another. Otherwise (decode) every rank takes
every token, masks the choices of experts it does not own, and one
all_reduce sums the ranks' outputs (``ep_psum``). The batch splits over
the dp axes. Every rank returns the full (B, S, D) output.
:func:`moe_ffn_local` is the reference's ``shard_map`` body: its
``axis_name`` is the TP axis's process group. ``expert_capacities`` is
refused under EP, as the reference asserts: EP buckets travel as dense
(E, C, D).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import dense, dense_init, dense_spec

#: the largest key count the sorted dispatch sorts (``moe.py:223``);
#: above it the cumsum gives the positions
SORTED_CAP = 4096
#: with a TP axis that the distributed sample-sort can use, the cap rises
#: to this (``moe.py:227``)
SORTED_CAP_SHARDED = 1 << 16


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> dict:
    """The router (``dense_init``), the stacked expert weights ``wi`` / ``wg``
    (E, D, F) ~ normal x 1/sqrt(D) and ``wo`` (E, F, D) ~ normal x
    1/sqrt(F), each drawn in float32 and stored in ``dtype`` one tensor at a
    time, and the shared experts (``moe.py:39``)."""
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_expert
    p = {"router": dense_init(generator, d, e, dtype, device)}
    for name, shape, fan_in in (("wi", (e, d, f), d), ("wg", (e, d, f), d),
                                ("wo", (e, f, d), f)):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        p[name] = {"w": w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)}
        del w
    if mo.n_shared_experts:
        fs = f * mo.n_shared_experts
        p["shared_wi"] = dense_init(generator, d, fs, dtype, device)
        p["shared_wg"] = dense_init(generator, d, fs, dtype, device)
        p["shared_wo"] = dense_init(generator, fs, d, dtype, device)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`moe_init`'s leaves (``moe.py:39``)."""
    p = {"router": dense_spec(("embed", "expert")),
         "wi": {"w": ("expert", "embed", "mlp")},
         "wg": {"w": ("expert", "embed", "mlp")},
         "wo": {"w": ("expert", "mlp", "embed")}}
    if cfg.moe.n_shared_experts:
        p["shared_wi"] = dense_spec(("embed", "mlp"))
        p["shared_wg"] = dense_spec(("embed", "mlp"))
        p["shared_wo"] = dense_spec(("mlp", "embed"))
    return p


def router_topk(logits: torch.Tensor, k: int, block: int):
    """LOMS blockwise top-k of (T, E) logits in float32 and the softmax of
    the k values: ``(gates (T, k) float32, expert ids (T, k) int32)``
    (``moe.py:61``)."""
    from repro_torch.api.ops import topk

    e = logits.shape[-1]
    blk = min(block, e)
    while e % blk:
        blk -= 1
    vals, idx = topk(logits.float(), k, block=blk, backend="schedule")
    return torch.softmax(vals, dim=-1), idx


def _positions_cumsum(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each choice within its expert, in arrival order: a
    one-hot cumsum (``moe.py:77``)."""
    experts = torch.arange(n_experts, dtype=flat_e.dtype, device=flat_e.device)
    oh = (flat_e[:, None] == experts).to(torch.int32)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    return (pos * oh).sum(-1).to(torch.int32)


def class_sort_dispatch(n: int, device, par=None) -> bool:
    """Whether the dispatch sort of ``n`` keys on ``device`` takes the
    class sort (kernel row 6): on the card, one size class wide, no
    ``par``, the segmented switch on (``moe.py:109``)."""
    from repro_torch.segmented import max_class_width, segmented_enabled

    return (par is None and segmented_enabled() and torch.device(device).type == "cuda"
            and n <= max_class_width(torch.int32))


def _positions_sorted(flat_e: torch.Tensor, n_experts: int, par=None) -> torch.Tensor:
    """The same positions from a sort of the unique keys ``expert * n +
    arrival`` with an iota payload (``moe.py:84``): rank minus the start of
    the expert. On the card, where ``n`` fits one size class, no ``par``
    is offered and the segmented switch is on, the class sort (kernel row
    6) sorts them, as the reference's TPU does; else, and on the CPU, the
    schedule executor; with ``par`` the planner, which may pick the
    distributed sample-sort. The keys are unique, so every route gives
    the same positions."""
    from repro_torch.api.ops import segment_sort, sort

    n = flat_e.shape[0]
    dev = flat_e.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    keys = flat_e.to(torch.int32) * n + iota
    if class_sort_dispatch(n, dev, par):
        sorted_keys, perm = segment_sort(keys, (0, n), payload=iota, backend="segmented")
    else:
        sorted_keys, perm = sort(keys, payload=iota,
                                 backend="schedule" if par is None else "auto", par=par)
    sorted_e = (sorted_keys // n).long()
    counts = torch.bincount(flat_e.long(), minlength=n_experts)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    pos[perm.long()] = (torch.arange(n, device=dev) - starts[sorted_e]).to(torch.int32)
    return pos


def _expert_ffn(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: (E, C, D) -> (E, C, D), three
    batched products (``moe.py:132``)."""
    h = torch.bmm(buf, p["wi"]["w"].to(buf.dtype))
    g = torch.bmm(buf, p["wg"]["w"].to(buf.dtype))
    return torch.bmm(F.silu(h) * g, p["wo"]["w"].to(buf.dtype))


def _expert_ffn_csr(buf: torch.Tensor, p: dict, caps: np.ndarray,
                    starts: np.ndarray) -> torch.Tensor:
    """The expert FFN over a CSR buffer (sum(caps), D) in which expert i
    owns rows ``starts[i]:starts[i] + caps[i]``: the experts of one
    capacity share one batched product (``moe.py:140``)."""
    out = torch.zeros_like(buf)
    classes = {}
    for i, c in enumerate(np.asarray(caps).tolist()):
        classes.setdefault(int(c), []).append(i)
    for c, ids in sorted(classes.items()):
        if c == 0:
            continue
        gmap = torch.as_tensor(np.asarray(starts)[ids][:, None] + np.arange(c)[None, :],
                               device=buf.device)
        sel = torch.as_tensor(ids, device=buf.device)
        res = _expert_ffn(buf[gmap], {nm: {"w": p[nm]["w"][sel]} for nm in ("wi", "wg", "wo")})
        out[gmap.reshape(-1)] = res.reshape(-1, buf.shape[-1])
    return out


def _expert_a2a(buf: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """The EP bucket exchange: forward, (E, C, D) -> (E/P, P*C, D), each
    rank's buckets of expert block ``j`` to rank ``j`` (the reference's
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``); back, the
    inverse. Differentiable: the gradient takes the inverse exchange."""
    return _A2A.apply(buf, group, forward)


class _A2A(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, group, forward):
        ctx.group, ctx.fwd = group, forward
        return _expert_a2a_raw(buf, group, forward)

    @staticmethod
    def backward(ctx, g):
        return _expert_a2a_raw(g.contiguous(), ctx.group, not ctx.fwd), None, None


def _expert_a2a_raw(buf: torch.Tensor, group, forward: bool) -> torch.Tensor:
    from repro_torch.parallel.comm import all_to_all

    p = dist.get_world_size(group)
    if forward:
        e, c, d = buf.shape
        got = all_to_all(buf.reshape(p, e // p, c, d), group, dim=0)  # [i]: from rank i
        return got.transpose(0, 1).reshape(e // p, p * c, d)
    el, pc, d = buf.shape
    back = all_to_all(buf.reshape(el, p, pc // p, d).transpose(0, 1), group, dim=0)
    return back.reshape(p * el, pc // p, d)


def moe_ffn_local(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  n_real: Optional[int] = None, axis_name=None, ep_size: int = 1,
                  ep_psum: bool = False, par=None,
                  logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed expert FFN of (T, D) tokens (``moe.py:166``). ``n_real``: the
    tokens before the padding rows that decode appends (they go last, so
    they never take a real token's slot); the capacity and the choice of
    dispatch count the real tokens only, as the reference's unpadded batch
    does. Each kept slot of the (E, C) buffer receives exactly one token;
    the choices past their expert's capacity land in a spill row that is
    dropped.

    Expert parallelism: ``axis_name`` (the TP axis's process group, of
    ``ep_size`` ranks) with ``p`` holding this rank's ``E / ep_size``
    experts. The all_to_all mode (tokens sequence-sharded) buckets over
    every expert and exchanges the buckets; ``ep_psum`` (tokens the same
    on every rank) keeps the choices of this rank's experts and sums the
    ranks' outputs with one all_reduce. ``par`` rides along for the
    sorted dispatch's sort only (None inside EP, as in the reference).
    ``logits``: the router's (T, E) logits where the caller computed them
    (under TP, from the router's column blocks), else ``p["router"]``'s."""
    mo = cfg.moe
    t, d = x.shape
    t_real = t if n_real is None else int(n_real)
    e, k = mo.n_experts, mo.top_k
    ep = axis_name is not None and ep_size > 1
    if ep:
        if e % ep_size:
            raise ValueError(f"{e} experts do not split over an EP axis of {ep_size}")
        if mo.expert_capacities is not None:
            raise ValueError("expert_capacities is a non-EP feature: EP buckets travel as "
                             "dense (E, C, D) through all_to_all")
    if logits is None:
        logits = dense(p["router"], x)
    gates, eids = router_topk(logits, k, mo.router_block)
    if ep and ep_psum:
        e_loc = e // ep_size
        rank = dist.get_rank(axis_name)
        local = (eids // e_loc) == rank
        gates = gates * local  # zero the choices of other ranks' experts
        eids = torch.where(local, eids - rank * e_loc, 0)
        e = e_loc  # bucket over the local experts only
    flat_e = eids.reshape(-1)
    tok_of = torch.arange(t * k, device=x.device) // k
    cap = int(np.ceil(t_real * k / e * mo.capacity_factor))
    cap = max(4, cap + (-cap) % 4)
    sorted_cap = SORTED_CAP
    if par is not None and t_real * k >= SORTED_CAP and e * t_real * k < 2 ** 31:
        from repro_torch.parallel.dist_sort import DIST_MIN_TOTAL
        from repro_torch.parallel.sharding import dist_sort_axis

        if t_real * k >= DIST_MIN_TOTAL and dist_sort_axis(par, (t * k,)) is not None:
            sorted_cap = SORTED_CAP_SHARDED
    if mo.dispatch == "sorted" and t_real * k <= sorted_cap:
        pos = _positions_sorted(flat_e, e, par=par)
    else:
        pos = _positions_cumsum(flat_e, e)
    src = x[tok_of]
    if mo.expert_capacities is not None:
        caps = np.asarray(mo.expert_capacities, np.int64)
        if caps.shape != (e,):
            raise ValueError(f"expert_capacities of shape {caps.shape}, not ({e},)")
        starts = np.concatenate([[0], np.cumsum(caps)])
        total = int(starts[-1])
        fe = flat_e.long()
        keep = pos < torch.as_tensor(caps, device=x.device)[fe]
        dest = torch.where(keep, torch.as_tensor(starts[:-1], device=x.device)[fe] + pos,
                           total)
        buf = x.new_zeros((total + 1, d)).index_add_(0, dest, src)
        flat_out = torch.cat([_expert_ffn_csr(buf[:-1], p, caps, starts),
                              x.new_zeros((1, d))])
        y_choice = flat_out[dest]  # the spill row reads the zero pad
    else:
        keep = pos < cap
        dest = torch.where(keep, flat_e.long() * cap + pos, e * cap)
        buf = x.new_zeros((e * cap + 1, d)).index_add_(0, dest, src)[:-1].reshape(e, cap, d)
        if ep and not ep_psum:  # the buckets travel to their experts' owners and back
            out = _expert_a2a(_expert_ffn(_expert_a2a(buf, axis_name, True), p),
                              axis_name, False)
        else:
            out = _expert_ffn(buf, p)
        y_choice = out.reshape(e * cap, d)[dest.clamp(max=e * cap - 1)]
    w = (gates.reshape(-1) * keep).to(x.dtype)
    y = (y_choice * w[:, None]).reshape(t, k, d).sum(dim=1)
    if ep and ep_psum:
        from repro_torch.parallel.spmd import reduce_from

        y = reduce_from(y, axis_name)
    if mo.n_shared_experts:
        h = F.silu(dense(p["shared_wi"], x)) * dense(p["shared_wg"], x)
        y = y + dense(p["shared_wo"], h)
    return y


def _moe_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, rows: Optional[int], ctx):
    """:func:`moe_apply` of this rank's rows under ``ctx`` (a model call
    under ``par``), each leaf in the layout its spec gives it. Where the
    TP axis divides the experts they split over it (expert parallelism,
    the reference's ``shard_map``, ``moe.py:269-305``; ``par.ep_enabled``
    is required): ``wi`` / ``wg`` / ``wo`` by experts, the router by its
    expert columns, its logits all-gathered; where the sequence divides
    the axis each rank routes its block of it and the buckets travel by
    all_to_all, else every rank routes every token and one all-reduce
    sums the ranks' experts. Where the experts do not divide it every rank
    routes every token through every expert, the experts' width split
    over the axis where it divides (their spec's ``mlp``), one all-reduce
    of the output. The shared experts run on all the rank's tokens after
    it, their width split likewise."""
    b, s, d = x.shape
    par, mo = ctx.par, cfg.moe
    n_real = None if rows is None else rows * s
    if ctx.tp == 1:
        return moe_ffn_local(ctx.local(p), x.reshape(b * s, d), cfg,
                             n_real=n_real).reshape(b, s, d)
    routed = dataclasses.replace(cfg, moe=dataclasses.replace(mo, n_shared_experts=0))
    if not ctx.split(mo.n_experts):
        width = ctx.split(mo.d_expert)
        lp = ctx.local({k: p[k] for k in ("router", "wi", "wg", "wo")},
                       {"wi": 2, "wg": 2, "wo": 1} if width else None, inside=width)
        y = moe_ffn_local(lp, (ctx.copy_to(x) if width else x).reshape(b * s, d), routed,
                          n_real=n_real, par=par)
        y = (ctx.reduce_from(y) if width else y).reshape(b, s, d)
        return y + _shared_spmd(p, x, cfg, ctx) if mo.n_shared_experts else y
    if not par.ep_enabled:
        raise ValueError(f"{mo.n_experts} experts split over a TP axis of {ctx.tp} by their "
                         f"spec run under expert parallelism (make_parallelism(ep=True))")
    ep_size = ctx.tp
    seq_shardable = s % ep_size == 0 and s >= ep_size
    xb = ctx.copy_to(x)
    logits = ctx.gather_blocks(dense({"w": ctx.fetch(p["router"]["w"], 1)}, xb), -1)
    pb = {name: {"w": ctx.fetch(p[name]["w"], 0)} for name in ("wi", "wg", "wo")}
    if seq_shardable:
        sb = s // ep_size
        xb = xb[:, ctx.tp_rank * sb:(ctx.tp_rank + 1) * sb]
        logits = logits[:, ctx.tp_rank * sb:(ctx.tp_rank + 1) * sb]
    bb, sb = xb.shape[:2]
    y = moe_ffn_local(pb, xb.reshape(bb * sb, d), routed, axis_name=ctx.tp_group,
                      ep_size=ep_size, ep_psum=not seq_shardable,
                      n_real=None if seq_shardable else n_real,
                      logits=logits.reshape(bb * sb, -1)).reshape(bb, sb, d)
    if seq_shardable:
        y = ctx.gather_from(y, 1)
    return y + _shared_spmd(p, x, cfg, ctx) if mo.n_shared_experts else y


def _shared_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The shared experts of this rank's rows, their width split over the
    TP axis where it divides (column- then row-parallel, one all-reduce)."""
    b, s, d = x.shape
    width = ctx.split(cfg.moe.d_expert * cfg.moe.n_shared_experts)
    sp = ctx.local({k: p[k] for k in ("shared_wi", "shared_wg", "shared_wo")},
                   {"shared_wi": 1, "shared_wg": 1, "shared_wo": 0} if width else None,
                   inside=width)
    xf = (ctx.copy_to(x) if width else x).reshape(b * s, d)
    h = F.silu(dense(sp["shared_wi"], xf)) * dense(sp["shared_wg"], xf)
    y = dense(sp["shared_wo"], h)
    return (ctx.reduce_from(y) if width else y).reshape(b, s, d)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              rows: Optional[int] = None, par=None, ctx=None) -> torch.Tensor:
    """x (B, S, D): the tokens flattened B x S in order, as
    ``moe.py:277`` does (the right pads of a ragged prefill route and
    take capacity too). ``rows``: the real rows of a padded decode batch.
    With ``par.ep_enabled``: expert parallelism over ``par``'s TP axis
    (the module docstring), every rank passing and getting full arrays;
    without it ``par`` rides along for the sorted dispatch's sort.
    ``ctx``: a model call under ``par`` (:func:`_moe_spmd`), ``x`` this
    rank's rows."""
    if ctx is not None:
        return _moe_spmd(p, x, cfg, rows, ctx)
    b, s, d = x.shape
    if par is None or not par.ep_enabled:
        y = moe_ffn_local(p, x.reshape(b * s, d), cfg,
                          n_real=None if rows is None else rows * s, par=par)
        return y.reshape(b, s, d)
    if rows is not None:
        raise ValueError("a padded decode batch (rows=) is not taken under expert parallelism")
    if cfg.moe.n_experts % par.tp_size:
        raise ValueError(f"{cfg.moe.n_experts} experts do not split over an EP axis "
                         f"of {par.tp_size}")
    if cfg.moe.expert_capacities is not None:
        raise ValueError("expert_capacities is a non-EP feature: EP buckets travel as "
                         "dense (E, C, D) through all_to_all")
    from repro_torch.parallel.spmd import SpmdContext

    ctx = SpmdContext(par, b)
    y = _moe_spmd(p, ctx.rows(x), cfg, None, ctx)
    return par.dp_gather(y) if ctx.dp else y
