"""AdamW + warmup-cosine schedule + global-norm clipping (counterpart of
``repro.optim.adamw``).

The state mirrors the parameter tree (nested dicts and lists of
tensors): float32 moments ``mu`` and ``nu`` beside each parameter and an
int32 ``step``, as the reference's ``zeros_like`` of its float32 masters
makes them. The math is float32, in the reference's order of operations.
:func:`opt_update` writes the new parameters and moments into their
tensors in place, where the reference donates its buffers: the values
are the same, and the step holds no second copy of the state. The
step-dependent scalars (learning rate, clip scale, bias corrections) are
0-d tensors on the state's device, so a step never waits for the card.

Sharded leaves (DTensors, :func:`repro_torch.parallel.shard_params`):
the moments take the parameters' placements (the reference's dry-run
``opt_ps = {"mu": param_ps, "nu": param_ps, "step": P()}``), each rank
updates its own blocks with the same arithmetic, and :func:`global_norm`
is the norm over every element once, summed over the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def map_tree(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a tree; the containers are rebuilt."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def schedule(step, oc: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warmup,
    then cosine decay to ``min_lr_frac`` (``adamw.py:28``); float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                    0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return oc.lr * warm * cos


def opt_init(params: Any) -> dict:
    """Zero float32 moments shaped like ``params`` (placed as they are,
    for sharded leaves) and step 0 on their device."""
    from torch.distributed.tensor import DTensor

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. For sharded
    leaves each rank sums its blocks (a block held by several ranks
    counted once) and the sum is all-reduced over the mesh."""
    from torch.distributed.tensor import DTensor

    ts = leaves(tree)
    sharded = [t for t in ts if isinstance(t, DTensor)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in ts))
    from repro_torch.parallel.spmd import mesh_sum, sharded_sq_norm

    total = sum(sharded_sq_norm(t) for t in ts)
    return torch.sqrt(mesh_sum(total, sharded[0].device_mesh))


@torch.no_grad()
def opt_update(grads: Any, state: dict, params: Any, oc: OptConfig):
    """One AdamW step (``adamw.py:47``): clip the gradients to
    ``clip_norm`` by their global norm, update the moments, and step the
    parameters with the bias-corrected moments plus decoupled weight
    decay. ``params`` and ``state`` are updated in place and returned,
    with ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(step, oc)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(oc.b1, stepf)
    b2c = 1 - torch.pow(oc.b2, stepf)
    from torch.distributed.tensor import DTensor

    for g, m, v, p in zip(leaves(grads), leaves(state["mu"]), leaves(state["nu"]),
                          leaves(params)):
        if isinstance(p, DTensor):  # each rank its own blocks, the same arithmetic
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(placements=p.placements)
            g, m, v, p = (t.to_local() for t in (g, m, v, p))
        g = g.float() * scale
        m.mul_(oc.b1).add_((1 - oc.b1) * g)
        v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + oc.eps)
        pf = p.float()
        upd.add_(oc.weight_decay * pf)
        p.copy_(pf - lr * upd)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
