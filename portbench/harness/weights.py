"""Random weights of a configuration, drawn on the device from the seed.

One flat buffer in the serving type is filled with standard normals by a
``torch.Generator`` on the device, a gigaelement at a time; every weight
is a view of it scaled in place to its standard deviation (the
embedding 0.02, a product's weight 1/sqrt(fan-in)); the norm scales are
ones. The tree has the layout the port's ``model_init`` returns, so the
program takes it as it is, and the plain reference reads the same
tensors.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

CHUNK = 1 << 30  # elements a draw


def _layout(cfg: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, std) of every leaf; std 0 marks a norm scale (ones)."""
    d, h, hkv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    v = cfg["vocab_size"]
    out = [(("embed", "emb"), (v, d), 0.02)]
    for i in range(cfg["n_layers"]):
        at = ("stack", "body", i)
        out += [(at + ("ln1", "scale"), (d,), 0.0),
                (at + ("attn", "wq", "w"), (d, h, hd), d ** -0.5),
                (at + ("attn", "wk", "w"), (d, hkv, hd), d ** -0.5),
                (at + ("attn", "wv", "w"), (d, hkv, hd), d ** -0.5),
                (at + ("attn", "wo", "w"), (h * hd, d), (h * hd) ** -0.5),
                (at + ("ln2", "scale"), (d,), 0.0)]
        if cfg.get("qk_norm"):
            out += [(at + ("attn", "qn", "scale"), (hd,), 0.0),
                    (at + ("attn", "kn", "scale"), (hd,), 0.0)]
        mo = cfg.get("moe")
        if mo:
            e, f = mo["n_experts"], mo["d_expert"]
            out += [(at + ("ffn", "router", "w"), (d, e), d ** -0.5),
                    (at + ("ffn", "wi", "w"), (e, d, f), d ** -0.5),
                    (at + ("ffn", "wg", "w"), (e, d, f), d ** -0.5),
                    (at + ("ffn", "wo", "w"), (e, f, d), f ** -0.5)]
        else:
            f = cfg["d_ff"]
            out += [(at + ("ffn", "wi", "w"), (d, f), d ** -0.5),
                    (at + ("ffn", "wg", "w"), (d, f), d ** -0.5),
                    (at + ("ffn", "wo", "w"), (f, d), f ** -0.5)]
    out += [(("final_norm", "scale"), (d,), 0.0), (("lm_head", "w"), (d, v), d ** -0.5)]
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in _layout(cfg))


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``cfg`` (a configuration's ``port`` block) from
    ``seed``, on ``device``, in ``dtype``."""
    layout = _layout(cfg)
    total = sum(math.prod(shape) for _, shape, _ in layout)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, shape, std in layout:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if std:
            leaf.mul_(std)
        else:
            leaf.fill_(1.0)
        _put(tree, path, leaf)
    return tree


def _put(root: dict, path: tuple, leaf: torch.Tensor) -> None:
    """Set ``leaf`` at ``path`` of ``root`` (a list index makes the list
    grow to it)."""
    node = root
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        elif isinstance(nxt, int):
            node = node.setdefault(key, [])
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = leaf
