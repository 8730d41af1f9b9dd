"""Work counts from a configuration's shapes, and the chip's peaks.

A frozen copy of the arithmetic: the counts follow the model's
definition (its ``port`` block), not what the program happens to run, so
a change to the program cannot move them. A product of an (m, k) by a
(k, n) matrix is 2 m k n operations.

* A token runs through every weight of every layer it touches once: the
  attention projections, and the MLP (dense) or the router and its
  ``top_k`` experts (MoE); the embedding is a lookup, not a product.
* Causal attention: a query at position i meets i + 1 keys, 4 * head_dim
  operations a head for each (q.k and p.v).
* The output head runs once a token that is sampled: a prefill's last
  position and every decode step; a prefill's other positions need none.
* Pads (the right pads of a batched prefill) and a capacity's empty
  slots are not the model's work and are not counted.
"""
from __future__ import annotations

from typing import Iterable

#: NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core operations/s
PEAK_BF16_FLOPS = 989e12
#: its HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES_PER_S = 3.35e12


def layer_weights_per_token(cfg: dict) -> int:
    """The weights one token runs through in one layer."""
    d, h, hkv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    attn = d * (h + 2 * hkv) * hd + h * hd * d
    mo = cfg.get("moe")
    if mo:
        return attn + d * mo["n_experts"] + mo["top_k"] * 3 * d * mo["d_expert"]
    return attn + 3 * d * cfg["d_ff"]


def attention_flops(cfg: dict, keys: int) -> float:
    """One query against ``keys`` keys in every layer."""
    return 4.0 * cfg["d_head"] * cfg["n_heads"] * keys * cfg["n_layers"]


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, length: int) -> float:
    """A prompt of ``length`` tokens and its last position's logits."""
    return (2.0 * length * layer_weights_per_token(cfg) * cfg["n_layers"]
            + attention_flops(cfg, length * (length + 1) // 2) + head_flops(cfg))


def decode_flops(cfg: dict, keys: int) -> float:
    """One decode token that attends ``keys`` keys, and its logits."""
    return (2.0 * layer_weights_per_token(cfg) * cfg["n_layers"]
            + attention_flops(cfg, keys) + head_flops(cfg))


def step_flops(cfg: dict, prefills: Iterable[int], contexts: Iterable[int]) -> float:
    """A scheduler step's: the prompts it prefilled and the decode tokens
    it made, each given by the keys it attended."""
    return (sum(prefill_flops(cfg, n) for n in prefills)
            + sum(decode_flops(cfg, c) for c in contexts))


def topk_bytes(rows: int, width: int, itemsize: int, k: int) -> int:
    """The least a top-k must move: each row read once, its k values and
    int32 ids written once."""
    return rows * width * itemsize + rows * k * (itemsize + 4)
