"""Architecture registry: the published configs + reduced smoke variants.

A copy of ``repro.configs.registry``. Every entry is exact at the listed
fields; smoke variants keep the family topology at toy width. The port's
model stack serves the dense family (``qwen3-8b`` is its full-width
model) and the MoE family (``qwen3-moe-30b-a3b``, and
``deepseek-v2-lite-16b`` with MLA); the other entries are kept so
``--arch`` names mean the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

DEEPSEEK_V2_LITE = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102_400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2,
                  first_dense_layers=1),
)

QWEN3_MOE_30B = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=6144, vocab_size=151_936, qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared_experts=0,
                  first_dense_layers=0),
)

MAMBA2_780M = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
)

INTERNVL2_26B = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16_384,
    vocab_size=92_553,
    frontend="patch", frontend_dim=3200, frontend_len=256,
)

QWEN15_32B = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27_392,
    vocab_size=152_064, qkv_bias=True, rope_theta=1_000_000.0,
)

CHATGLM3_6B = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13_696,
    vocab_size=65_024, rope_fraction=0.5,
)

DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19_200,
    vocab_size=32_256, rope_theta=100_000.0,
)

QWEN3_8B = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12_288, vocab_size=151_936, qk_norm=True, rope_theta=1_000_000.0,
)

ZAMBA2_2P7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10_240,
    vocab_size=32_000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    attn_every=6,
)

HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, mlp_act="gelu",
    frontend="frame", frontend_dim=512, frontend_len=0,
)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        DEEPSEEK_V2_LITE, QWEN3_MOE_30B, MAMBA2_780M, INTERNVL2_26B,
        QWEN15_32B, CHATGLM3_6B, DEEPSEEK_CODER_33B, QWEN3_8B,
        ZAMBA2_2P7B, HUBERT_XLARGE,
    )
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers, small vocab."""
    full = ARCHS[name]
    kw = dict(
        name=full.name + "-smoke",
        n_layers=min(full.n_layers, 2 if full.attn_every == 0 else 4),
        d_model=64,
        n_heads=4 if full.n_heads else 0,
        n_kv_heads=min(full.n_kv_heads, 2) if full.n_kv_heads else 0,
        d_head=16 if full.n_heads else None,
        d_ff=128 if full.d_ff else 0,
        vocab_size=503 if full.family == "audio" else 256,
        attn_chunk=32,
    )
    if full.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
        kw["d_head"] = None
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(
            full.moe, n_experts=8, top_k=2, d_expert=32, router_block=4,
            n_shared_experts=min(full.moe.n_shared_experts, 1))
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
    if full.attn_every:
        kw["attn_every"] = 2
    if full.frontend != "none":
        kw["frontend_dim"] = 32
        kw["frontend_len"] = 8 if full.frontend == "patch" else 0
    return dataclasses.replace(full, **kw)
