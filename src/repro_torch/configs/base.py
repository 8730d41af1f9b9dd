"""Config system: one frozen dataclass tree per architecture.

A copy of ``repro.configs.base`` (the JAX package's), kept here so the
port never imports the JAX package. The fields and their meaning are the
same; the port's model stack runs every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408  # per-expert FFN hidden
    n_shared_experts: int = 0
    router_block: int = 32  # LOMS router top-k block size
    capacity_factor: float = 1.25
    dispatch: str = "scatter"  # scatter | sorted | einsum
    #: static per-expert capacities (len == n_experts); None = uniform
    expert_capacities: Optional[Tuple[int, ...]] = None
    moe_every: int = 1  # apply MoE FFN every Nth layer (1 = all)
    first_dense_layers: int = 1  # deepseek: first layer(s) dense


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # default d_model // n_heads
    # attention options
    causal: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm3: rope on half the head dims
    attn_chunk: int = 1024  # kv-chunked (flash-style) attention block
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared attention block every N ssm layers
    attn_every: int = 0
    # modality frontend stub: none | patch (vlm) | frame (audio)
    frontend: str = "none"
    frontend_dim: int = 0
    frontend_len: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"  # swiglu | gelu
    dtype: str = "bfloat16"
    # serving: KV-cache dtype override
    cache_dtype: "Optional[str]" = None
    # analysis only in the JAX package (python-unrolled layer scans); the
    # port's layer loop is always a Python loop
    unroll_layers: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token long-context shape?"""
        return self.family in ("ssm", "hybrid")

    def params_billions(self) -> float:
        """The rough parameter count in billions, the reference's
        (``base.py:108``): embeddings, attention (GQA or MLA), the FFN (every
        expert and shared expert of an MoE layer; a leading dense layer
        counted as MoE), the SSM mixer, and for a hybrid the SSM layers plus
        one shared attention block. A dense stack is exact."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0.0
        hd = self.head_dim
        if self.family != "ssm":
            if self.mla is not None:
                m = self.mla
                per_layer += d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        ff_mult = 3 if self.mlp_act == "swiglu" else 2
        if self.moe is not None:
            per_layer += ff_mult * d * self.moe.d_expert * (
                self.moe.n_experts + self.moe.n_shared_experts)
        elif self.d_ff:
            per_layer += ff_mult * d * self.d_ff
        if self.family == "ssm":
            per_layer = self._ssm_layer_params()
        total = emb + self.n_layers * per_layer
        if self.family == "hybrid":
            shared_attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
            shared_attn += ff_mult * d * self.d_ff
            total = emb + self.n_layers * self._ssm_layer_params() + shared_attn
        return total / 1e9

    def _ssm_layer_params(self) -> int:
        """The parameters of one SSM mixer layer."""
        s, d = self.ssm, self.d_model
        d_in = s.expand * d
        conv_dim = d_in + 2 * s.d_state
        return (d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim)
                + conv_dim * s.d_conv + d_in * d)

    def active_params_billions(self) -> float:
        """The parameters a token runs through, in billions (the
        reference's, ``base.py:159``): an MoE layer counts its routed top-k
        experts and its shared experts; any other stack all of its
        parameters."""
        if self.moe is None:
            return self.params_billions()
        d = self.d_model
        ff_mult = 3 if self.mlp_act == "swiglu" else 2
        full = self.params_billions()
        all_experts = ff_mult * d * self.moe.d_expert * self.moe.n_experts * self.n_layers / 1e9
        active = ff_mult * d * self.moe.d_expert * (
            self.moe.top_k + self.moe.n_shared_experts) * self.n_layers / 1e9
        return full - all_experts + active - (
            ff_mult * d * self.moe.d_expert * self.moe.n_shared_experts * self.n_layers / 1e9)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell's workload shape (``repro.configs.base.ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
