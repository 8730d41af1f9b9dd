"""repro_torch.kernels — hand-written CUDA kernels and their plain versions."""
from .topk import (  # noqa: F401
    LAUNCHES,
    ROUTER_TOPK_MAX,
    reset_launch_counts,
    router_topk,
    vocab_topk,
)
