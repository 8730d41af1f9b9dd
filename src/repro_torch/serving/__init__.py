"""repro_torch.serving — batched generation and the top-k sampler."""
from .engine import ServeConfig, generate, make_serve_step  # noqa: F401
from .sample import sample_greedy, sample_topk, sample_topp  # noqa: F401
