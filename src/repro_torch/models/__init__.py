"""repro_torch.models — the dense and MoE model stacks of the port."""
from .convert import params_from_jax  # noqa: F401
from .model import decode_step, forward, init_cache, model_init, prefill  # noqa: F401
