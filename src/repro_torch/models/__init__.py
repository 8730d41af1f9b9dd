"""repro_torch.models — the model stacks of the port: dense, MoE (GQA or
MLA), SSM, hybrid, and the vlm and audio frontends."""
from .convert import opt_state_from_jax, params_from_jax  # noqa: F401
from .model import (cache_with_lengths, decode_step, forward, init_cache,  # noqa: F401
                    loss_fn, model_init, param_specs, prefill)
