"""repro_torch.models — the model stacks of the port: dense, MoE (GQA or
MLA), SSM, hybrid, and the vlm and audio frontends."""
from .convert import params_from_jax  # noqa: F401
from .model import (decode_step, forward, init_cache, loss_fn, model_init,  # noqa: F401
                    prefill)
