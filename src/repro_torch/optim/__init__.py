"""repro_torch.optim — AdamW with the warmup-cosine schedule and
global-norm clipping (counterpart of ``repro.optim``)."""
from .adamw import OptConfig, global_norm, opt_init, opt_update, schedule  # noqa: F401
