"""repro_torch.data — the deterministic token pipeline (counterpart of
``repro.data``)."""
from .pipeline import DataConfig, TokenPipeline  # noqa: F401
