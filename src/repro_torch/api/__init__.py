"""repro_torch.api — the port's public sorting-library entry points."""
from .ops import topk, topk_block  # noqa: F401
