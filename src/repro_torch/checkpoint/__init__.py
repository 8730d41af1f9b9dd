"""repro_torch.checkpoint — async, atomic checkpoints in the reference's
layout (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointManager  # noqa: F401
