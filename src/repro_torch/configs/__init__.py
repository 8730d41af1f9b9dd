"""repro_torch.configs — the published architectures as selectable configs."""
from .base import SHAPES, ModelConfig, ShapeConfig, get_shape  # noqa: F401
from .registry import ARCHS, QWEN3_8B, get_config, get_smoke_config  # noqa: F401
