"""repro_torch.api — the port's public sorting-library entry points."""
from .ops import (segment_argmax, segment_merge, segment_sort,  # noqa: F401
                  segment_topk, topk, topk_block)
from .payload import stabilize_ties  # noqa: F401
