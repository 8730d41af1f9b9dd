"""repro_torch.api — the port's public sorting-library entry points."""
from .dispatch import plan  # noqa: F401
from .ops import (median_of_lists, merge, merge_k, segment_argmax,  # noqa: F401
                  segment_merge, segment_sort, segment_topk, sort, topk, topk_block)
from .payload import stabilize_ties  # noqa: F401
from .spec import SortSpec  # noqa: F401
