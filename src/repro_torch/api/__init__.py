"""repro_torch.api — the port's public sorting-library entry points, the
backend registry and the planner."""
from .dispatch import (Decision, decision_table, measured_route_us, plan,  # noqa: F401
                       record_route_us)
from .fused import fused_enabled, set_fused_enabled  # noqa: F401
from .ops import (median_of_lists, merge, merge_k, segment_argmax,  # noqa: F401
                  segment_merge, segment_sort, segment_topk, sort, topk, topk_block)
from .payload import stabilize_ties  # noqa: F401
from .registry import Backend, backend_names, get_backend, register_backend  # noqa: F401
from .spec import SortSpec  # noqa: F401
