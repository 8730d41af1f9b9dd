"""repro_torch.streaming — sorted rows of any length merged at a fixed
tile (the grid merge, kernel row 9; the k-way tiles of kernel row 8) and
the planner that routes the library's merges and sorts, with its
autotune cache."""
from .chunked import chunked_merge, chunked_merge_k  # noqa: F401
from .grid_merge import grid_chunked_merge2, grid_chunked_merge2_plain  # noqa: F401
from .cache import AutotuneCache, default_cache, plan_key, set_default_cache  # noqa: F401
from .planner import (MergePlan, autotune_merge2, autotune_op,  # noqa: F401
                      autotune_segmented, autotune_sort, autotune_topk, fits_vmem,
                      kway_fits_vmem, plan_chunked, plan_chunked_k, plan_kway,
                      plan_merge2, plan_op, plan_segmented, plan_sort, plan_topk,
                      sort_fits_vmem)
