"""repro_torch.streaming — sorted rows of any length merged at a fixed
tile (the grid merge, kernel row 9; the k-way tiles of kernel row 8) and
the planner that routes the library's merges and sorts."""
from .chunked import chunked_merge, chunked_merge_k  # noqa: F401
from .grid_merge import grid_chunked_merge2, grid_chunked_merge2_plain  # noqa: F401
from .planner import (MergePlan, fits_vmem, kway_fits_vmem, plan_chunked,  # noqa: F401
                      plan_chunked_k, plan_kway, plan_merge2, plan_op, plan_sort,
                      sort_fits_vmem)
