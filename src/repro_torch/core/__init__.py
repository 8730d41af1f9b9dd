"""repro_torch.core — the paper's devices as oblivious schedules (the
port's copy of ``repro.core``): setup arrays, the LOMS 2-way, k-way and
median builders, the MWMS baseline, and the schedule executors in numpy
(0-1 validation) and torch (the ``schedule`` route)."""
from .loms import loms_2way, loms_kway, loms_median, table1_stages  # noqa: F401
from .mwms import mwms_kway, mwms_median  # noqa: F401
from .networks import (  # noqa: F401
    Group,
    Schedule,
    Stage,
    apply_schedule,
    apply_schedule_np,
    apply_schedule_with_payload,
    comparator_count,
    depth,
    rank_merge_runs,
    rank_sort,
    validate_01_merge,
    validate_01_sort,
)
from .setup_array import SetupArray, build_2way_setup, build_kway_setup  # noqa: F401
