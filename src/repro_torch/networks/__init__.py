"""repro_torch.networks — the comparator-network layer of the port.

Family generators (LOMS column device, S2MS, 3-periodic, Batcher bitonic)
emit merge-step programs; :func:`merge_runs` / :func:`run_sort_program`
execute them in plain torch, and the CUDA class kernels run the same
programs from their int32 encoding (:func:`encode_program`).
"""
from .families import PERIODIC3_MAX_WIDTH, divisor_cols, pick_merge_cols  # noqa: F401
from .program import (MergeProgram, PairStage, SortProgram,  # noqa: F401
                      encode_program, merge_runs, program_to_schedule,
                      run_sort_program, s2ms_prefix, sort_program_to_schedule)
from .registry import (NetworkFamily, builtin_family, capable_families,  # noqa: F401
                       family_names, get_family, kway_schedule, median_schedule,
                       merge_program, register_family, sort_program)
