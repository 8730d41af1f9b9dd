"""Family registry: the only door the kernels use to obtain programs.

Counterpart of ``repro.networks.registry``. Kernels ask for a program by
family name, so the family that runs, and with it the tie order, is
chosen in one place, and the set of families stays open:
:func:`register_family` adds one, or replaces the family of a taken
name. ``kway_schedule`` / ``median_schedule`` route the k-way and median
Schedule builders (``repro_torch.core.loms``) through the same door, so
the kernel layer never imports ``core`` itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from .families import BUILTIN_FAMILIES, pick_merge_cols  # noqa: F401
from .program import MergeProgram, SortProgram

__all__ = ["NetworkFamily", "register_family", "builtin_family", "get_family",
           "family_names", "merge_program", "sort_program", "capable_families",
           "pick_merge_cols", "kway_schedule", "median_schedule"]


@dataclasses.dataclass(frozen=True)
class NetworkFamily:
    name: str
    merge: Callable[..., MergeProgram]  # (m, n, n_cols=None)
    sort: Callable[[int], SortProgram]  # (w), w a power of two
    merge_capable: Callable[[int, int], bool]
    sort_capable: Callable[[int], bool]


_REGISTRY = {name: NetworkFamily(name, m, s, mc, sc)
             for name, (m, s, mc, sc) in BUILTIN_FAMILIES.items()}


def register_family(fam: NetworkFamily) -> None:
    """Register ``fam`` under ``fam.name``: a new name adds a family (it
    joins ``capable_families``, and with it the autotune tournament), a
    taken one replaces that family. The programs the kernel wrappers keep
    on the card by family name are dropped, so the next call runs the new
    family's programs.

    The CUDA kernels run any program :func:`~.program.encode_program`
    encodes: a family whose levels use the IR's level kinds (columns, or
    pairs of ``xor`` / ``reflect`` / ``brick_odd`` stages) reaches the sort
    and the 2-way merge (rows 2 and 1), the class sort and merge (rows 6
    and 7), and, values only, the grid merge (row 9, whose card kernel
    merges by its own merge path and uses the family on the CPU only).
    The IR admits no other kind (``MergeProgram`` and ``PairStage``
    refuse one when built). The tiled and row-merge paths of rows 1 and 7
    implement the built-in ``loms`` and ``s2ms`` devices themselves, so
    they take only those names while they hold their built-in families
    (:func:`builtin_family`); every other family runs the program
    executor."""
    _REGISTRY[fam.name] = fam
    from repro_torch.kernels.launch import forget_family

    forget_family(fam.name)


def builtin_family(name: str) -> bool:
    """Whether ``name`` holds the built-in family of that name."""
    builtin = BUILTIN_FAMILIES.get(name)
    fam = _REGISTRY.get(name)
    return builtin is not None and fam is not None and (
        (fam.merge, fam.sort, fam.merge_capable, fam.sort_capable) == tuple(builtin))


def get_family(name: str) -> NetworkFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown network family {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


def family_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def merge_program(family: str, m: int, n: int,
                  n_cols: Optional[int] = None) -> MergeProgram:
    """The 2-run merge program of ``family`` at (m, n); ``n_cols``
    overrides the column count of the column-device families."""
    return get_family(family).merge(int(m), int(n), n_cols)


def sort_program(family: str, width: int) -> SortProgram:
    """The pow2-width merge-tree sort program of ``family``."""
    return get_family(family).sort(int(width))


def capable_families(op: str, lengths: Sequence[int]) -> Tuple[str, ...]:
    """Families (loms first) able to realise ``op`` at static lengths:
    ``'merge2'`` takes ``(m, n)``, ``'sort'`` takes ``(n,)`` and checks
    the padded pow2 width."""
    if op == "merge2":
        m, n = (int(x) for x in lengths)
        return tuple(f for f in _REGISTRY if _REGISTRY[f].merge_capable(m, n))
    if op == "sort":
        from repro_torch.kernels.common import ceil_pow2

        w = ceil_pow2(int(lengths[0]))
        return tuple(f for f in _REGISTRY if _REGISTRY[f].sort_capable(w))
    raise ValueError(f"capable_families: unknown op {op!r}")


def kway_schedule(lens: Sequence[int], n_stages: Optional[int] = None):
    """The k-way LOMS merge Schedule (the paper's Table 1 stage counts)."""
    from repro_torch.core import loms

    return loms.loms_kway(tuple(int(x) for x in lens), n_stages)


def median_schedule(lens: Sequence[int]):
    """(Schedule, median position) of the early-exit k-way median."""
    from repro_torch.core import loms

    return loms.loms_median(tuple(int(x) for x in lens))
