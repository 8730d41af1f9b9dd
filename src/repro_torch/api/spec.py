"""SortSpec: the static problem descriptor the dispatch layer plans from
(a copy of ``repro.api.spec``).

One frozen dataclass captures everything the planner needs to choose a
route for a call: operation, per-list lengths, batch, dtype (its name, as
``str(torch.float32)`` gives it without the ``torch.`` prefix), axis,
ordering and stability flags, payload presence, the caller's backend
hint, the device the route is planned for, and whether a usable TP
sharding was offered. ``device`` names ``"cuda"`` where the reference
says ``"tpu"``: the port plans every call for the card, and a CPU tensor
takes the same route through the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

OPS = ("merge", "merge_k", "sort", "topk", "median")

BACKEND_AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Static description of one sort/merge/top-k problem."""

    op: str  # 'merge' | 'merge_k' | 'sort' | 'topk' | 'median'
    lengths: Tuple[int, ...]  # per-input-list lengths along the sort axis
    batch: int = 1  # product of all non-sort dims
    dtype: str = "float32"
    k: Optional[int] = None  # top-k truncation, if any
    axis: int = -1  # caller's sort axis (pre-canonicalization)
    descending: bool = False
    stable: bool = False  # index-augmented tie-break requested
    has_payload: bool = False  # a pytree payload rides the permutation
    network: str = "loms"  # schedule family for the executor backend
    backend: str = BACKEND_AUTO  # caller hint: auto|schedule|pallas|...
    device: str = "cuda"  # the device the route is planned for
    sharded: bool = False  # a Parallelism with a usable TP axis was passed
    #: static CSR segment offsets, one tuple per input list (``None`` =
    #: dense rectangular problem). When set, the op applies *per segment*
    #: — ``sort`` sorts each segment independently, ``merge`` merges
    #: per-segment run pairs, ``topk`` truncates per segment — and the
    #: planner routes to the segmented backend's size-class buckets.
    #: Offsets are host constants: they size networks and launches.
    segment_offsets: Optional[Tuple[Tuple[int, ...], ...]] = None
    #: NaN ordering for float inputs. ``"last"`` (default): NaNs sort
    #: last, like ``torch.sort``, by the total-order int32 key the kernels
    #: encode on load. ``"unsafe"``: raw floats through the networks (not
    #: ported). Integer dtypes ignore it.
    nan_policy: str = "last"

    def __post_init__(self):
        assert self.op in OPS, f"unknown op {self.op!r}"
        assert self.lengths, "at least one input list required"
        assert self.nan_policy in ("last", "unsafe"), self.nan_policy
        if self.segment_offsets is not None:
            assert len(self.segment_offsets) == len(self.lengths), (
                "one offsets tuple per input list",
                self.segment_offsets, self.lengths)
            for offs, ln in zip(self.segment_offsets, self.lengths):
                assert offs and offs[0] == 0 and offs[-1] == ln, (offs, ln)

    @property
    def total(self) -> int:
        """Total element count along the sort axis."""
        return sum(self.lengths)

    @property
    def n_lists(self) -> int:
        return len(self.lengths)

    @property
    def needs_perm(self) -> bool:
        """True when the backend must hand back the input permutation
        (payload gathers and stable tie-breaks both consume it)."""
        return self.stable or self.has_payload

    @property
    def ragged2(self) -> bool:
        """2-way merge whose lengths defeat the hole-free kernel layout
        (no common column count >= 2 divides both lists). Divisor-based:
        (7, 7) or (12, 9) get a real column device (the paper's UP-7/DN-7
        shape class); only coprime-ish pairs like (7, 5) fall back."""
        if self.op != "merge" or len(self.lengths) != 2:
            return False
        import math

        return math.gcd(int(self.lengths[0]), int(self.lengths[1])) < 2

    @property
    def segmented(self) -> bool:
        """True when the problem is CSR ragged (per-segment semantics)."""
        return self.segment_offsets is not None

    @property
    def n_segments(self) -> int:
        return 0 if not self.segmented else len(self.segment_offsets[0]) - 1

    def describe(self) -> str:
        shape = "x".join(str(ln) for ln in self.lengths)
        extra = f" k={self.k}" if self.k is not None else ""
        seg = f" S={self.n_segments}" if self.segmented else ""
        return (f"{self.op}[{shape}]{extra}{seg} b={self.batch} "
                f"{self.dtype} ({self.device})")
