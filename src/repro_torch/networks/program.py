"""Merge-step program IR and its torch executors.

Counterpart of ``repro.networks.program``. A :class:`MergeProgram`
describes one oblivious 2-run merge: ``kind='columns'`` is the paper's
column device (``n_cols == 1``: the single-stage S2MS rank-merge;
``n_cols == C > 1``: C strided-column S2MS merges, then a rank-sort of
each row of C values), ``kind='pairs'`` a sequence of compare-exchange
:class:`PairStage`\\ s over the concatenated runs (optionally with the hi
run reversed on entry). A :class:`SortProgram` is a pow2 merge tree of
such programs. The family generators (:mod:`.families`) build them; the
kernels take them through :mod:`.registry`.

The executors here are the plain versions the CUDA kernels are held
against: the same comparisons and permutes as the reference's ``jnp``
executors, the exact scatter permute or, with ``use_mxu`` (raw floats),
the rule of the reference's one-hot matrix permute
(``kernels/common.onehot_permute``). Only the ``columns``/``n_cols == 1`` program is a
stable merge (lo wins ties); column devices and pair networks make no
cross-run tie-order promise, so their callers resolve validity by mask.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.common import merge2_sorted, sort_nsorter

__all__ = ["PairStage", "MergeProgram", "SortProgram", "merge_runs",
           "run_sort_program", "s2ms_prefix", "encode_program"]

_PAIR_KINDS = {"xor": 0, "reflect": 1, "brick_odd": 2}


@dataclasses.dataclass(frozen=True)
class PairStage:
    """One compare-exchange stage over a working vector of length L (the
    min lands on the lower lane): ``xor`` pairs lanes i and i+d for
    i mod 2d < d; ``reflect`` pairs i and L-1-i; ``brick_odd`` pairs
    (1,2), (3,4), ... (L-3, L-2)."""

    kind: str
    d: int = 1

    def __post_init__(self):
        assert self.kind in _PAIR_KINDS, self.kind
        assert self.d >= 1


@dataclasses.dataclass(frozen=True)
class MergeProgram:
    """A lowered 2-run merge ``(m, n) -> m + n`` along the last axis."""

    family: str
    m: int
    n: int
    kind: str  # 'columns' | 'pairs'
    n_cols: int = 1
    reverse_hi: bool = False
    stages: Tuple[PairStage, ...] = ()

    def __post_init__(self):
        assert self.kind in ("columns", "pairs"), self.kind
        if self.kind == "columns" and self.n_cols > 1:
            assert self.m % self.n_cols == 0 and self.n % self.n_cols == 0, (
                self.m, self.n, self.n_cols)

    @property
    def total(self) -> int:
        return self.m + self.n


@dataclasses.dataclass(frozen=True)
class SortProgram:
    """A pow2-width merge-tree sort: ``levels[i]`` merges run pairs of
    length ``2**i``."""

    family: str
    width: int
    levels: Tuple[MergeProgram, ...] = ()

    def __post_init__(self):
        run = 1
        for mp in self.levels:
            assert mp.m == run and mp.n == run, (mp.m, mp.n, run)
            run *= 2
        assert run == max(self.width, 1), (self.width, len(self.levels))


# ---------------------------------------------------------------------------
# executors (plain torch on the last axis)
# ---------------------------------------------------------------------------


def _xor_exchange(x, p, d: int):
    """Compare-exchange lanes (i, i+d), i mod 2d < d, on the last axis."""
    lead, L = x.shape[:-1], x.shape[-1]
    y = x.reshape(lead + (L // (2 * d), 2, d))
    a, b = y[..., 0, :], y[..., 1, :]
    swap = a > b
    out = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                      dim=-2).reshape(lead + (L,))
    if p is None:
        return out, None
    q = p.reshape(lead + (L // (2 * d), 2, d))
    pa, pb = q[..., 0, :], q[..., 1, :]
    pout = torch.stack([torch.where(swap, pb, pa), torch.where(swap, pa, pb)],
                       dim=-2).reshape(lead + (L,))
    return out, pout


def _apply_pair_stage(st: PairStage, x, p):
    L = x.shape[-1]
    if st.kind == "xor":
        return _xor_exchange(x, p, st.d)
    if st.kind == "reflect":
        # both halves evaluate the same strict comparison, so the swap
        # mask is consistent under ties
        r = x.flip(-1)
        left = torch.arange(L, device=x.device) < (L // 2)
        swap = torch.where(left, x > r, r > x)
        out = torch.where(swap, r, x)
        return out, (None if p is None else torch.where(swap, p.flip(-1), p))
    if L <= 2:  # brick_odd
        return x, p
    mid, pm = _xor_exchange(x[..., 1:L - 1], None if p is None else p[..., 1:L - 1], 1)
    out = torch.cat([x[..., :1], mid, x[..., L - 1:]], dim=-1)
    if p is None:
        return out, None
    return out, torch.cat([p[..., :1], pm, p[..., L - 1:]], dim=-1)


def _columns(x: torch.Tensor, c_: int) -> torch.Tensor:
    """``(..., L) -> (..., C, L/C)``: column c holds ``x[..., c::C]``."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // c_, c_)).transpose(-1, -2)


def _merge_columns(prog: MergeProgram, lo, hi, payload, use_mxu: bool):
    """The UP-m/DN-n column device: column c merges ``hi[(C-1-c)%C::C]``
    (first, so it wins ties) with ``lo[c::C]``; stage 2 rank-sorts each
    row of C values. The C column merges run as one batched merge (each
    column its own permuted vector, as in the reference)."""
    m, n, c_ = prog.m, prog.n, prog.n_cols
    if c_ <= 1 or m % c_ or n % c_:
        return merge2_sorted(lo, hi, payload=payload, use_mxu=use_mxu)
    # column c of hi is hi[(C-1-c)::C]: the columns in reverse order
    av, bv = _columns(lo, c_), _columns(hi, c_).flip(-2)
    shape = lo.shape[:-1] + (m + n,)
    if payload is not None:
        plo, phi = payload
        col, pcol = merge2_sorted(bv, av, payload=(_columns(phi, c_).flip(-2),
                                                   _columns(plo, c_)), use_mxu=use_mxu)
        arr, parr = sort_nsorter(col.transpose(-1, -2), pcol.transpose(-1, -2),
                                 use_mxu=use_mxu)
        return arr.reshape(shape), parr.reshape(shape)
    col = merge2_sorted(bv, av, use_mxu=use_mxu)
    return sort_nsorter(col.transpose(-1, -2), use_mxu=use_mxu).reshape(shape)


def _merge_pairs(prog: MergeProgram, lo, hi, payload):
    x = torch.cat([lo, hi.flip(-1) if prog.reverse_hi else hi], dim=-1)
    p = None
    if payload is not None:
        plo, phi = payload
        p = torch.cat([plo, phi.flip(-1) if prog.reverse_hi else phi], dim=-1)
    for st in prog.stages:
        x, p = _apply_pair_stage(st, x, p)
    return (x, p) if payload is not None else x


def merge_runs(prog: MergeProgram, lo: torch.Tensor, hi: torch.Tensor, *,
               payload: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               use_mxu: bool = False):
    """Execute one merge program on ascending runs ``lo``/``hi`` (last
    axis). With ``payload=(plo, phi)`` returns ``(vals, pvals)``.
    ``use_mxu``: raw floats, permuted by the one-hot rule (the pair
    stages move values exactly either way)."""
    assert lo.shape[-1] == prog.m and hi.shape[-1] == prog.n, (
        lo.shape, hi.shape, prog)
    if prog.kind == "columns":
        return _merge_columns(prog, lo, hi, payload, use_mxu)
    return _merge_pairs(prog, lo, hi, payload)


def run_sort_program(prog: SortProgram, keys: torch.Tensor,
                     pos: Optional[torch.Tensor], use_mxu: bool = False,
                     first_level: int = 0):
    """The merge-tree sort over pow2-width ``(bt, w)`` rows, optionally
    carrying an int32 position lane through every permute, from level
    ``first_level`` on (the rows' runs of ``2**first_level`` already
    sorted). Returns ``(keys, pos)``."""
    bt, w = keys.shape[0], prog.width
    assert keys.shape[-1] == w, (keys.shape, w)
    for mp in prog.levels[first_level:]:
        run = mp.m
        g = w // (2 * run)
        kv = keys.reshape(bt, g, 2 * run)
        if pos is not None:
            pv = pos.reshape(bt, g, 2 * run)
            kv, pv = merge_runs(mp, kv[..., :run], kv[..., run:],
                                payload=(pv[..., :run], pv[..., run:]), use_mxu=use_mxu)
            pos = pv.reshape(bt, w)
        else:
            kv = merge_runs(mp, kv[..., :run], kv[..., run:], use_mxu=use_mxu)
        keys = kv.reshape(bt, w)
    return keys, pos


def s2ms_prefix(prog: SortProgram) -> int:
    """How many levels at the bottom of ``prog`` are S2MS merges
    (``columns`` with ``n_cols <= 1``). Positions start as the lane
    index and an S2MS level lets lo win ties while every lo position is
    below every hi position, so after these levels each group of
    ``2**prefix`` lanes is sorted by the unique pair (key, position):
    any correct sort of that pair gives the same bits."""
    j = 0
    for mp in prog.levels:
        if mp.kind != "columns" or mp.n_cols > 1:
            break
        j += 1
    return j


def encode_program(levels) -> List[int]:
    """Flatten merge programs into the int32 words the CUDA class kernels
    read: ``[n_levels]`` then per level ``[m, n, kind (0 columns, 1
    pairs), n_cols, reverse_hi, n_stages, (stage kind, d) * n_stages]``."""
    words = [len(levels)]
    for mp in levels:
        words += [mp.m, mp.n, 0 if mp.kind == "columns" else 1,
                  mp.n_cols if mp.kind == "columns" else 1,
                  int(mp.reverse_hi), len(mp.stages)]
        for st in mp.stages:
            words += [_PAIR_KINDS[st.kind], st.d]
    return words


# ---------------------------------------------------------------------------
# Lifting back into the validated Schedule IR (for 0-1 checks / metrics)
# ---------------------------------------------------------------------------


def _pair_stage_to_groups(st: PairStage, L: int):
    from repro_torch.core.networks import Group

    if st.kind == "xor":
        return tuple(
            Group(idx=(base + k, base + k + st.d))
            for base in range(0, L, 2 * st.d) for k in range(st.d))
    if st.kind == "reflect":
        return tuple(Group(idx=(i, L - 1 - i)) for i in range(L // 2))
    return tuple(Group(idx=(i, i + 1)) for i in range(1, L - 2, 2))


def program_to_schedule(mp: MergeProgram):
    """Lift a merge program into a ``core.networks.Schedule`` so the
    0-1-principle validators and depth/comparator metrics apply."""
    from repro_torch.core.networks import Group, Schedule, Stage

    m, n, size = mp.m, mp.n, mp.total
    ident = tuple(range(size))
    name = f"{mp.family}_merge_{m}x{n}"
    meta = (("family", mp.family), ("kind", mp.kind))
    if mp.kind == "columns":
        if mp.n_cols > 1:
            from repro_torch.core.loms import loms_2way

            return loms_2way(m, n, n_cols=mp.n_cols)
        runs = tuple(r for r in (m, n) if r > 0)
        group = Group(idx=ident, runs=runs if len(runs) > 1 else None)
        return Schedule(name=name, size=size, setup_scatter=ident,
                        output_gather=ident,
                        stages=(Stage(groups=(group,)),), meta=meta)
    setup = list(ident)
    if mp.reverse_hi:
        for j in range(n):
            setup[m + j] = m + (n - 1 - j)
    stages = tuple(
        Stage(groups=groups)
        for groups in (_pair_stage_to_groups(st, size) for st in mp.stages)
        if groups)
    return Schedule(name=name, size=size, setup_scatter=tuple(setup),
                    output_gather=ident, stages=stages, meta=meta)


def sort_program_to_schedule(prog: SortProgram):
    """Compose a sort program's levels into one merge-tree ``Schedule``.

    Only levels that are depth-1 group merges on the identity layout
    (``columns`` with ``n_cols == 1``) compose without inter-level
    permutations; programs with column-device or pair levels raise —
    validate those per-level via :func:`program_to_schedule` plus an
    executor-level exhaustive 0-1 sweep instead."""
    from repro_torch.core.networks import Group, Schedule, Stage

    w = prog.width
    stages = []
    for mp in prog.levels:
        if mp.kind != "columns" or mp.n_cols > 1:
            raise ValueError(
                f"level {mp.m}x{mp.n} of {prog.family} is not a "
                "composable depth-1 merge")
        run = mp.m
        stages.append(Stage(groups=tuple(
            Group(idx=tuple(range(b, b + 2 * run)), runs=(run, run))
            for b in range(0, w, 2 * run))))
    ident = tuple(range(w))
    return Schedule(name=f"{prog.family}_sort_{w}", size=w,
                    setup_scatter=ident, output_gather=ident,
                    stages=tuple(stages), meta=(("family", prog.family),))
