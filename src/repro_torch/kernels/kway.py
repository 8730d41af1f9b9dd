"""The schedule-driven k-way List Offset merge (kernel row 8).

Counterpart of ``repro.kernels.kway``: :func:`kway_merge` replaces
``kway_merge_pallas`` (``_kway_kernel``, ``src/repro/kernels/kway.py:70``).
It runs any :class:`~repro_torch.core.networks.Schedule` (the k-way LOMS
merge, the early-exit median, mixed list sizes, the MWMS baseline) on
(B, n_inputs) rows, each row the concatenation of the sorted lists:

  descending: each list segment reversed on load (``lens``), positions
  still indexing the original concatenation -> floats: the total-order
  int32 key (``key_dtype``) -> scatter into the working vector at
  ``setup_scatter`` (holes zero) -> per stage and class of equal groups:
  take the group's cells, rank them (a stable N-sorter rank, or the S2MS
  rank of a multi-run group: own index plus each other run's count of
  values ``<=`` (earlier run) or ``<`` (later run)), permute values and
  the position lane, write back -> gather at ``output_gather`` -> keys
  decoded -> descending: output and positions reversed -> payload lanes
  (B, n_inputs[, F]) gathered at the positions from the raw input.

A CUDA tensor goes to ``kway_merge_kernel`` (``csrc/kway.cu``) or raises;
a CPU tensor runs :func:`kway_merge_plain`, the reference's kernel body in
torch ops. ``use_mxu`` is the reference's raw-float mode (float rows
without ``key_dtype``): raw float ranks and the rule of the one-hot
matrix permute (``common.onehot_permute``) for every group. The kernel
reads the schedule as int32 wiring words on the card
(:func:`wiring_tensor`), encoded once per schedule; the descending
reversal is folded into them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.networks import Schedule, _apply_stage, _run_ranks, _stage_classes
from .common import (canonical_nan, check_mode, decode_key_values, encode_key_values,
                     gather_lanes, onehot_permute, ranks_sort, scatter_permute)
from .launch import (KEY_CODE, check_rc, cuda_checks, empty_payloads, library,
                     payload_args, stream)
from .topk import LAUNCHES

Result = Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[torch.Tensor, ...]]

#: working-vector cells a CTA holds in shared memory (16 B a cell: keys,
#: positions and their second buffers, of the 232,448 B a CTA may opt in
#: to; the raw-float mode 24 B, with its landed-bad counts and vector flags)
MAX_SIZE = {False: 232_448 // 16, True: 232_448 // 24}


def _stages(sched: Schedule, n_stages: Optional[int]):
    return sched.stages if n_stages is None else sched.stages[:n_stages]


def _source_order(n_in: int, lens: Optional[Sequence[int]], descending: bool) -> np.ndarray:
    """For each position of the ascending problem, the position in the
    input it is read from: each list segment reversed when descending."""
    src = np.arange(n_in)
    if descending:
        offs = np.cumsum((0,) + tuple(lens))
        src = np.concatenate([src[offs[j]:offs[j + 1]][::-1] for j in range(len(lens))])
    return src


def _check(x, sched, payloads, lens, key_dtype, descending, use_mxu):
    if x.ndim != 2 or x.shape[1] != sched.n_inputs:
        raise ValueError(f"the schedule {sched.name} takes (B, {sched.n_inputs}) rows, "
                         f"got {tuple(x.shape)}")
    check_mode(x.dtype, key_dtype, use_mxu, len(payloads))
    if descending and (lens is None or sum(lens) != x.shape[1]):
        raise ValueError(f"descending needs the list lengths: lens={lens}, "
                         f"{x.shape[1]} inputs")
    for p in payloads:
        if p.ndim not in (2, 3) or p.shape[:2] != x.shape:
            raise ValueError(f"payload lane of shape {tuple(p.shape)} does not match "
                             f"{tuple(x.shape)}[, F]")


_PLAIN_INDEX: Dict[tuple, tuple] = {}


def _plain_index(device, sched: Schedule, n_stages, lens, descending):
    """The plain version's index tensors on ``device``, made once (so that
    a CUDA-graph capture of it copies nothing from the host): the input
    order, the setup scatter, each class's cells and the output gather."""
    key = (id(sched), n_stages, tuple(lens) if descending else None, descending,
           str(device))
    hit = _PLAIN_INDEX.get(key)
    if hit is None:
        def idx(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long).to(device)

        classes = tuple((runs, idx(i.reshape(-1)), i.shape)
                        for st in _stages(sched, n_stages) for _, runs, i in _stage_classes(st))
        hit = (sched, idx(_source_order(sched.n_inputs, lens, descending)),
               idx(sched.setup_scatter), classes, idx(sched.output_gather))
        _PLAIN_INDEX[key] = hit
    return hit[1:]


def kway_merge_plain(x: torch.Tensor, sched: Schedule, payloads: Sequence[torch.Tensor] = (),
                     *, n_stages: Optional[int] = None,
                     lens: Optional[Sequence[int]] = None,
                     key_dtype: Optional[torch.dtype] = None, descending: bool = False,
                     want_perm: bool = False, use_mxu: bool = False) -> Result:
    """Plain version of ``_kway_kernel`` (``kway.py:70``)."""
    bt, n_in = x.shape
    need_pos = bool(payloads) or want_perm
    src, setup, classes, gather = _plain_index(x.device, sched, n_stages, lens, descending)
    x = x[:, src]
    if key_dtype is not None:
        x = encode_key_values(x)
    w = torch.zeros((bt, sched.size), dtype=x.dtype, device=x.device)
    w[:, setup] = x
    permute = onehot_permute if use_mxu else scatter_permute
    wp = None
    if need_pos:
        wp = torch.zeros((bt, sched.size), dtype=torch.int32, device=x.device)
        wp[:, setup] = src.to(torch.int32).expand(bt, n_in)
    for runs, flat, shape in classes:
        vals = w[:, flat].reshape((bt,) + shape)
        rank = ranks_sort(vals) if runs is None else _run_ranks(vals, runs)
        if need_pos:
            pvals = wp[:, flat].reshape((bt,) + shape)
            vals, pvals = permute(vals, rank, pvals)
            wp[:, flat] = pvals.reshape(bt, -1)
        else:
            vals = permute(vals, rank)
        w[:, flat] = vals.reshape(bt, -1)
    out = w[:, gather]
    perm = wp[:, gather] if need_pos else None
    if key_dtype is not None:
        out = decode_key_values(out, key_dtype)
    if descending:
        out = out.flip(-1)
        perm = None if perm is None else perm.flip(-1)
    if use_mxu:  # the kernel's NaN (torch's CPU ops rewrite bf16 NaN bits)
        out = canonical_nan(out)
    pouts = tuple(gather_lanes(perm, p) for p in payloads)
    return out, (perm if want_perm else None), pouts


# ---------------------------------------------------------------------------
# the wiring on the card and the CUDA wrapper
# ---------------------------------------------------------------------------

#: schedule id -> (the schedule, its wiring words on a device, whether
#: they hold a warp class)
_WIRING: Dict[tuple, Tuple[Schedule, torch.Tensor, bool]] = {}
#: schedule id -> (the schedule, its two-chain classes)
_CHAINS: Dict[int, tuple] = {}


#: the executors of a class in ``csrc/kway.cu`` (the wiring's ``exec``
#: word): a counted stable rank a cell; a binary search of each other run
#: a cell; a register sort of the (key, index) pairs by one thread; by a
#: warp; by a warp that merges the group's two chains (its even and its
#: odd cells) where a vote finds both sorted, and sorts them otherwise
E_RANK, E_SEARCH, E_THREAD, E_WARP, E_MERGE = range(5)
#: widest group a thread (E_THREAD) and a warp (E_WARP, E_MERGE) sort
THREAD_MAX, WARP_MAX = 8, 128
#: cells of the schedules the kernel runs a thread a row (no warp sorts)
ROW_MAX = 64


def executor(n: int, runs: Optional[Sequence[int]], size: int, raw: bool = False,
             chains: bool = False) -> int:
    """The executor of a class of groups of n cells in a schedule of
    ``size`` cells: any group of at most 8 cells by one thread (an S2MS
    group's runs checked sorted first, else searched); a wider N-sorter
    (no runs) of at most 128 cells by a warp (schedules past ``ROW_MAX``
    cells), merging two chains where ``chains`` (the group's even and odd
    cells, in idx order, came sorted on the probe of
    :func:`two_chain_classes`), the others counted; a wider S2MS group
    (runs) whose runs share one power-of-two length, up to 128 cells, by a
    warp from the level above its runs (schedules past ``ROW_MAX``), any
    other by binary searches. The raw-float mode counts every class
    (E_RANK, E_SEARCH)."""
    if not raw and n <= THREAD_MAX:
        return E_THREAD
    warp = not raw and size > ROW_MAX and THREAD_MAX < n <= WARP_MAX
    if runs is None:
        return (E_MERGE if chains else E_WARP) if warp else E_RANK
    r = runs[0]
    if warp and (r & (r - 1)) == 0 and all(x == r for x in runs):
        return E_WARP
    return E_SEARCH


def two_chain_classes(sched: Schedule, n_stages: Optional[int] = None) -> set:
    """(stage, class) of the N-sorter classes of 9 to 128 cells whose
    every group, before its stage, held its even cells and its odd cells
    (in idx order) each non-decreasing on a probe: 256 rows of sorted
    lists of small, heavily tied integers (``meta['lens']``). In a LOMS
    merge the column stages after a serpentine row stage are such groups
    (sorting rows keeps the rows of one direction sorted down a column).
    A hint only: the kernel votes on the loaded pairs and sorts them fully
    where the chains are not sorted."""
    hit = _CHAINS.get(id(sched))
    if hit is None:
        hit = (sched, _probe_chains(sched))
        _CHAINS[id(sched)] = hit
    n = len(sched.stages) if n_stages is None else n_stages
    return {(si, ci) for si, ci in hit[1] if si < n}


def _probe_chains(sched: Schedule) -> set:
    lens = sched.meta_dict().get("lens")
    if lens is None or sched.size <= ROW_MAX:
        return set()
    rng = np.random.default_rng(0)
    hi = np.repeat([2, 8, 64, 1 << 20], 64)[:, None]
    x = np.concatenate([np.sort(rng.integers(0, hi, (256, n)), axis=1) for n in lens], axis=1)
    w = torch.zeros((256, sched.size), dtype=torch.int64)
    w[:, torch.as_tensor(sched.setup_scatter)] = torch.from_numpy(x)
    found = set()
    for si, st in enumerate(sched.stages):
        for ci, (n, runs, idx) in enumerate(_stage_classes(st)):
            if runs is None and THREAD_MAX < n <= WARP_MAX:
                v = w[:, torch.from_numpy(idx.astype(np.int64))]
                if all(bool((c[..., 1:] >= c[..., :-1]).all()) for c in (v[..., 0::2],
                                                                          v[..., 1::2])):
                    found.add((si, ci))
        w, _ = _apply_stage(st, w, None)
    return found


def _warp_lanes(n: int) -> int:
    """32 x the pairs a lane of the warp sort of n cells holds."""
    return 32 * (1 if n <= 32 else 2 if n <= 64 else 4)


def class_layout(idx: np.ndarray, ex: int) -> np.ndarray:
    """A class's (G, n) cells in the order the kernel reads them: E_THREAD
    transposed (cell q of group g at q * G + g, so a warp's threads, on
    consecutive groups, read consecutive words); E_WARP and E_MERGE
    lane-major (cell i of a group at (i % ER) * 32 + i // ER of its 32 * ER
    words, ER the pairs a lane holds); the others as they are."""
    ng, n = idx.shape
    if ex == E_THREAD:
        return idx.T.reshape(-1)
    if ex in (E_WARP, E_MERGE):
        s = _warp_lanes(n)
        er, i = s // 32, np.arange(n)
        out = np.zeros((ng, s), dtype=idx.dtype)
        out[:, (i % er) * 32 + i // er] = idx
        return out.reshape(-1)
    return idx.reshape(-1)


def encode_wiring(sched: Schedule, n_stages: Optional[int] = None,
                  lens: Optional[Sequence[int]] = None,
                  descending: bool = False, raw: bool = False) -> np.ndarray:
    """The int32 words ``csrc/kway.cu`` reads, in order:

      [size, n_inputs, n_outputs, n_stages]
      src[size]: the input position each cell loads (-1: a hole), the
        descending reversal folded in
      per stage: [n_classes, n_pass] pass[n_pass] (the cells no group of
        the stage holds), then per class (``_stage_classes`` order):
        [G, n, exec, n_runs, runs[n_runs]] cells (n_runs 0: a rank sort;
        exec: :func:`executor`; the cells in :func:`class_layout`'s order)
      gather[n_outputs]: the cell each output reads (reversed when
        descending)

    ``raw``: the raw-float mode's words (every class counted, the cells as
    they are)."""
    n_in = sched.n_inputs
    src = np.full(sched.size, -1, dtype=np.int64)
    src[np.asarray(sched.setup_scatter)] = _source_order(n_in, lens, descending)
    stages = _stages(sched, n_stages)
    chains = set() if raw else two_chain_classes(sched, n_stages)
    words = [np.array([sched.size, n_in, sched.n_outputs, len(stages)]), src]
    for si, st in enumerate(stages):
        classes = _stage_classes(st)
        held = np.zeros(sched.size, dtype=bool)
        for _, _, idx in classes:
            held[idx.reshape(-1)] = True
        passed = np.flatnonzero(~held)
        words.append(np.array([len(classes), len(passed)]))
        words.append(passed)
        for ci, (n, runs, idx) in enumerate(classes):
            ex = executor(n, runs, sched.size, raw, (si, ci) in chains)
            words.append(np.array([idx.shape[0], n, ex, len(runs or ()), *(runs or ())]))
            words.append(class_layout(idx, ex))
    gather = np.asarray(sched.output_gather)
    words.append(gather[::-1] if descending else gather)
    return np.concatenate(words).astype(np.int32)


def wiring_tensor(device, sched: Schedule, n_stages: Optional[int] = None,
                  lens: Optional[Sequence[int]] = None, descending: bool = False,
                  raw: bool = False) -> Tuple[torch.Tensor, bool]:
    """The wiring words of one schedule on ``device``, copied there once,
    and whether they hold a warp class (the kernel's build to launch).
    Keyed by the schedule's identity; the cache holds the schedule, so
    its id stays its own."""
    key = (id(sched), n_stages, tuple(lens) if descending else None, descending, raw,
           str(device))
    hit = _WIRING.get(key)
    if hit is None:
        words = encode_wiring(sched, n_stages, lens, descending, raw)
        hit = (sched, torch.from_numpy(words).to(device), _has_warp_classes(words))
        _WIRING[key] = hit
    return hit[1], hit[2]


def _has_warp_classes(words: np.ndarray) -> bool:
    """Whether the wiring holds an E_WARP or E_MERGE class (the classes
    before the first such one are ng * n words each)."""
    size, n_st = int(words[0]), int(words[3])
    o = 4 + size
    for _ in range(n_st):
        n_cls, n_pass = int(words[o]), int(words[o + 1])
        o += 2 + n_pass
        for _ in range(n_cls):
            ng, n, ex, nr = (int(w) for w in words[o:o + 4])
            if ex in (E_WARP, E_MERGE):
                return True
            o += 4 + nr + ng * n
    return False


def kway_merge(x: torch.Tensor, sched: Schedule, payloads: Sequence[torch.Tensor] = (),
               *, n_stages: Optional[int] = None, lens: Optional[Sequence[int]] = None,
               key_dtype: Optional[torch.dtype] = None, descending: bool = False,
               want_perm: bool = False, use_mxu: bool = False) -> Result:
    """Run ``sched`` on the rows of ``x`` (B, n_inputs) -> (B, n_outputs).

    ``n_stages`` stops after that many stages (the median's early exit).
    ``key_dtype`` (the rows' float dtype) merges floats as their
    total-order keys (NaN last, -0.0 below +0.0) and decodes on store;
    int32 rows are keys already. ``use_mxu`` (float rows without
    ``key_dtype``): the reference's raw-float mode. ``descending``: the
    lists, and the output, are descending; needs ``lens``. ``payloads``: (B, n_inputs[,
    F]) lanes returned gathered at the permutation. Returns ``(out, perm
    | None, payload_outs)``; ``perm`` holds positions in the input row."""
    payloads = tuple(payloads)
    _check(x, sched, payloads, lens, key_dtype, descending, use_mxu)
    if x.device.type == "cpu":
        return kway_merge_plain(x, sched, payloads, n_stages=n_stages, lens=lens,
                                key_dtype=key_dtype, descending=descending,
                                want_perm=want_perm, use_mxu=use_mxu)
    cuda_checks("k-way merge kernel", (x,) + payloads, x.dtype, len(payloads))
    if sched.size > MAX_SIZE[use_mxu]:
        raise ValueError(f"the schedule {sched.name} has {sched.size} cells, more than "
                         f"a CTA's shared memory holds ({MAX_SIZE[use_mxu]})")
    bsz, n_out = x.shape[0], sched.n_outputs
    out = torch.empty((bsz, n_out), dtype=x.dtype, device=x.device)
    perm = (torch.empty((bsz, n_out), dtype=torch.int32, device=x.device)
            if want_perm else None)
    pouts = empty_payloads(payloads, bsz, n_out)
    if bsz and n_out:
        wiring, warp = wiring_tensor(x.device, sched, n_stages, lens, descending, use_mxu)
        npay, ins, po, rb = payload_args(payloads, pouts)
        check_rc(library("kway").repro_kway_merge(
            x.data_ptr(), wiring.data_ptr(), wiring.numel(), int(warp), out.data_ptr(),
            None if perm is None else perm.data_ptr(), npay, ins, po, rb, bsz,
            sched.size, sched.n_inputs, n_out, KEY_CODE[x.dtype], int(use_mxu), stream(x)),
            "kway_merge")
        LAUNCHES["kway_merge"] += 1
    return out, perm, pouts
