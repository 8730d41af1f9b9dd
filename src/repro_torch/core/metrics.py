"""Structural cost models of a schedule (a copy of ``repro.core.metrics``).

The paper characterizes devices by (a) combinational propagation delay and
(b) FPGA LUT usage. Neither has a literal TPU meaning, so we report:

  * ``depth``            — dependent stages (delay analog; LOMS=2, Batcher=log).
  * ``comparators``      — pairwise compare count (the comparator cloud).
  * ``lut_proxy``        — a calibrated FPGA-style resource model so the
                           paper's resource *rankings* can be reproduced:
                           - a b-bit ge/eq comparison ~ ceil(b/4) LUT6 (carry
                             chain packing, 4 value bits per LUT);
                           - each output bit's mux tree over f candidate
                             inputs ~ ceil(f/2) LUTs in '2insLUT' mode (2
                             data bits + 1 select per LUT, MUXF* combine) or
                             ~ ceil(f/4) LUTs + 1 extra series level in
                             '4insLUT' mode (paper §VI-A).
  * ``vmem_bytes``       — working set of the reference's kernel
                           realization (values + comparison matrices +
                           one-hot permute), the analog of "does this S2MS
                           fit in the FPGA"; a model, not a card limit.
"""
from __future__ import annotations

import math
from typing import Dict

from .networks import Schedule


def depth(sched: Schedule) -> int:
    return len(sched.stages)


def comparators(sched: Schedule) -> int:
    return sum(st.comparators() for st in sched.stages)


def _group_output_fanin(n: int, runs) -> float:
    """Candidate inputs per output (mux fan-in). In an S2MS merge, output t
    can receive at most min(t, n-t) + r-ish inputs; we use the paper-faithful
    bound: every output of a merge group can see one element per run plus
    its own-run window, approximated by min(n, #runs * 2); full sorts see n."""
    if runs is None:
        return n
    return min(n, len(runs) * 2)


def lut_proxy(sched: Schedule, bits: int = 32, mode: str = "2insLUT") -> int:
    assert mode in ("2insLUT", "4insLUT")
    total = 0
    cmp_luts = math.ceil(bits / 4)
    for st in sched.stages:
        for g in st.groups:
            if g.n <= 1:
                continue
            total += g.comparators() * cmp_luts
            fanin = _group_output_fanin(g.n, g.runs)
            per_bit = math.ceil(fanin / 2) if mode == "2insLUT" else math.ceil(fanin / 4) + 1
            total += g.n * bits * per_bit
    return total


def series_levels(sched: Schedule, mode: str = "2insLUT") -> int:
    """Delay proxy: stages, each costing 1 level, plus the 4insLUT series
    penalty (paper §VI-A: the function-signal LUT is in series)."""
    penalty = 0 if mode == "2insLUT" else 1
    levels = 0
    for st in sched.stages:
        widest = max((g.n for g in st.groups), default=2)
        # a depth-1 rank sorter/merger is 1 compare level + a MUXF-style
        # mux tree of ceil(log2(fanin)) levels (on TPU: 1 VPU + 1 MXU pass)
        levels += 1 + math.ceil(math.log2(max(widest, 2))) + penalty
    return levels


def vmem_bytes(sched: Schedule, bits: int = 32, batch: int = 1) -> int:
    """Peak working set of the kernel realization for one batch tile:
    values + widest stage's comparison matrices + one-hot permute buffers."""
    val_bytes = bits // 8
    values = sched.size * val_bytes * batch
    widest = 0
    for st in sched.stages:
        stage_cmp = 0
        for g in st.groups:
            if g.n <= 1:
                continue
            if g.runs is None:
                stage_cmp += g.n * g.n
            else:
                stage_cmp += 2 * g.comparators()
        widest = max(widest, stage_cmp)
    # comparison matrices in int8 + one-hot permute in value dtype
    return values * 2 + widest * batch * (1 + val_bytes)


def summarize(sched: Schedule, bits: int = 32) -> Dict[str, object]:
    return {
        "name": sched.name,
        "n_inputs": sched.n_inputs,
        "depth": depth(sched),
        "comparators": comparators(sched),
        "lut2ins": lut_proxy(sched, bits, "2insLUT"),
        "lut4ins": lut_proxy(sched, bits, "4insLUT"),
        "vmem_bytes": vmem_bytes(sched, bits),
    }
