"""The S2MS-prefix argument of the redesigned sort executor, held on the CPU.

The fused sort and the class sort (``csrc/program.cuh`` ``sort_prefix``,
``sort_levels``) run the S2MS levels at the bottom of a sort program as
one bitonic sort of the (key, position) pairs of each aligned group of
``2**j`` lanes in registers, ``j`` the program's S2MS prefix capped at a
warp's lanes (32 x the lanes a thread), and the levels above it from
shared memory. This holds because positions start as the lane index and
an S2MS level lets lo win ties while every lo position lies below every
hi position: after those levels each group is sorted by the unique pair,
so any correct sort of the pair gives the same bits.

Here a torch emulation of that decomposition (the kernel's own bitonic
network: its step order, directions and min/max choice on the packed
64-bit pairs; then ``run_sort_program`` from level ``j``) is compared with
the plain ``run_sort_program`` of the whole program, keys and positions
bit for bit, for every capable family at widths 8 to 1024 and every
lanes-a-thread the launch plan takes, on heavily tied rows: bf16 keys
from a small integer range, all-equal rows, INT32_MAX pads beside genuine
INT32_MAX keys, and the class sort's flipped keys (``~key``).
Tolerance: none, bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import encode_key_values
from repro_torch.networks import (capable_families, run_sort_program, s2ms_prefix,
                                  sort_program)

WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024)
LANES = (1, 2, 4, 8)  # lanes a thread of the sort executor (sort_plan)
INT32_MAX = np.iinfo(np.int32).max


def _pack(keys: torch.Tensor, pos: torch.Tensor, narrow: bool) -> torch.Tensor:
    """``pack_pair`` of program.cuh: the 64-bit pair, or for 16-bit keys
    the 32-bit one (17 key bits, the pad INT32_MAX above every key, and 13
    position bits), as int64 values that order alike."""
    if narrow:
        k = torch.where(keys == INT32_MAX, 65536, keys.to(torch.int64) + 32768)
        return (k << 13) | pos.to(torch.int64)
    return (keys.to(torch.int64) << 32) | (pos.to(torch.int64) & 0xFFFFFFFF)


def _unpack(v: torch.Tensor, narrow: bool):
    if narrow:
        k = (v >> 13) - 32768
        return torch.where(k == 32768, INT32_MAX, k).to(torch.int32), (v & 8191).to(torch.int32)
    return (v >> 32).to(torch.int32), (v & 0xFFFFFFFF).to(torch.int32)


def _bitonic_groups(keys: torch.Tensor, pos: torch.Tensor, s: int, narrow: bool = False):
    """``sort_groups`` of program.cuh on every aligned group of ``s``
    lanes: the bitonic steps (k, j) in the kernel's order, lane i paired
    with i ^ j, ascending where ``k == s`` or ``i & k == 0``, the lower
    lane of an ascending pair keeping the min of the packed pair."""
    v = _pack(keys, pos, narrow)
    i = torch.arange(v.shape[-1])
    k = 2
    while k <= s:
        j = k >> 1
        while j > 0:
            o = v[..., i ^ j]
            up = (i & k) == 0 if k < s else torch.ones_like(i, dtype=torch.bool)
            keep_min = ((i & j) == 0) == up
            v = torch.where(keep_min, torch.minimum(v, o), torch.maximum(v, o))
            j >>= 1
        k <<= 1
    return _unpack(v, narrow)


def _rows(w: int) -> torch.Tensor:
    """Heavily tied int32 key rows of width ``w``."""
    rng = np.random.default_rng(w)
    vals = (rng.integers(-3, 4, (6, w)) * 0.5).astype(np.float32)
    vals[0, rng.random(w) < 0.2] = -0.0
    vals[1, rng.random(w) < 0.1] = np.nan
    vals[2, rng.random(w) < 0.1] = np.inf
    bf = torch.from_numpy(vals).to(torch.bfloat16)
    keys = encode_key_values(bf)  # bf16 keys: few distinct values
    rows = [keys,
            torch.zeros((1, w), dtype=torch.int32),  # all equal
            torch.full((1, w), INT32_MAX, dtype=torch.int32)]
    pads = keys[:2].clone()  # a live prefix, then INT32_MAX pads, and a genuine one
    pads[:, w // 2 + 1:] = INT32_MAX
    pads[:, 1] = INT32_MAX
    rows.append(pads)
    rows.append(torch.from_numpy(rng.integers(-2, 3, (2, w)).astype(np.int32)))
    x = torch.cat(rows)
    return torch.cat([x, ~x])  # and the class sort's descending flip


@pytest.mark.parametrize("w", WIDTHS)
def test_prefix_decomposition_equals_the_sort_program(w):
    keys = _rows(w)
    pos = torch.arange(w, dtype=torch.int32).expand(keys.shape).contiguous()
    for fam in capable_families("sort", (w,)):
        prog = sort_program(fam, w)
        want_k, want_p = run_sort_program(prog, keys, pos)
        prefix = s2ms_prefix(prog)
        for s in sorted({min(1 << prefix, 32 * er) for er in LANES}):
            first = s.bit_length() - 1
            k, p = _bitonic_groups(keys, pos, s)
            got_k, got_p = run_sort_program(prog, k, p, first_level=first)
            assert torch.equal(got_k, want_k), (fam, w, s)
            assert torch.equal(got_p, want_p), (fam, w, s)


@pytest.mark.parametrize("w", WIDTHS)
def test_narrow_pairs_sort_bf16_keys_alike(w):
    """The 32-bit pair of 16-bit keys (bf16 keys, flipped, INT32_MAX pads)
    sorts every group exactly as the 64-bit pair does."""
    keys = _rows(w)[:6]
    keys = torch.cat([keys[:1], keys[3:]])  # the bf16-key rows and the padded ones
    keys = torch.cat([keys, ~torch.where(keys == INT32_MAX, 0, keys)])
    pos = torch.arange(w, dtype=torch.int32).expand(keys.shape).contiguous()
    for s in (2, 64, 256):
        if s <= w:
            wide = _bitonic_groups(keys, pos, s)
            narrow = _bitonic_groups(keys, pos, s, narrow=True)
            assert torch.equal(wide[0], narrow[0]) and torch.equal(wide[1], narrow[1])


@pytest.mark.parametrize("w", WIDTHS)
def test_prefix_is_the_bottom_run_of_s2ms_levels(w):
    for fam in capable_families("sort", (w,)):
        levels = sort_program(fam, w).levels
        j = s2ms_prefix(sort_program(fam, w))
        assert all(mp.kind == "columns" and mp.n_cols <= 1 for mp in levels[:j])
        assert j == len(levels) or not (levels[j].kind == "columns"
                                        and levels[j].n_cols <= 1)
        if fam in ("bitonic", "periodic3"):
            assert j == 0
        if fam == "loms":
            assert j == min(6, len(levels))


def test_bitonic_emulation_sorts_every_group():
    """The emulated network alone is a sort of each group by the pair."""
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(-2, 3, (4, 256)).astype(np.int32))
    pos = torch.arange(256, dtype=torch.int32).expand(keys.shape).contiguous()
    for s in (2, 8, 64, 256):
        k, p = _bitonic_groups(keys, pos, s)
        pair = (k.to(torch.int64) << 32) | p.to(torch.int64)
        g = pair.reshape(4, -1, s)
        assert torch.equal(g, torch.sort(g, dim=-1)[0])
