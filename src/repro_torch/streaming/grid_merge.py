"""The one-launch streaming 2-way merge (kernel row 9).

Counterpart of ``repro.streaming.grid_merge``: :func:`grid_chunked_merge2`
replaces the reference's function of that name (``_grid_merge2_kernel``,
``src/repro/streaming/grid_merge.py:43``). It merges the ascending rows
``a`` (B, Na) and ``b`` (B, Nb) into (B, Na + Nb), values only.

The TPU kernel walks each row's output tiles in order with the FLiMS
carry in VMEM. :func:`grid_chunked_merge2_plain` runs that carry loop
step by step: each stream padded past its tail with one tile of the
dtype's maximum; the prologue merges the first tile of each stream and
emits the lower half; every later step refills the stream whose
last-loaded value is smaller (``a`` on ties), merges the tile with the
carry by the family's merge program, emits the lower half and keeps the
upper half. A CUDA tensor goes to ``csrc/grid_merge.cu``: a split pass
(``grid_split_kernel``, every output tile's merge-path split at once) and
``grid_merge2_kernel`` (a CTA a tile, a thread a run of outputs merged in
registers). On keys the sorted multiset is unique, so any correct merge
gives the carry loop's bits. :func:`grid_merge2_emulated` runs the
kernel's decomposition on the CPU for the tests. :func:`grid_merge2_rows`
merges rows addressed as (group, member) views in one launch, which is how
the values-only sort spill merges a whole level of runs in place.

Telemetry (``REPRO_OBS`` on), with the reference's names:
``grid_merge.launches`` counts every call of :func:`grid_merge2_rows`
that merges anything, one a kernel launch on the card (equal to
``LAUNCHES["grid_merge2"]``; the reference counts compilations), and
``grid_merge.refill_tiles`` the tiles the rows stream, rows x (output
tiles + 1), labelled with the tile: the kernel's (threads x outputs a
thread) on the card, ``tile`` on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.common import pad_tail_sorted, take_along
from repro_torch.kernels.launch import KEY_CODE, check_rc, library, stream
from repro_torch.kernels.topk import LAUNCHES
from repro_torch.networks import merge_program, merge_runs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

#: threads of a merge CTA and the most outputs a thread merges
#: (``csrc/grid_merge.cu`` THREADS, ITEMS)
GRID_THREADS = 256
GRID_MAX_ITEMS = 16
#: grids of at most this many CTAs search their splits in the merge CTAs
#: and launch no split pass (``SPLIT_IN_CTA``)
GRID_SPLIT_IN_CTA = 1024


def _check(a, b, tile):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"the grid merge takes (B, Na) and (B, Nb), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"the two rows need one dtype, got {a.dtype}, {b.dtype}")
    if tile < 2 or tile % 2:
        raise ValueError(f"tile must be even and >= 2, got {tile}")


def grid_chunked_merge2_plain(a: torch.Tensor, b: torch.Tensor, *, tile: int = 512,
                              network: str = "loms") -> torch.Tensor:
    """Plain version of ``_grid_merge2_kernel``: the FLiMS carry loop."""
    bsz, na = a.shape
    nb = b.shape[1]
    t = int(tile)
    total = na + nb
    out_tiles = -(-total // t)
    la, lb = (-(-na // t) + 1) * t, (-(-nb // t) + 1) * t  # + one drain tile
    ap, bp = pad_tail_sorted(a, la), pad_tail_sorted(b, lb)
    prog = merge_program(network, t, t)
    lane = torch.arange(t, device=a.device)

    def load(rows, ptr):  # the stream not taken may point past an empty row
        return take_along(rows, 1, torch.clamp(ptr, max=rows.shape[1] - t)[:, None] + lane)

    merged = merge_runs(prog, ap[:, :t], bp[:, :t])
    out = [merged[:, :t]]
    carry = merged[:, t:]
    ptr_a = torch.full((bsz,), t, dtype=torch.long, device=a.device)
    ptr_b = ptr_a.clone()
    last_a, last_b = ap[:, t - 1], bp[:, t - 1]
    for _ in range(1, out_tiles):
        sel_a = last_a <= last_b  # refill the lagging stream
        cur = torch.where(sel_a[:, None], load(ap, ptr_a), load(bp, ptr_b))
        tail = cur[:, t - 1]
        last_a = torch.where(sel_a, tail, last_a)
        last_b = torch.where(sel_a, last_b, tail)
        # pointers stop at the drain tile: an exhausted stream reads pads
        ptr_a = torch.where(sel_a, torch.clamp(ptr_a + t, max=la - t), ptr_a)
        ptr_b = torch.where(sel_a, ptr_b, torch.clamp(ptr_b + t, max=lb - t))
        merged = merge_runs(prog, carry, cur)
        out.append(merged[:, :t])
        carry = merged[:, t:]
    return torch.cat(out, dim=1)[:, :total]


def _merge_path(a_at, b_at, na: int, nb: int, d: torch.Tensor) -> torch.Tensor:
    """How many of a's elements are among the first ``d`` outputs (a wins
    ties), for every entry of ``d`` at once: the kernels' binary search
    along the diagonal, ``a_at(i)`` / ``b_at(j)`` reading the two sides."""
    lo = torch.clamp(d - nb, min=0)
    hi = torch.clamp(d, max=na)
    for _ in range(max(na, nb, 1).bit_length() + 1):
        mid = (lo + hi) // 2
        go = lo < hi
        take = a_at(torch.clamp(mid, 0, max(na - 1, 0))) <= b_at(
            torch.clamp(d - 1 - mid, 0, max(nb - 1, 0)))
        lo = torch.where(go & take, mid + 1, lo)
        hi = torch.where(go & ~take, mid, hi)
    return lo


def grid_merge2_emulated(a: torch.Tensor, b: torch.Tensor, *, items: int,
                         threads: int = GRID_THREADS) -> torch.Tensor:
    """The CUDA kernels' decomposition on the CPU: the split pass over
    whole rows at every tile of ``items * threads`` outputs, then per tile
    each thread's merge path in its two pieces and ``items`` serial merge
    steps. For the tests; equals the plain version on any rows."""
    bsz, na = a.shape
    nb = b.shape[1]
    total = na + nb
    tile = items * threads
    tiles = max(-(-total // tile), 1)
    ap = torch.cat([a, a.new_zeros((bsz, 1))], dim=1)  # one slot past each end
    bp = torch.cat([b, b.new_zeros((bsz, 1))], dim=1)

    def reader(rows, base):
        shape = base.shape
        return lambda i: torch.gather(rows, 1, (base + i).reshape(bsz, -1)).reshape(shape)

    zero = torch.zeros((bsz, tiles + 1), dtype=torch.long)
    d = torch.clamp(torch.arange(tiles + 1) * tile, max=total).expand(bsz, -1)
    splits = _merge_path(reader(ap, zero), reader(bp, zero), na, nb, d)
    d0 = (torch.arange(tiles) * tile).expand(bsz, -1)
    d1 = torch.clamp(d0 + tile, max=total)
    i0, i1 = splits[:, :-1], splits[:, 1:]
    j0 = d0 - i0
    la, lb, n = (i1 - i0)[..., None], (d1 - i1 - j0)[..., None], (d1 - d0)[..., None]
    e0 = (torch.arange(threads) * items).expand(bsz, tiles, -1)
    base_a = i0[..., None].expand_as(e0)
    base_b = j0[..., None].expand_as(e0)
    lo = torch.clamp(e0 - lb, min=0)
    hi = torch.minimum(e0, la)
    for _ in range(tile.bit_length() + 1):  # the search inside the pieces
        mid = (lo + hi) // 2
        go = lo < hi
        take = (reader(ap, base_a)(torch.minimum(mid, torch.clamp(la - 1, min=0)))
                <= reader(bp, base_b)(torch.clamp(e0 - 1 - mid, min=0).minimum(lb)))
        lo = torch.where(go & take, mid + 1, lo)
        hi = torch.where(go & ~take, mid, hi)
    ia, ib = lo, e0 - lo
    out = a.new_zeros((bsz, tiles * tile + 1))
    for j in range(items):  # serial steps, each thread's j-th output
        va = reader(ap, base_a)(torch.minimum(ia, la))
        vb = reader(bp, base_b)(torch.minimum(ib, lb))
        take_a = (ia < la) & ((ib >= lb) | (va <= vb))
        live = e0 + j < n
        dest = torch.where(live, d0[..., None] + e0 + j, tiles * tile)
        out.scatter_(1, dest.reshape(bsz, -1), torch.where(take_a, va, vb).reshape(bsz, -1))
        ia = ia + take_a.long()
        ib = ib + (~take_a).long()
    return out[:, :total]


def _check_rows(tensors, dtype) -> None:
    """What the CUDA kernel takes: a key type it knows, card tensors, each
    row's elements contiguous."""
    if dtype not in KEY_CODE:
        raise TypeError(f"the CUDA grid merge takes float32, bfloat16, float16 or int32 "
                        f"values, not {dtype}")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"tensor on {t.device}: every input of the CUDA grid merge "
                             "lies on the card")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError("the CUDA grid merge takes rows whose elements are contiguous")


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _items(device, rows: int, total: int) -> int:
    """Outputs a thread of the merge takes (the tile is 256 times that): a
    row of at most 4096 is one tile just large enough; longer rows take
    16, halved down to 2 while the CTAs would not fill the card twice
    over. ``launch.GRID_ITEMS`` forces it."""
    if launch.GRID_ITEMS:
        if not 1 <= launch.GRID_ITEMS <= GRID_MAX_ITEMS:
            raise ValueError(f"GRID_ITEMS must lie in [1, {GRID_MAX_ITEMS}], "
                             f"got {launch.GRID_ITEMS}")
        return launch.GRID_ITEMS
    if total <= GRID_MAX_ITEMS * GRID_THREADS:
        return -(-total // GRID_THREADS)
    items = GRID_MAX_ITEMS
    while items > 2 and rows * -(-total // (items * GRID_THREADS)) < 2 * _sms(device):
        items //= 2
    return items


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            splits: torch.Tensor = None, which: int = 3) -> torch.Tensor:
    """Launch the split pass and the merge on (G, P, n) row views (``which``:
    1 the split pass, 2 the merge, 3 both); returns the splits scratch."""
    g, per, na = a.shape
    nb = b.shape[2]
    items = _items(a.device, g * per, na + nb)
    tiles = -(-(na + nb) // (items * GRID_THREADS))
    if splits is None and tiles > 1 and g * per * tiles > GRID_SPLIT_IN_CTA:
        splits = torch.empty(g * per * (tiles + 1), dtype=torch.int32, device=a.device)
    check_rc(library("grid_merge").repro_grid_merge2(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if splits is None else splits.data_ptr(), g, per, na, nb, a.stride(0),
        a.stride(1), b.stride(0), b.stride(1), out.stride(0), out.stride(1), items, which,
        KEY_CODE[a.dtype], stream(a)), "grid_merge2")
    return splits


def grid_merge2_rows(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
                     tile: int = 512, network: str = "loms") -> torch.Tensor:
    """Merge the ascending rows of the (G, P, Na) and (G, P, Nb) views
    ``a`` and ``b`` into the (G, P, Na + Nb) view ``out``, in one launch of
    the kernel; each view's rows may lie anywhere (any strides on the two
    leading axes), their elements contiguous. ``tile`` and ``network``
    shape the plain version on the CPU. Returns ``out``."""
    if a.ndim != 3 or b.shape[:2] != a.shape[:2] or out.shape != a.shape[:2] + (
            a.shape[2] + b.shape[2],):
        raise ValueError(f"the grid merge takes (G, P, Na), (G, P, Nb) and (G, P, Na + Nb), "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(out.shape)}")
    if a.dtype != b.dtype or out.dtype != a.dtype:
        raise ValueError(f"the rows need one dtype, got {a.dtype}, {b.dtype}, {out.dtype}")
    if tile < 2 or tile % 2:
        raise ValueError(f"tile must be even and >= 2, got {tile}")
    na, nb = a.shape[2], b.shape[2]
    rows = a.shape[0] * a.shape[1]
    if a.device.type == "cpu":
        out.copy_(grid_chunked_merge2_plain(a.reshape(-1, na), b.reshape(-1, nb), tile=tile,
                                            network=network).reshape(out.shape))
        if out.numel() and obs_trace.enabled():
            _record(rows, na + nb, tile)
        return out
    _check_rows((a, b, out), a.dtype)
    if out.numel():
        _launch(a, b, out)
        LAUNCHES["grid_merge2"] += 1
        if obs_trace.enabled():
            _record(rows, na + nb, _items(a.device, rows, na + nb) * GRID_THREADS)
    return out


def _record(rows: int, total: int, tile: int) -> None:
    """The ``grid_merge.*`` counters of one merge of ``rows`` rows."""
    obs_metrics.counter("grid_merge.launches").inc(tile=tile)
    obs_metrics.counter("grid_merge.refill_tiles").inc(rows * (-(-total // tile) + 1), tile=tile)


def grid_merge2_phases(a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor = None,
                       splits: torch.Tensor = None, which: int = 3):
    """The card's split pass (``which`` 1), merge (2) or both (3) on (B, Na)
    and (B, Nb), for timing them apart: ``(out, splits)``, the outputs of a
    first call to hand to the next. Counts no launch."""
    _check_rows((a, b), a.dtype)
    if out is None:
        out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]), dtype=a.dtype,
                          device=a.device)
    splits = _launch(a[:, None], b[:, None], out[:, None], splits, which)
    return out, splits


def grid_chunked_merge2(a: torch.Tensor, b: torch.Tensor, *, tile: int = 512,
                        network: str = "loms") -> torch.Tensor:
    """One-launch streaming merge of ascending (B, Na) and (B, Nb): the
    sorted concatenation of each row pair. ``tile`` and ``network`` shape
    the plain version's carry loop; the CUDA kernel's tiles are its own.
    Values only; floats merge as their total-order keys on the card. On
    the card the rows may be strided views (elements contiguous)."""
    _check(a, b, int(tile))
    if a.device.type == "cpu":
        return grid_chunked_merge2_plain(a, b, tile=tile, network=network)
    bsz, na = a.shape
    nb = b.shape[1]
    out = torch.empty((bsz, na + nb), dtype=a.dtype, device=a.device)
    if bsz and na + nb:
        grid_merge2_rows(a[:, None], b[:, None], out[:, None], tile=tile, network=network)
    return out
