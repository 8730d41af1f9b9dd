"""Paged KV-cache pool: page-granular slots over the layer caches.

Counterpart of ``repro.serving.scheduler.paged`` for the port's cache
layout. The pool holds one tensor per leaf with the layers stacked in
front: GQA's k ``(L, P, Hkv, D, page)`` and v ``(L, P, Hkv, page, D)``,
MLA's ckv ``(L, P, kv_lora, page)`` and kpe ``(L, P, rope, page)``. A
slot is a row of the page table; gathering a batch of slot rows and
merging the page axis into the sequence axis gives the dense per-layer
cache that ``decode_step`` takes (``{"k": (ns, Hkv, D, S), "v": (ns,
Hkv, S, D), "pos": (ns,)}`` for GQA), with S = pages_per_slot *
page_size.

Invariants (DESIGN.md §14):
  * page 0 is reserved scratch: free page-table entries point at it, so a
    gather is always dense and in bounds; positions past a slot's length
    carry exactly zero attention weight, so what a page holds there never
    reaches the math;
  * admission sizes a slot's pages to ``ceil((prompt + max_new) /
    page_size)``, so a decode write always lands in a page the slot owns;
  * the gather and the write-back are copies, so a gathered view equals
    the contiguous cache bit for bit.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models import init_cache

#: sequence axis of each leaf, from the end of the per-page block
_SEQ_AXIS = {"k": -1, "v": -2, "ckv": -1, "kpe": -1}


def gather_view(leaves: Dict[str, torch.Tensor], page_table: torch.Tensor,
                lengths: torch.Tensor) -> dict:
    """The dense cache of a batch of slots: ``page_table`` (ns, npg)
    int64 on the pool's device, ``lengths`` (ns,) int32 valid depths ->
    ``{"body": [layer cache]}``."""
    ns, npg = page_table.shape
    flat = page_table.reshape(-1)
    view = {}
    for name, pool in leaves.items():
        g = pool[:, flat]  # (L, ns*npg, *block)
        g = g.reshape((pool.shape[0], ns, npg) + tuple(pool.shape[2:]))
        ax = g.ndim + _SEQ_AXIS[name]  # the page's sequence axis
        g = torch.movedim(g, 2, ax - 1)  # pages next to their sequence axis
        view[name] = g.reshape(tuple(g.shape[:ax - 1]) + (npg * g.shape[ax],)
                               + tuple(g.shape[ax + 1:]))
    n_layers = next(iter(leaves.values())).shape[0]
    return {"body": [{**{name: v[i] for name, v in view.items()}, "pos": lengths.clone()}
                     for i in range(n_layers)]}


def take_col(body: List[dict], name: str, positions: torch.Tensor) -> torch.Tensor:
    """One sequence column per row of a view: (L, ns, *block without the
    sequence axis), at per-row ``positions`` (ns,)."""
    rows = torch.arange(positions.shape[0], device=positions.device)
    pos = positions.long()
    return torch.stack([lc[name].movedim(lc[name].ndim + _SEQ_AXIS[name], 1)[rows, pos]
                        for lc in body])


def scatter_col(pool: torch.Tensor, name: str, col: torch.Tensor,
                page_ids: torch.Tensor, offs: torch.Tensor) -> None:
    """Write one column per slot into the pool in place: ``col`` (L, ns,
    *block without the sequence axis) lands at (page_ids[s], offs[s])."""
    seq = pool.movedim(pool.ndim + _SEQ_AXIS[name], 2)  # a view: (L, P, page, *rest)
    seq[:, page_ids.long(), offs.long()] = col


def split_pages(layer_caches: List[dict], name: str, row: int, npg: int,
                page_size: int) -> torch.Tensor:
    """Cut one row of a prefill cache into page blocks for a pool write:
    (L, npg, *block with the sequence axis = page_size)."""
    leaf = torch.stack([lc[name][row] for lc in layer_caches])  # (L, *block)
    ax = leaf.ndim + _SEQ_AXIS[name]
    leaf = leaf.narrow(ax, 0, npg * page_size)
    leaf = leaf.reshape(tuple(leaf.shape[:ax]) + (npg, page_size)
                        + tuple(leaf.shape[ax + 1:]))
    return torch.movedim(leaf, ax, 1)


class PagedKVCache:
    """The device-side page pool of a homogeneous attention stack (GQA's
    K/V or MLA's latent leaves), each leaf (L, pages, *block). A cache with
    another group than ``body`` (a leading dense layer's ``head``) raises
    ``ValueError``, with the message of the reference's
    ``AssertionError``. ``n_layers`` is the leaves' leading axis and
    ``nbytes`` the bytes of all the leaves, as the reference's."""

    def __init__(self, cfg, n_pages: int, page_size: int, device):
        cache = init_cache(cfg, n_pages, page_size, device)
        if set(cache) != {"body"}:
            raise ValueError(f"paged slots need a homogeneous attention stack, "
                             f"got cache groups {sorted(cache)}")
        self.leaves: Dict[str, torch.Tensor] = {
            name: torch.stack([lc[name] for lc in cache["body"]])
            for name in cache["body"][0] if name != "pos"}
        del cache
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_layers = next(iter(self.leaves.values())).shape[0]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.leaves.values())

    def insert(self, pages: torch.Tensor, blocks: Dict[str, torch.Tensor]) -> None:
        """Write page blocks (L, npg, *block) at page ids ``pages``."""
        for name, blk in blocks.items():
            self.leaves[name][:, pages.long()] = blk


class SlotManager:
    """Host-side slot and page bookkeeping (free lists, page table); a
    copy of the reference's. ``order`` picks the free slot reused next,
    "fifo" or "lifo"; tokens must not depend on it."""

    def __init__(self, n_slots: int, pages_per_slot: int, n_pages: int,
                 order: str = "fifo"):
        assert order in ("fifo", "lifo"), order
        assert n_slots >= 1 and pages_per_slot >= 1
        assert n_pages >= 1 + pages_per_slot, (
            "pool needs the reserved scratch page plus one full slot")
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.order = order
        self.page_table = np.zeros((n_slots, pages_per_slot), np.int32)
        self._free_slots = deque(range(n_slots))
        self._free_pages = deque(range(1, n_pages))  # page 0 = scratch
        self._n_alloc: Dict[int, int] = {}

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    def can_admit(self, npg: int) -> bool:
        return bool(self._free_slots) and len(self._free_pages) >= npg

    def alloc(self, npg: int) -> Tuple[int, np.ndarray]:
        """Claim a slot and ``npg`` pages; unfilled page-table entries stay
        0 (the scratch page), keeping gathers dense."""
        assert 0 < npg <= self.pages_per_slot, npg
        assert self.can_admit(npg), (npg, self.free_slot_count,
                                     self.free_page_count)
        slot = (self._free_slots.popleft() if self.order == "fifo"
                else self._free_slots.pop())
        pages = np.asarray([self._free_pages.popleft() for _ in range(npg)],
                           np.int32)
        self.page_table[slot] = 0
        self.page_table[slot, :npg] = pages
        self._n_alloc[slot] = npg
        return slot, pages

    def release(self, slot: int) -> None:
        npg = self._n_alloc.pop(slot)
        for p in self.page_table[slot, :npg]:
            self._free_pages.append(int(p))
        self.page_table[slot] = 0
        self._free_slots.append(slot)
