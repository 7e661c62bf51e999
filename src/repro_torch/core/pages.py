"""Paged KV-cache memory manager (host side; a copy of
``repro.core.pages``).

Dense per-slot caches reserve ``cache_len`` positions for every slot, so
HBM capacity — not compute — caps serving concurrency.  This allocator
replaces that with a vLLM-style page pool: KV memory is ``n_pages``
fixed-size pages shared by all slots; each slot owns a *page table*
mapping its logical page index j (tokens [j*page_size, (j+1)*page_size))
to a physical page.  The device-side pools and the paged attention
gather/scatter live in ``models.attention``; the paged flash-decode
kernel in ``kernels.decode_attention`` walks the same table, loading
its entries itself.

The allocator is pure host Python (numpy): pages are allocated/freed
between rounds (admit, per-round growth, speculative-rollback shrink,
release), never inside device code.  Device code only *reads* the
table.

Invariants (``check()``; the reference's property suite drives random op
sequences against them, and ``tests/test_torch_pages.py`` holds this copy
to the reference step for step):
  * conservation: every physical page is free or owned by exactly one
    slot — no leaks, no double allocation;
  * prefix density: a slot's table is a dense prefix (pages at logical
    indices 0..k-1, ``FREE`` beyond) — positions map contiguously;
  * atomic growth: ``ensure`` either fully covers the requested token
    count or changes nothing (no partial grabs to unwind).

Unallocated table entries are ``FREE`` (-1).  Device code maps them to a
dedicated trash page (pool row ``n_pages``) so masked-out rows can never
scribble on a live page — see ``models.attention.sanitize_page_table``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

FREE = -1


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions."""
    return -(-max(n_tokens, 0) // page_size)


@dataclasses.dataclass
class PageStats:
    n_pages: int
    page_size: int
    in_use: int
    free: int
    peak_in_use: int


class PageAllocator:
    """Free-list page pool + per-slot page tables.

    LIFO free list: a page freed by a rollback is the next one handed
    out, so churny shrink/grow cycles touch the same HBM pages.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages_per_slot: int):
        assert n_pages > 0 and page_size > 0 and n_slots > 0
        assert max_pages_per_slot > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.table = np.full((n_slots, max_pages_per_slot), FREE, np.int32)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.peak_in_use = 0

    # -- queries --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def slot_pages(self, slot: int) -> int:
        return int((self.table[slot] != FREE).sum())

    def slot_tokens_capacity(self, slot: int) -> int:
        return self.slot_pages(slot) * self.page_size

    def pages_needed(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def stats(self) -> PageStats:
        return PageStats(self.n_pages, self.page_size, self.pages_in_use,
                         self.free_pages, self.peak_in_use)

    # -- transitions ----------------------------------------------------
    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover ``n_tokens`` positions.  Atomic: on
        pool exhaustion nothing is allocated and False is returned (the
        serving layer preempts a request and retries)."""
        need = self.pages_needed(n_tokens)
        assert need <= self.max_pages_per_slot, (
            f"slot {slot}: {n_tokens} tokens need {need} pages "
            f"> per-slot table width {self.max_pages_per_slot}")
        have = self.slot_pages(slot)
        grow = need - have
        if grow <= 0:
            return True
        if grow > len(self._free):
            return False
        for j in range(have, need):
            self.table[slot, j] = self._free.pop()
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return True

    # ``admit`` is ensure-from-empty, named for the serving lifecycle.
    def admit(self, slot: int, n_tokens: int) -> bool:
        assert self.slot_pages(slot) == 0, f"slot {slot} not released"
        return self.ensure(slot, n_tokens)

    def shrink(self, slot: int, n_tokens: int):
        """Free pages past the last one holding a kept token — the
        speculative-rollback path (keep ``n_tokens`` = n_keep)."""
        keep = self.pages_needed(n_tokens)
        have = self.slot_pages(slot)
        for j in range(have - 1, keep - 1, -1):
            self._free.append(int(self.table[slot, j]))
            self.table[slot, j] = FREE

    def release(self, slot: int):
        """Request finished/preempted: return every page to the pool."""
        self.shrink(slot, 0)

    # -- invariants ------------------------------------------------------
    def check(self):
        owned = self.table[self.table != FREE].tolist()
        assert len(owned) == len(set(owned)), "page double-allocated"
        assert len(set(owned) & set(self._free)) == 0, \
            "page both free and owned"
        assert len(owned) + len(self._free) == self.n_pages, "page leak"
        assert all(0 <= p < self.n_pages for p in owned)
        for s in range(self.n_slots):
            row = self.table[s]
            k = int((row != FREE).sum())
            assert (row[:k] != FREE).all() and (row[k:] == FREE).all(), \
                f"slot {s} table not a dense prefix"
        assert self.peak_in_use >= self.pages_in_use
