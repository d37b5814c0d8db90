"""KV-cache block allocator (counterpart of
``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``; reference:
inference/v2/ragged/blocked_allocator.py:11).

Host-side free list over a fixed pool of KV blocks; the device only ever
sees block ids inside block tables.

Blocks are REFERENCE-COUNTED so the radix prefix cache can share committed
KV pages across sequences (``prefix_cache.py``): ``allocate`` hands out
blocks at refcount 1, ``ref`` adds a holder (a second sequence grafting the
page, or the trie itself), and ``free`` drops one holder — the block only
returns to the free list when the last holder lets go. Callers that never
share see plain allocate/free semantics: every allocate is refcount 1 and
the matching free releases it.
"""
from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np


class BlockedAllocator:
    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # linked free list: next_free[i] = next free block after i
        self._next = np.arange(1, num_blocks + 1, dtype=np.int64)
        self._head = 0
        self._free = num_blocks
        # holders per block: 0 = on the free list
        self._refs = np.zeros(num_blocks, dtype=np.int64)
        #: optional page-heat observer (``page_heat.PageHeatTracker``):
        #: notified AFTER every holder transition, so its live-page set
        #: follows the free list through every path — state manager,
        #: prefix-cache trie, copy-on-write grafts, flushes
        self.heat = None

    @property
    def free_blocks(self) -> int:
        return self._free

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        """Current holder count of ``block`` (0 = free)."""
        if not 0 <= block < self._num_blocks:
            raise ValueError(f"block id {block} out of range")
        return int(self._refs[block])

    def refcounts(self) -> np.ndarray:
        """Copy of the per-block holder counts (0 = free)."""
        return self._refs.copy()

    def allocate(self, num_blocks: int) -> np.ndarray:
        if num_blocks > self._free:
            raise ValueError(
                f"cannot allocate {num_blocks} blocks; only {self._free} free")
        out = np.empty(num_blocks, dtype=np.int64)
        for i in range(num_blocks):
            out[i] = self._head
            self._head = self._next[self._head]
        self._free -= num_blocks
        self._refs[out] = 1
        if self.heat is not None:
            self.heat.note_alloc(out)
        return out

    def ref(self, blocks: Union[Iterable[int], np.ndarray]) -> None:
        """Add one holder to each (already allocated) block — the prefix
        cache's share path. Refusing free blocks catches a use after free:
        sharing a page somebody already released."""
        arr = np.atleast_1d(np.asarray(blocks, dtype=np.int64))
        for b in arr:
            b = int(b)
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"block id {b} out of range")
            if self._refs[b] <= 0:
                raise ValueError(f"ref of free block {b}")
            self._refs[b] += 1
        if self.heat is not None and arr.size:
            self.heat.note_ref(arr)

    def free(self, blocks: Union[Iterable[int], np.ndarray]) -> None:
        """Drop one holder per block; a block returns to the free list only
        when its last holder releases it. Double frees raise."""
        blocks = np.atleast_1d(np.asarray(blocks, dtype=np.int64))
        seen = set()
        released: List[int] = []
        for b in blocks:
            b = int(b)
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"block id {b} out of range")
            if b in seen:
                raise ValueError(f"double free of block {b} in one call")
            seen.add(b)
            if self._refs[b] <= 0:
                raise ValueError(f"free of already-free block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._next[b] = self._head
                self._head = b
                released.append(b)
        self._free += len(released)
        if self.heat is not None and released:
            self.heat.note_release(released)
