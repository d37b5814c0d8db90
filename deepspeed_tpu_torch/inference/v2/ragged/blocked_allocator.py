"""KV-cache block allocator (counterpart of
``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``; reference:
inference/v2/ragged/blocked_allocator.py:11).

Host-side free list over a fixed pool of KV blocks; the device only ever
sees block ids inside block tables. A copy of the JAX package's numpy
allocator without the sharing (``ref``) and page-heat hooks, which belong
to the prefix cache and page-heat tracker of a later slice.
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

    @property
    def free_blocks(self) -> int:
        return self._free

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

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
        return out

    def free(self, blocks: Union[Iterable[int], np.ndarray]) -> None:
        """Return blocks to the free list; double frees raise."""
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
