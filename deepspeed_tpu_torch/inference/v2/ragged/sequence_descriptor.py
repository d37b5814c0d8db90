"""Per-sequence host state (counterpart of
``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``; reference:
inference/v2/ragged/sequence_descriptor.py:59 ``DSSequenceDescriptor`` and
ragged_manager.py:19 ``DSStateManager``), with the ``kv_alloc`` fault
site and the prefix cache's page sharing."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ....runtime.fault.injection import InjectedExhausted, inject
from ....utils.logging import logger
from .blocked_allocator import BlockedAllocator


@dataclasses.dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0                 # tokens already in the KV cache
    in_flight_tokens: int = 0            # tokens scheduled this forward
    blocks: List[int] = dataclasses.field(default_factory=list)
    #: attested tokens of an imported KV prefix (``kv_ship.import_kv``)
    input_ids: List[int] = dataclasses.field(default_factory=list)

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.blocks)

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0


class DSStateManager:
    """uid → descriptor registry + KV block bookkeeping.

    When a :class:`~.prefix_cache.RadixPrefixCache` is attached
    (``prefix_cache``), cached pages are RECLAIMABLE capacity: an
    allocation that would otherwise fail first evicts cold cache pages
    (refcount 1, LRU) and retries, so the cache can grow into every idle
    block without ever starving admission."""

    def __init__(self, num_blocks: int, block_size: int = 128,
                 max_tracked_sequences: int = 2048):
        self.block_size = block_size
        self.allocator = BlockedAllocator(num_blocks)
        self.max_tracked_sequences = max_tracked_sequences
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        self.prefix_cache = None       # set by InferenceEngineV2 when enabled

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self._seqs:
            return self._seqs[uid]
        if len(self._seqs) >= self.max_tracked_sequences:
            raise RuntimeError("too many tracked sequences; flush some uids")
        seq = DSSequenceDescriptor(uid=uid)
        self._seqs[uid] = seq
        return seq

    def blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        total = seq.seen_tokens + seq.in_flight_tokens + new_tokens
        needed = -(-total // self.block_size)
        return max(needed - seq.cur_allocated_blocks, 0)

    def maybe_allocate_kv(self, seq: DSSequenceDescriptor,
                          new_tokens: int) -> bool:
        need = self.blocks_needed(seq, new_tokens)
        if need == 0:
            return True
        # injection site: `exhausted` makes a GENUINE allocation (need > 0)
        # report failure, so schedulers see transient KV exhaustion where
        # their backpressure must handle it; no-op allocations of already
        # reserved sequences never fire
        try:
            inject("kv_alloc")
        except InjectedExhausted:
            return False
        if need > self.allocator.free_blocks and self.prefix_cache is not None:
            # cached prefix pages are free capacity: evict cold ones (LRU,
            # trie-only holders) before reporting exhaustion
            self.prefix_cache.evict(need - self.allocator.free_blocks)
        if need > self.allocator.free_blocks:
            return False
        seq.blocks.extend(int(b) for b in self.allocator.allocate(need))
        return True

    def share_blocks(self, seq: DSSequenceDescriptor, blocks,
                     n_tokens: int) -> None:
        """Graft already-cached KV pages into a FRESH sequence: the blocks
        are appended to its table with one extra allocator reference each,
        and the first ``n_tokens`` rows they cover count as seen. The
        caller (engine ``graft_prefix``) guarantees the attested tokens
        match; this layer only does the accounting."""
        if seq.blocks or seq.seen_tokens:
            raise ValueError(
                f"prefix graft into a non-fresh sequence uid={seq.uid}")
        blocks = [int(b) for b in blocks]
        self.allocator.ref(blocks)
        seq.blocks.extend(blocks)
        seq.seen_tokens = int(n_tokens)

    def flush_sequence(self, uid: int) -> None:
        """Release a sequence's blocks (reference engine_v2.flush :242)."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            logger.warning(f"flush of unknown uid {uid}")
            return
        if seq.blocks:
            self.allocator.free(seq.blocks)
