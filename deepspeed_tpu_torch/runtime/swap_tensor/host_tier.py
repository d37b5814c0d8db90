"""Host-memory page tier (counterpart of ``HostPageTier`` in
``deepspeed_tpu/runtime/swap_tensor/host_tier.py``).

A bounded, LRU-evicting store of canonical-row page payloads in host
memory: :class:`~deepspeed_tpu_torch.inference.v2.ragged.kv_swap.KVSwapManager`
parks a preempted sequence's KV rows (and spilled radix-prefix pages) here,
so that resume is a host-to-device copy and a page-table patch instead of
a prefill recompute. Payloads are float32 rows in the ``kv_ship`` layout
``[num_layers, n, 2*kv_heads, head_dim]``; a bf16 pool's rows widen to
float32 and narrow back exactly (a pure cast both ways).

Double buffering: a ``put`` issues the device-to-host copy and parks it in
a one-slot pending buffer; the NEXT ``put`` (or an explicit :meth:`sync`)
materializes the previous transfer, by which point the copy has run
behind the caller's work. For a CUDA payload the copy goes into a pinned
host buffer with ``non_blocking=True`` and an event recorded after it:
materializing waits on that event (reading the buffer earlier would see
stale rows), and a discarded pending transfer keeps its buffer alive until
its event has completed. A CPU payload is copied at once, synchronously.

:class:`HostOffloadPrefetcher` (``offload_optimizer.pipeline_read``)
stages the host-resident optimizer state toward the device before the
forward, through ``streamed_update.StreamedUpdate.stage``.

Fault sites (``runtime/fault/injection.py``): ``host_alloc`` at buffer
admission, ``kv_swap_out`` at the device-to-host issue,
``offload_prefetch`` at the prefetcher's arm.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ...utils.logging import logger
from ..fault import injection


def _key_str(key: Hashable) -> str:
    """A key for the log: a token path is shown by its length."""
    if isinstance(key, tuple) and len(key) == 2 and isinstance(key[1], tuple):
        return f"({key[0]!r}, <{len(key[1])} tokens>)"
    return repr(key)


def _as_tensor(rows: Any) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.detach()
    return torch.from_numpy(np.asarray(rows))


class HostPageTier:
    """Bounded host-memory store of canonical-row page payloads.

    Keys are any hashables (the KV swap manager uses ``("kv", uid)`` and
    ``("prefix", token_path)``); values are float32 CPU tensors. Capacity
    is enforced in bytes with LRU eviction; a payload larger than the whole
    tier is rejected outright.
    """

    def __init__(self, capacity_bytes: int, name: str = "host_kv"):
        self.capacity_bytes = int(capacity_bytes)
        self.name = name
        self._store: "OrderedDict[Hashable, torch.Tensor]" = OrderedDict()
        #: (key, host buffer, CUDA event or None, device source kept alive
        #: until the copy has landed)
        self._pending: Optional[Tuple[Hashable, torch.Tensor, Any, Any]] = None
        #: discarded pending transfers whose copies may still be running
        self._retired: List[Tuple[torch.Tensor, Any, Any]] = []
        self.used_bytes = 0
        self.puts = 0
        self.evictions = 0
        self.rejects = 0
        self.swap_out_bytes = 0

    # -- internal -----------------------------------------------------

    def _issue(self, rows: torch.Tensor):
        """Start the device-to-host copy of ``rows`` as float32. → (host
        buffer, event or None, source to keep alive)."""
        if rows.is_cuda:
            src = rows.to(torch.float32)          # a pure cast on the card
            buf = torch.empty(src.shape, dtype=torch.float32,
                              pin_memory=True)
            buf.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return buf, event, src
        return rows.to(torch.float32, copy=True), None, None

    def _materialize(self, key: Hashable, buf: torch.Tensor, event) -> None:
        """Drain a pending transfer into the store (second buffer slot)."""
        if event is not None:
            event.synchronize()
        self._store[key] = buf
        self._store.move_to_end(key)
        self.used_bytes += buf.nbytes
        self.swap_out_bytes += buf.nbytes

    def _prune_retired(self) -> None:
        self._retired = [r for r in self._retired
                         if r[1] is not None and not r[1].query()]

    def _evict_until(self, need: int) -> None:
        while self._store and self.capacity_bytes - self.used_bytes < need:
            old_key, old_rows = self._store.popitem(last=False)
            self.used_bytes -= old_rows.nbytes
            self.evictions += 1
            logger.info("host tier %s: evicted %s (%d bytes) for incoming "
                        "spill", self.name, _key_str(old_key), old_rows.nbytes)

    # -- public -------------------------------------------------------

    @property
    def free_bytes(self) -> int:
        return max(0, self.capacity_bytes - self.used_bytes)

    def put(self, key: Hashable, rows: Any) -> bool:
        """Admit ``rows`` (a tensor on any device, or a numpy array) under
        ``key`` as float32. Returns False when the payload cannot fit (too
        large, or ``host_alloc`` exhaustion injected); raises the
        ``kv_swap_out`` site's fault (``InjectedSwapFailure`` / ``OSError``)
        so the caller can fall back to evict + recompute."""
        try:
            injection.inject("host_alloc")
        except injection.InjectedExhausted:
            self.rejects += 1
            logger.warning("host tier %s: injected host_alloc exhaustion, "
                           "rejecting %s", self.name, _key_str(key))
            return False
        injection.inject("kv_swap_out")

        rows = _as_tensor(rows)
        nbytes = rows.numel() * 4
        if nbytes > self.capacity_bytes:
            self.rejects += 1
            return False
        # drain the previous pending transfer first (its copy has had a
        # whole put interval to run), then issue this one
        self.sync()
        self.discard(key)
        self._evict_until(nbytes)
        self._prune_retired()
        buf, event, src = self._issue(rows)
        self._pending = (key, buf, event, src)
        self.puts += 1
        return True

    def sync(self) -> None:
        """Drain the in-flight device-to-host transfer, if any."""
        if self._pending is not None:
            key, buf, event, _ = self._pending
            self._pending = None
            self._materialize(key, buf, event)

    def get(self, key: Hashable) -> Optional[torch.Tensor]:
        """Pure lookup (no hit/miss accounting: the caller confirms the
        use, as with the prefix cache's ``note_hit``)."""
        self.sync()
        rows = self._store.get(key)
        if rows is not None:
            self._store.move_to_end(key)
        return rows

    def pop(self, key: Hashable) -> Optional[torch.Tensor]:
        self.sync()
        rows = self._store.pop(key, None)
        if rows is not None:
            self.used_bytes -= rows.nbytes
        return rows

    def discard(self, key: Hashable) -> None:
        if self._pending is not None and self._pending[0] == key:
            _, buf, event, src = self._pending
            self._pending = None
            if event is not None:
                # the copy may still be writing into `buf`: keep it (and its
                # source) alive until the event has completed
                self._retired.append((buf, event, src))
            return
        rows = self._store.pop(key, None)
        if rows is not None:
            self.used_bytes -= rows.nbytes

    def __contains__(self, key: Hashable) -> bool:
        self.sync()
        return key in self._store

    def __len__(self) -> int:
        self.sync()
        return len(self._store)

    def stats(self) -> Dict[str, int]:
        return {
            "capacity_bytes": self.capacity_bytes,
            "used_bytes": self.used_bytes,
            "entries": len(self._store) + (1 if self._pending else 0),
            "puts": self.puts,
            "evictions": self.evictions,
            "rejects": self.rejects,
            "swap_out_bytes": self.swap_out_bytes,
        }


__all__ = ["HostPageTier"]


class HostOffloadPrefetcher:
    """Stages the host-resident optimizer state toward the device ahead
    of the update (``offload_optimizer.pipeline_read``; the JAX engine
    arms it before dispatching the step, ``engine.py:936-944``).

    :meth:`arm` is called before the forward: it issues the host-to-device
    copies of the first ring's worth of pieces on the streamed update's
    copy stream, so that they land under the forward and backward. An
    injected ``offload`` fault at the ``offload_prefetch`` site skips the
    stage and counts a failure: the update then reads the host state
    unstaged (the same bits, no overlap). Any other failure raises."""

    def __init__(self) -> None:
        self.arms = 0
        self.failures = 0
        self.bytes_staged = 0

    def arm(self, streamed) -> int:
        """Stage ``streamed``'s first pieces. → the bytes staged."""
        try:
            injection.inject("offload_prefetch")
        except injection.InjectedOffloadFailure:
            self.failures += 1
            logger.warning("offload prefetch: injected failure, the update "
                           "will read the host state unstaged")
            return 0
        self.arms += 1
        staged = streamed.stage()
        self.bytes_staged += staged
        return staged

    def stats(self) -> Dict[str, int]:
        return {"arms": self.arms, "failures": self.failures,
                "bytes_staged": self.bytes_staged}
