"""KV page-heat tracking: per-page last-touch windows over the block pool
(counterpart of ``deepspeed_tpu/inference/v2/ragged/page_heat.py``).

A spill policy has to know *which* KV pages are cold. This module keeps
that book on the host and costs the device nothing: the engine already
walks every sequence's block table when it packs a forward, so the
tracker timestamps those block ids against a monotone window clock in
numpy. It launches no kernel, copies nothing to or from the card and
never waits for it.

Wiring (all host-side):

  * the :class:`~.blocked_allocator.BlockedAllocator` calls
    :meth:`note_alloc` / :meth:`note_ref` / :meth:`note_release` from its
    own allocate/ref/free paths — EVERY holder transition goes through the
    allocator (state manager, prefix-cache trie, copy-on-write grafts,
    flushes), so the tracker's live-page set equals the allocator's by
    construction;
  * the engine ticks the window clock once per dispatched forward
    (prefill ``put``, fused decode window) and touches every block the
    forward's sequences cover — a decode window reads ALL of a sequence's
    context pages, so whole-table touches are the faithful access model.
    Pages of idle sequences and trie-only prefix pages are the ones that
    go cold;
  * ``note_ref`` counts as a touch: a prefix graft is a read of the shared
    page, and — when the page had gone cold — it is the event a host tier
    would have served. The cumulative :attr:`retouch_ages` histogram
    (age at retouch → count) records those events.

Per-tenant attribution is fractional by refcount: a page shared by K
holders charges ``page_bytes / K`` to each holding sequence's tenant, so
physical bytes are counted once while tenants see their fair share.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: cold-set age thresholds (windows since last touch); each gets a
#: cold-page count and a cold-bytes column in :meth:`snapshot`
COLD_AGE_THRESHOLDS: Tuple[int, ...] = (4, 16, 64)

#: cap on the per-page age vector a snapshot carries — larger pools give
#: histograms only
MAX_PAGE_AGES_SERIALIZED = 4096


class PageHeatTracker:
    """Host-side per-page heat state over a fixed block pool."""

    def __init__(self, allocator, block_size: int, page_bytes: int = 0):
        n = allocator.total_blocks
        self._alloc = allocator
        self.block_size = int(block_size)
        #: bytes one logical block occupies across every layer's K+V slabs
        self.page_bytes = int(page_bytes)
        self._live = np.zeros(n, dtype=bool)
        self._last = np.full(n, -1, dtype=np.int64)    # -1 = free
        self._touches = np.zeros(n, dtype=np.int64)
        self._birth = np.full(n, -1, dtype=np.int64)
        #: monotone forward-window clock (ticked by the engine per dispatch)
        self.window = 0
        self.peak_live_pages = 0
        self.touches_total = 0
        self.allocs_total = 0
        self.transfers = 0
        #: CUMULATIVE retouch-age histogram: age (windows since the page's
        #: previous touch) → count; never reset
        self.retouch_ages: Dict[int, int] = {}

    # ------------------------------------------------------------------ #
    # Allocator observer API (called with allocator state already updated)
    # ------------------------------------------------------------------ #
    def note_alloc(self, blocks) -> None:
        """Blocks just handed out at refcount 1 — born hot (the very next
        forward writes into them)."""
        b = np.asarray(blocks, dtype=np.int64)
        if b.size == 0:
            return
        self._live[b] = True
        self._last[b] = self.window
        self._birth[b] = self.window
        self._touches[b] = 1
        self.allocs_total += int(b.size)
        live = int(self._live.sum())
        if live > self.peak_live_pages:
            self.peak_live_pages = live

    def note_ref(self, blocks) -> None:
        """A new holder grafted onto already-live pages (prefix share):
        counts as a touch — the graft is a read, and a retouch of a cold
        page is exactly a would-be host-tier hit."""
        self.touch(blocks)

    def note_release(self, blocks) -> None:
        """Blocks whose LAST holder let go — they returned to the free
        list, so their heat state dies with them."""
        b = np.asarray(blocks, dtype=np.int64)
        if b.size == 0:
            return
        self._live[b] = False
        self._last[b] = -1
        self._birth[b] = -1
        self._touches[b] = 0

    # ------------------------------------------------------------------ #
    # Engine-side touch path
    # ------------------------------------------------------------------ #
    def tick(self) -> int:
        """Advance the window clock (one per dispatched forward)."""
        self.window += 1
        return self.window

    def touch(self, blocks) -> None:
        """Timestamp ``blocks`` at the current window; a page whose
        previous touch was an earlier window records its age in
        :attr:`retouch_ages` first."""
        b = np.asarray(list(blocks) if not isinstance(blocks, np.ndarray)
                       else blocks, dtype=np.int64)
        if b.size == 0:
            return
        b = np.unique(b)
        if not self._live[b].all():
            dead = [int(x) for x in b[~self._live[b]]]
            raise ValueError(f"touch of non-live page(s) {dead} — heat map "
                             f"out of sync with the allocator free list")
        ages = self.window - self._last[b]
        re = ages[ages >= 1]
        if re.size:
            vals, counts = np.unique(re, return_counts=True)
            for a, c in zip(vals, counts):
                a = int(a)
                self.retouch_ages[a] = self.retouch_ages.get(a, 0) + int(c)
        self._last[b] = self.window
        self._touches[b] += 1
        self.touches_total += int(b.size)

    def transfer(self, src_block: int, dst_block: int) -> None:
        """Copy-on-write materialization: the private copy inherits the
        shared page's heat (same rows, same access history)."""
        if not self._live[dst_block]:
            raise ValueError(f"heat transfer into non-live page {dst_block}")
        if self._live[src_block]:
            self._last[dst_block] = self._last[src_block]
            self._touches[dst_block] = self._touches[src_block]
        self.transfers += 1

    # ------------------------------------------------------------------ #
    # Reading
    # ------------------------------------------------------------------ #
    def live_pages(self) -> set:
        """The tracker's view of allocated page ids (equal to the
        allocator's non-free set whenever the engine is between calls)."""
        return set(int(b) for b in np.nonzero(self._live)[0])

    def page_ages_for(self, blocks) -> np.ndarray:
        """Ages (windows since last touch) for ``blocks``; -1 for free
        pages.  The host-tier spiller ranks a victim's pages with this
        (coldest first) before exporting."""
        b = np.asarray(list(blocks), dtype=np.int64)
        ages = np.full(b.size, -1, dtype=np.int64)
        if b.size:
            live = self._live[b]
            ages[live] = self.window - self._last[b[live]]
        return ages

    def cold_pages(self, age_threshold: int) -> int:
        idx = np.nonzero(self._live)[0]
        if idx.size == 0:
            return 0
        return int(((self.window - self._last[idx])
                    >= int(age_threshold)).sum())

    def snapshot(self, holders: Optional[Dict[int, List[int]]] = None,
                 tenants: Optional[Dict[int, str]] = None) -> Dict[str, Any]:
        """Serializable heat view.  ``holders`` maps uid → block table
        (the state manager's live descriptors) and ``tenants`` maps uid →
        tenant label; together they drive the fractional-by-refcount
        per-tenant attribution.  JSON-safe: dict keys are strings."""
        idx = np.nonzero(self._live)[0]
        live = int(idx.size)
        ages = (self.window - self._last[idx]) if live else \
            np.zeros(0, dtype=np.int64)
        refs = self._alloc.refcounts()

        # power-of-two age histogram: bin label = lower bound
        hist: Dict[str, int] = {}
        if live:
            bins = np.where(ages <= 0, 0,
                            2 ** np.floor(np.log2(np.maximum(ages, 1)))
                            .astype(np.int64))
            for v, c in zip(*np.unique(bins, return_counts=True)):
                hist[str(int(v))] = int(c)

        cold = {str(t): int((ages >= t).sum())
                for t in COLD_AGE_THRESHOLDS}
        shared = refs[idx] > 1 if live else np.zeros(0, dtype=bool)
        extra_refs = int((refs[idx][shared] - 1).sum()) if live else 0

        tenant_attr: Dict[str, Dict[str, Any]] = {}
        if holders:
            tenants = tenants or {}
            for uid, blocks in holders.items():
                if not blocks:
                    continue
                t = str(tenants.get(uid, "default"))
                frac = float(sum(1.0 / max(int(refs[b]), 1) for b in blocks))
                d = tenant_attr.setdefault(t, {"pages": 0.0, "bytes": 0})
                d["pages"] += frac
            for d in tenant_attr.values():
                d["pages"] = round(d["pages"], 4)
                d["bytes"] = int(round(d["pages"] * self.page_bytes))

        snap: Dict[str, Any] = {
            "window": int(self.window),
            "total_pages": int(self._live.size),
            "live_pages": live,
            "peak_live_pages": int(self.peak_live_pages),
            "page_bytes": int(self.page_bytes),
            "block_size": int(self.block_size),
            "used_bytes": live * self.page_bytes,
            "age_histogram": hist,
            "cold_pages": cold,
            "cold_bytes": {k: v * self.page_bytes for k, v in cold.items()},
            "shared_pages": int(shared.sum()) if live else 0,
            "prefix_shared_bytes_saved": extra_refs * self.page_bytes,
            "retouch_ages": {str(a): int(c)
                             for a, c in sorted(self.retouch_ages.items())},
            "touches_total": int(self.touches_total),
            "allocs_total": int(self.allocs_total),
            "transfers": int(self.transfers),
            "tenants": tenant_attr,
        }
        if self._live.size <= MAX_PAGE_AGES_SERIALIZED:
            # per-page age vector (-1 = free): exact cold-set counts at any
            # threshold
            page_ages = np.full(self._live.size, -1, dtype=np.int64)
            page_ages[idx] = ages
            snap["page_ages"] = [int(a) for a in page_ages]
        return snap
