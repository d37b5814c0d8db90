"""Cold-KV swap: host-tier spill and restore (counterpart of
``deepspeed_tpu/inference/v2/ragged/kv_swap.py``).

Preemption under KV pressure would pay a whole prefill recompute at
resume. This module turns it into a *swap*: before the scheduler flushes a
victim, its cold pages (ranked by ``page_heat`` age, coldest first) are
exported in ``kv_ship`` canonical row space (float32, the fp32 wire) and
parked in the :class:`~deepspeed_tpu_torch.runtime.swap_tensor.host_tier.
HostPageTier`; resume becomes a host-to-device copy and a page-table patch
(``import_kv``), and the stream continues bit-exactly from the saved seed
token.

A spilled page IS a ``KVShipment`` row slab, so the host tier and
disaggregated prefill speak one layout, and the re-attestation of
``restore`` (the parked tokens must match the resuming prompt) guards swap
as it guards a hand-off between replicas.

The radix prefix cache composes: its evictions spill shared full pages
here instead of dropping them (:meth:`KVSwapManager.spill_prefix_node`,
installed as ``RadixPrefixCache.spill_fn``), and ``graft_prefix`` extends
a trie match through host-resident pages.

Every failure path degrades to the behaviour without a tier (evict +
prefill recompute), slower but equally exact; the ``kv_swap_out`` /
``kv_swap_in`` / ``host_alloc`` fault sites force those paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ....runtime.fault import injection
from ....utils.logging import logger
from ..kv_ship import KVShipment, export_kv, import_kv


@dataclasses.dataclass
class SwapEntry:
    """Book-keeping for one swapped-out sequence."""

    tokens: List[int]        # attested ids covering the spilled rows
    n_tokens: int
    nbytes: int


class KVSwapManager:
    """Spill/restore coordinator between one engine and the host tier.

    Owned by :class:`~deepspeed_tpu_torch.inference.v2.engine_v2.
    InferenceEngineV2` when ``config.host_tier_mb > 0``; a scheduler calls
    ``spill`` at preemption and ``restore`` at resume. All calls run on
    the scheduler's thread, as the allocator's do.
    """

    def __init__(self, engine, tier):
        self.eng = engine
        self.tier = tier
        self._entries: Dict[int, SwapEntry] = {}
        self.swapped_out = 0
        self.swapped_in = 0
        self.misses = 0
        self.spill_failures = 0
        self.swap_in_bytes = 0
        self.avoided_recompute_tokens = 0
        self.prefix_spilled = 0
        self.prefix_restored = 0

    # ------------------------------------------------------------------ #
    # Geometry helpers
    # ------------------------------------------------------------------ #
    def _page_row_bytes(self) -> int:
        """Bytes one logical page occupies in canonical row space (all
        layers, K+V, float32)."""
        c = self.eng.kv.config
        return (self.eng.cfg.num_layers * self.eng.config.block_size
                * 2 * c.num_kv_heads * c.head_dim * 4)

    # ------------------------------------------------------------------ #
    # Sequence spill / restore
    # ------------------------------------------------------------------ #
    def spill(self, uid: int, tokens: List[int]) -> int:
        """Export ``uid``'s coldest contiguous prefix into the host tier.

        Called BEFORE the victim is flushed (the export is a pure read).
        Pages are chosen coldest first by heat age, capped at what the tier
        can hold, then cut to the longest contiguous page prefix — restore
        grafts a token-contiguous prefix from token 0, so a kept page is
        only useful if every earlier page is kept too. Returns the number
        of tokens parked (0 = nothing spilled; the caller evicts)."""
        seq = self.eng.state_manager.get_sequence(uid)
        if seq is None or seq.seen_tokens == 0:
            return 0
        n_max = min(len(tokens), seq.seen_tokens)
        if n_max <= 0:
            return 0
        bs = self.eng.config.block_size
        n_pages = -(-n_max // bs)
        pages = list(seq.blocks[:n_pages])
        heat = getattr(self.eng, "heat", None)
        ages = (heat.page_ages_for(pages) if heat is not None
                else np.zeros(len(pages), dtype=np.int64))
        page_bytes = self._page_row_bytes()
        budget = self.tier.capacity_bytes
        # coldest first; ties broken toward EARLIER pages, the ones a
        # contiguous-prefix restore can use
        order = sorted(range(len(pages)), key=lambda i: (-int(ages[i]), i))
        admitted = set()
        spent = 0
        for i in order:
            if spent + page_bytes > budget:
                break
            admitted.add(i)
            spent += page_bytes
        k = 0
        while k in admitted:
            k += 1
        if k == 0:
            return 0
        n_spill = min(n_max, k * bs)
        try:
            ship = export_kv(self.eng, uid, tokens, n_tokens=n_spill)
            if not self.tier.put(("kv", uid), ship.rows):
                return 0
        except (injection.InjectedSwapFailure, OSError) as e:
            self.spill_failures += 1
            self.misses += 1
            logger.warning(f"kv swap: spill of uid={uid} failed ({e}); "
                           f"falling back to evict+recompute")
            return 0
        nbytes = ship.rows.numel() * 4
        self._entries[uid] = SwapEntry(tokens=list(ship.tokens),
                                       n_tokens=ship.n_tokens, nbytes=nbytes)
        self.swapped_out += 1
        logger.info(f"kv swap: spilled uid={uid} n={ship.n_tokens} tokens "
                    f"({nbytes} B, {k}/{len(pages)} pages)")
        return ship.n_tokens

    def restore(self, uid: int, resume_prompt: List[int]) -> int:
        """Graft ``uid``'s parked rows back as a fresh sequence.

        Returns the tokens restored; 0 means the caller must recompute —
        EXCEPT when an entry still exists (transient pool exhaustion: the
        caller should backpressure and retry, the parked rows stay valid)."""
        entry = self._entries.get(uid)
        if entry is None:
            return 0
        try:
            injection.inject("kv_swap_in")
        except (injection.InjectedSwapFailure, OSError) as e:
            self.drop(uid)
            self.misses += 1
            logger.warning(f"kv swap: restore of uid={uid} failed ({e}); "
                           f"recomputing prefill")
            return 0
        rows = self.tier.get(("kv", uid))
        if rows is None:                      # LRU-evicted under pressure
            self._entries.pop(uid, None)
            self.misses += 1
            return 0
        # >= 1 token must go through a real forward (logits for the next
        # token), as kv_ship's import requires; the decode seed itself is
        # the caller's, so exactness is untouched
        n = min(entry.n_tokens, len(resume_prompt) - 1)
        if n <= 0 or entry.tokens[:n] != [int(t) for t in resume_prompt[:n]]:
            self.drop(uid)
            self.misses += 1
            logger.warning(f"kv swap: uid={uid} parked rows fail "
                           f"re-attestation; recomputing prefill")
            return 0
        c = self.eng.kv.config
        ship = KVShipment(tokens=list(entry.tokens[:n]),
                          num_layers=self.eng.cfg.num_layers,
                          num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                          src_block_size=self.eng.config.block_size,
                          wire="fp32", rows=rows[:, :n])
        if not import_kv(self.eng, ship, uid):
            return 0          # transient exhaustion: entry kept, retry
        self.tier.pop(("kv", uid))
        self._entries.pop(uid, None)
        self.swapped_in += 1
        self.swap_in_bytes += ship.rows.numel() * 4
        self.avoided_recompute_tokens += n
        return n

    def entry(self, uid: int) -> Optional[SwapEntry]:
        return self._entries.get(uid)

    def drop(self, uid: int) -> None:
        """Terminal cleanup (request retired or cancelled while parked)."""
        self._entries.pop(uid, None)
        self.tier.discard(("kv", uid))

    # ------------------------------------------------------------------ #
    # Prefix-cache spill path
    # ------------------------------------------------------------------ #
    def spill_prefix_node(self, node) -> None:
        """``RadixPrefixCache.spill_fn`` hook: called just before the trie
        frees an evicted page. Full pages are parked under their root-path
        token tuple so ``graft_prefix`` can pull them back; partial tail
        pages are not worth a host round trip."""
        bs = self.eng.config.block_size
        if node.claim != bs or len(node.tokens) != bs:
            return
        path: Tuple[int, ...] = ()
        walk = node
        chain = []
        while walk is not None and walk.tokens:
            chain.append(walk.tokens)
            walk = walk.parent
        for seg in reversed(chain):
            path = path + tuple(seg)
        with torch.inference_mode():
            rows = self.eng.kv.pages[self.eng.kv.phys_pages([node.block])]
        try:
            if self.tier.put(("prefix", path), rows):
                self.prefix_spilled += 1
        except (injection.InjectedSwapFailure, OSError):
            self.spill_failures += 1

    def peek_prefix(self, path: Tuple[int, ...]) -> Optional[torch.Tensor]:
        """Rows ``[L, block_size, 2*KV, HD]`` (float32, host) of a spilled
        prefix page, or None. Pure lookup; call :meth:`confirm_prefix` once
        grafted."""
        return self.tier.get(("prefix", tuple(path)))

    def confirm_prefix(self, path: Tuple[int, ...]) -> None:
        self.tier.pop(("prefix", tuple(path)))
        self.prefix_restored += 1

    # ------------------------------------------------------------------ #
    # Accounting
    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        hits = self.swapped_in
        total = hits + self.misses
        return {
            "swapped_out": self.swapped_out,
            "swapped_in": hits,
            "misses": self.misses,
            "spill_failures": self.spill_failures,
            "hit_rate": hits / max(1, total) if total else 1.0,
            "swap_out_bytes": self.tier.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "avoided_recompute_tokens": self.avoided_recompute_tokens,
            "prefix_spilled": self.prefix_spilled,
            "prefix_restored": self.prefix_restored,
            "entries": len(self._entries),
            "host_used_bytes": self.tier.used_bytes,
            "host_capacity_bytes": self.tier.capacity_bytes,
        }


__all__ = ["KVSwapManager", "SwapEntry"]
