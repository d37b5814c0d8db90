"""Radix prefix cache over committed KV pages (counterpart of
``deepspeed_tpu/inference/v2/ragged/prefix_cache.py``).

Serving traffic shares long prompt prefixes — system prompts, few-shot
preambles, conversation history — and recomputing their KV on every
request costs prefill time. This cache makes committed KV pages
content-addressable: a token trie whose nodes each own ONE cache page, so
admission can graft the longest cached prefix into a new sequence instead
of recomputing it.

Structure
  * Interior nodes are FULL pages (``block_size`` tokens); leaves may be
    partial — the tail of a prompt that stops mid-page. A node's edge
    label is the token tuple its page attests; ``claim`` is how many rows
    of the page those tokens cover (rows past ``claim`` are dead — a
    finished request's decode tokens, never readable through this node).
  * Every node holds one allocator reference on its block
    (``BlockedAllocator.ref``), so a page can outlive the sequence that
    produced it; sequences grafting the page add their own reference.

Sharing invariants
  * Shared FULL pages are never written: appends land at row
    ``seen_tokens % block_size`` of the tail page, and a grafted full-page
    prefix ends exactly at a page boundary.
  * A grafted PARTIAL page would be appended into mid-page, so the graft
    copies it first (copy-on-write: the engine materializes a private
    copy of the page before the sequence's first append — see
    ``InferenceEngineV2.graft_prefix``). The trie's original page is
    never mutated by any grafting sequence.
  * A node is evictable only when the trie is the block's ONLY holder
    (allocator refcount 1) and it has no children; eviction is LRU over
    node last use. ``DSStateManager.maybe_allocate_kv`` evicts on demand,
    so cached pages are free capacity, not pressure.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from ....utils.logging import logger


@dataclasses.dataclass
class _Node:
    tokens: Tuple[int, ...]          # edge label == attested page rows
    block: int                       # logical page id (layer-relative)
    claim: int                       # valid rows (== len(tokens))
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = \
        dataclasses.field(default_factory=dict)
    last_used: int = 0

    @property
    def full(self) -> bool:
        return self.claim == len(self.tokens)  # always true; kept for repr

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"_Node(block={self.block}, claim={self.claim}, "
                f"children={len(self.children)})")


class RadixPrefixCache:
    """Token trie over committed KV pages with per-page refcounts.

    One instance per engine, owned by :class:`DSStateManager`; all calls
    run on the scheduler thread (the same single-threaded discipline
    as the allocator itself).
    """

    def __init__(self, allocator, block_size: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._root = _Node(tokens=(), block=-1, claim=0, parent=None)
        self._clock = itertools.count(1)
        self._nodes = 0
        #: optional spill hook (KVSwapManager.spill_prefix_node when a host
        #: tier is configured): called with the node just before its page
        #: is freed, so eviction parks shared prefixes host-side instead of
        #: dropping them
        self.spill_fn = None
        # cumulative stats
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evicted = 0

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    @property
    def nodes(self) -> int:
        return self._nodes

    def cached_blocks(self) -> List[int]:
        out: List[int] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                out.append(n.block)
            stack.extend(n.children.values())
        return out

    def reclaimable_blocks(self) -> int:
        """Pages the cache could release right now: trie-only holders
        (allocator refcount 1) on childless nodes, counted transitively —
        freeing a leaf makes its parent childless, so a whole cold chain
        counts.  This is the slack KV-pressure accounting may subtract."""
        count = 0

        def walk(node: _Node) -> bool:
            """Returns True when the whole subtree under (and including)
            ``node`` is reclaimable."""
            nonlocal count
            sub_ok = all([walk(c) for c in list(node.children.values())])
            if node is self._root:
                return sub_ok
            ok = sub_ok and self.allocator.refcount(node.block) == 1
            if ok:
                count += 1
            return ok

        walk(self._root)
        return count

    # ------------------------------------------------------------------ #
    # Match / graft
    # ------------------------------------------------------------------ #
    def match(self, tokens: List[int]) -> Tuple[int, List[int], int]:
        """Longest cached prefix of ``tokens``.

        Returns ``(matched_tokens, blocks, partial_rows)``: the grafted
        block list covers ``matched_tokens`` rows, of which the LAST page
        holds ``partial_rows`` when the match ends mid-page (0 = ends on a
        page boundary).  At least one token is always left for the caller
        to prefill — logits for the next token have to come from a real
        forward — so ``matched_tokens <= len(tokens) - 1``.

        Pure lookup: hit/miss statistics are recorded by the caller via
        :meth:`note_hit`/:meth:`note_miss` once a graft actually sticks —
        a backpressured admission retries ``match`` every scheduler pass,
        and counting those retries would inflate the hit rate.
        """
        bs = self.block_size
        limit = len(tokens) - 1          # must leave >= 1 token to prefill
        node = self._root
        blocks: List[int] = []
        matched = 0
        now = next(self._clock)
        while True:
            nxt = tuple(tokens[matched:matched + bs])
            child = node.children.get(nxt) \
                if len(nxt) == bs and matched + bs <= limit else None
            if child is not None:
                # full-page hop
                node = child
                node.last_used = now
                blocks.append(node.block)
                matched += bs
                continue
            # no full-page child fits: take the LONGEST partial child that
            # is a prefix of the remaining tokens (and under the limit)
            best = None
            for key, child in node.children.items():
                if len(key) >= bs:
                    continue
                if matched + len(key) > limit:
                    continue
                if tuple(tokens[matched:matched + len(key)]) == key:
                    if best is None or len(key) > len(best.tokens):
                        best = child
            if best is None:
                break
            best.last_used = now
            blocks.append(best.block)
            matched += len(best.tokens)
            return matched, blocks, len(best.tokens)
        return matched, blocks, 0

    def note_hit(self, tokens_saved: int) -> None:
        """Record one request's confirmed graft (see :meth:`match`)."""
        self.hits += 1
        self.tokens_saved += int(tokens_saved)

    def note_miss(self) -> None:
        self.misses += 1

    # ------------------------------------------------------------------ #
    # Commit
    # ------------------------------------------------------------------ #
    def commit(self, tokens: List[int], blocks: List[int],
               upto: Optional[int] = None,
               allow_partial: bool = False) -> int:
        """Attest ``tokens[:upto]`` as cached KV living in ``blocks``.

        Walks page-by-page: pages already in the trie are left alone
        (first committer wins — concurrent identical prompts race to the
        same content, and the loser's private copy is simply freed with
        its sequence); missing pages are inserted, each insertion taking
        one allocator reference so the page survives its sequence.  Full
        pages always commit; the trailing partial page only with
        ``allow_partial`` (used at retirement, when the committing
        sequence will never append into it again).  Returns the number of
        pages newly inserted.
        """
        bs = self.block_size
        upto = len(tokens) if upto is None else min(int(upto), len(tokens))
        node = self._root
        inserted = 0
        pos = 0
        page = 0
        now = next(self._clock)
        while pos < upto:
            n = min(bs, upto - pos)
            if n < bs and not allow_partial:
                break
            key = tuple(tokens[pos:pos + n])
            child = node.children.get(key)
            if child is None and n < bs:
                # a shorter partial already attesting a prefix of this key
                # stays (first committer wins); only insert when nothing
                # on this edge overlaps
                overlap = any(len(k) < bs and
                              (k == key[:len(k)] or key == k[:len(key)])
                              for k in node.children)
                if overlap:
                    break
            if child is None:
                if page >= len(blocks):  # caller shipped fewer blocks
                    break
                self.allocator.ref([blocks[page]])
                child = _Node(tokens=key, block=int(blocks[page]),
                              claim=n, parent=node, last_used=now)
                node.children[key] = child
                self._nodes += 1
                inserted += 1
            else:
                child.last_used = now
            node = child
            if n < bs:
                break                     # partial pages are always leaves
            pos += n
            page += 1
        return inserted

    # ------------------------------------------------------------------ #
    # Eviction
    # ------------------------------------------------------------------ #
    def evict(self, n_blocks: int, keep=()) -> int:
        """Free up to ``n_blocks`` cached pages back to the pool, coldest
        first.  Only childless nodes whose block has no holder besides the
        trie (allocator refcount 1) are eligible — a page some live
        sequence still references is NEVER evicted, whatever the
        pressure — and none whose block is in ``keep`` (a graft's matched
        chain, which no sequence holds yet).  Freeing a leaf can expose
        its parent; the scan repeats until satisfied or dry."""
        keep = set(int(b) for b in keep)
        freed = 0
        while freed < n_blocks:
            victims = [n for n in self._iter_nodes()
                       if not n.children and n.block not in keep
                       and self.allocator.refcount(n.block) == 1]
            if not victims:
                break
            victims.sort(key=lambda n: n.last_used)
            for node in victims:
                if freed >= n_blocks:
                    break
                self._drop(node)
                freed += 1
        if freed:
            self.evicted += freed
            logger.debug(f"prefix cache: evicted {freed} page(s) "
                         f"({self._nodes} cached)")
        return freed

    def clear(self) -> int:
        """Drop every node whose page has no live holder; returns pages
        freed (used by tests and by engine teardown)."""
        return self.evict(self._nodes)

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _drop(self, node: _Node) -> None:
        assert not node.children, "evicting an interior node"
        if self.spill_fn is not None:
            try:
                self.spill_fn(node)       # reads the page while it's live
            except Exception as e:        # spill is best-effort: eviction
                logger.warning(           # must proceed regardless
                    f"prefix cache: host spill failed ({e}); dropping")
        del node.parent.children[node.tokens]
        self.allocator.free([node.block])
        self._nodes -= 1
