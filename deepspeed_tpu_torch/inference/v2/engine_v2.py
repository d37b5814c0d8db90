"""Continuous-batching inference engine on PyTorch and CUDA (counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py``).

Reference: ``InferenceEngineV2`` (inference/v2/engine_v2.py:30): ``put``
runs one forward over a ragged batch, ``query`` exposes the scheduling
budget, ``can_schedule``/``SchedulingResult`` gate admission, ``flush``
evicts host state. Dynamic SplitFuse (the MII scheduler policy) lives in
:meth:`InferenceEngineV2.schedule` and :class:`ContinuousBatcher`: long
prompts are split into token-budget chunks and fused with pending decodes.
When every live sequence is decoding, the batcher runs a fused decode
window (:meth:`InferenceEngineV2.decode_batch_async`) whose sampling and
metadata advance never leave the device.

Prefix reuse and the KV memory tier (``prefix_cache``, ``track_page_heat``,
``host_tier_mb``): committed prompt pages form a radix trie that admission
grafts from (:meth:`InferenceEngineV2.graft_prefix`, then ``put`` of the
remainder, :meth:`InferenceEngineV2.commit_prefix` at prefill end and at
retirement); a host-side heat map ranks pages by age; under pool pressure
cached prefix pages spill to host memory (``ragged/kv_swap.py``) and graft
back. The ``decode_window`` and ``kv_alloc`` fault sites
(``runtime/fault/injection.py``) poison a window or exhaust the pool.

Every drained decode window feeds the analytic HBM roofline
(``profiling/serving_roofline.py``): ``last_decode_roofline`` holds the
newest report, which the lifecycle scheduler reads as its predicted drain
rate. A window flagged ``compiled`` (the first of its decode-loop key in
the process, which also pays the first-use build and load of the kernel
libraries on the card) is kept off that rate and off the hang check.

Speculative decoding (``speculative.py`` drives it):
:meth:`InferenceEngineV2.verify_decode` scores each sequence's seed and
draft tokens in one forward and accepts the longest prefix that matches
the greedy argmax; :meth:`InferenceEngineV2.rollback_kv` truncates the
rejected rows.

The engine runs eagerly under ``torch.inference_mode()``; the page pool is
updated in place. Batches keep the JAX package's bucketed budgets, so both
engines pad every batch the same way.
"""
from __future__ import annotations

import dataclasses
import time
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import get_accelerator
from ...models.families import ArchConfig
from ...models.transformer import CausalLM, TransformerConfig, leaf_dtype
from ...runtime.fault.injection import InjectedNaN, inject
from ...utils.logging import logger
from .model_runner import (build_decode_loop, build_ragged_step,
                           build_verify_step, sample_tokens)
from .ragged.kv_cache import BlockedKVCache, KVCacheConfig
from .ragged.ragged_wrapper import RaggedBatchWrapper
from .ragged.sequence_descriptor import DSStateManager

#: decode-loop and verify-bucket keys that have run in this process. The
#: first window of a key is flagged ``compiled``: in the JAX package it
#: traces and compiles its program; here it may pay the first-use build
#: and load of the CUDA kernel libraries (``ops/op_builder/builder.py``)
#: and the allocator's first segments at its shapes, so its wall time says
#: nothing about decode throughput
_KEYS_RUN: set = set()


def _first_use(key: Tuple) -> bool:
    """True the first time ``key`` is seen in this process."""
    if key in _KEYS_RUN:
        return False
    _KEYS_RUN.add(key)
    return True


class SchedulingResult(Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    KVCacheLimitExceeded = 3
    SequenceTooLong = 4


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    """Reference: inference/v2/config_v2.py. The fields the port serves
    with, with the JAX package's defaults."""

    max_tokens: int = 256            # token budget per forward (SplitFuse chunk)
    max_seqs: int = 16
    max_ctx: int = 2048
    block_size: int = 64
    num_blocks: Optional[int] = None  # default: enough for max_seqs * max_ctx
    dtype: torch.dtype = torch.bfloat16
    #: "paged" = the hand-written CUDA paged-attention kernels;
    #: "gather" = dense page-gather reference path (numerics oracle).
    attn_impl: str = "paged"
    #: pad each forward's token budget to the next power-of-two bucket
    #: instead of always padding to max_tokens; decode windows also bucket
    #: the seq axis so they carry the live-sequence count, not max_tokens
    bucket_tokens: bool = True
    min_token_bucket: int = 16
    #: on-device sampling default for fused decode: 0 = full-vocab
    #: categorical (or argmax at temperature 0), k>0 = top-k sampling
    top_k: int = 0
    #: radix prefix KV reuse: committed prompt pages become a token trie
    #: (ragged/prefix_cache.py) that admission grafts from instead of
    #: recomputing shared prefixes. Pages are refcounted; a grafted partial
    #: page is copied before the sequence's first append (copy-on-write),
    #: and cold cache pages are evicted under allocation pressure.
    prefix_cache: bool = False
    #: host-side KV page-heat tracking (ragged/page_heat.py): per-page
    #: last-touch window and touch count from the block tables the engine
    #: already walks — no device work, no device sync
    track_page_heat: bool = True
    #: host-memory page tier capacity in MB (0 = tier off). When on, a
    #: sequence's coldest contiguous page prefix can be spilled in kv_ship
    #: canonical rows to host memory and restored (ragged/kv_swap.py), and
    #: prefix-cache evictions spill shared full pages host-side
    host_tier_mb: float = 0.0


class InferenceEngineV2:
    """Serves a :class:`CausalLM` (a ``TransformerConfig`` model) or a
    ``models.families.UniversalCausalLM`` (an ``ArchConfig`` model: gpt2,
    gptj, opt, bloom, falcon, phi) from a paged KV cache; the pool takes
    the model's KV heads and head dim.

    ``device=None`` means CUDA and raises when CUDA is absent; the CPU runs
    only when named (``device="cpu"``). The model's parameters are moved to
    the device and cast to ``config.dtype`` in place, a MoE router kept
    float32."""

    def __init__(self, model: CausalLM,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 device=None):
        self.device = get_accelerator().resolve_device(device)
        self.model = model
        self.cfg = model.config
        if not isinstance(self.cfg, (TransformerConfig, ArchConfig)):
            raise NotImplementedError(
                f"ragged serving needs a TransformerConfig (llama families) "
                f"or ArchConfig (gpt2/gptj/opt/bloom/falcon/phi) model; got "
                f"{type(self.cfg).__name__}")
        self.config = config or RaggedInferenceEngineConfig()
        c = self.config
        if c.attn_impl not in ("paged", "gather"):
            raise ValueError(
                f"attn_impl must be 'paged' or 'gather', got {c.attn_impl!r}")
        # default: enough pages for max_seqs sequences of max_ctx tokens
        num_blocks = c.num_blocks or (c.max_seqs * -(-c.max_ctx
                                                     // c.block_size))
        self.state_manager = DSStateManager(num_blocks=num_blocks,
                                            block_size=c.block_size)
        if c.prefix_cache:
            from .ragged.prefix_cache import RadixPrefixCache

            self.state_manager.prefix_cache = RadixPrefixCache(
                self.state_manager.allocator, c.block_size)
        self.kv = BlockedKVCache(KVCacheConfig(
            num_layers=self.cfg.num_layers, num_blocks=num_blocks,
            block_size=c.block_size, num_kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.head_dim, dtype=c.dtype), device=self.device)
        #: page-heat tracker (None = tracking off): observes the allocator
        #: so its live set follows the free list, ticked per forward
        self.heat = None
        #: uid → tenant label for fractional per-tenant KV attribution
        self._uid_tenants: Dict[int, str] = {}
        if c.track_page_heat:
            from .ragged.page_heat import PageHeatTracker

            self.heat = PageHeatTracker(
                self.state_manager.allocator, block_size=c.block_size,
                page_bytes=self.kv.mem_bytes() // num_blocks)
            self.state_manager.allocator.heat = self.heat
        #: host-memory page tier + swap coordinator (None = tier off)
        self.host_tier = None
        self.kv_swap = None
        if c.host_tier_mb > 0:
            from ...runtime.swap_tensor.host_tier import HostPageTier
            from .ragged.kv_swap import KVSwapManager

            self.host_tier = HostPageTier(int(c.host_tier_mb * 1e6))
            self.kv_swap = KVSwapManager(self, self.host_tier)
            if self.state_manager.prefix_cache is not None:
                self.state_manager.prefix_cache.spill_fn = \
                    self.kv_swap.spill_prefix_node
        # router leaves stay float32 (``transformer.leaf_dtype``), as the
        # JAX engine keeps them: a bf16 round trip flips top-k selection
        model.to(device=self.device)
        for name, p in model.named_parameters():
            p.data = p.data.to(leaf_dtype(name, c.dtype))
        self._param_bytes = sum(p.numel() * p.element_size()
                                for p in model.parameters())
        #: the newest drained decode window's HBM roofline report
        #: (``profiling/serving_roofline.py``), None before the first
        self.last_decode_roofline: Optional[Dict] = None
        self._num_blocks = num_blocks
        self._wrappers: Dict[Tuple[int, int], RaggedBatchWrapper] = {}
        #: device-resident continuous-decode state: the advanced packed
        #: metadata of the last fused window, reusable by the next window
        #: with NO host repack / upload (see decode_batch_async)
        self._decode_state: Optional[Dict] = None
        self.decode_resume_hits = 0
        #: monotonically increasing fused-window index — the ``step`` passed
        #: to the ``decode_window`` fault-injection site
        self.decode_windows_dispatched = 0
        #: persistent sampling generator (re-seeding each window with a
        #: constant would repeat the identical sample stream every call)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        #: the last generate() call's ContinuousBatcher.stats (wall time
        #: and tokens of its SplitFuse forwards and fused decode windows)
        self.last_generate_stats: Optional[Dict] = None
        logger.info(f"InferenceEngineV2: device={self.device} "
                    f"blocks={num_blocks}×{c.block_size} "
                    f"budget={c.max_tokens}tok/{c.max_seqs}seq "
                    f"kv={self.kv.mem_bytes() / 1e6:.0f}MB "
                    f"attn={c.attn_impl}")

    # ------------------------------------------------------------------ #
    # Bucketing (the same padded budgets as the JAX engine)
    # ------------------------------------------------------------------ #
    def bucket_for(self, n_tokens: int, n_seqs: int) -> Tuple[int, int]:
        """(token, seq) budgets of a batch: tokens round up to the next
        power-of-two bucket, seqs stay at the engine budget."""
        c = self.config
        if not c.bucket_tokens:
            return (c.max_tokens, c.max_seqs)
        t = max(c.min_token_bucket, 1)
        while t < n_tokens:
            t *= 2
        return (min(t, c.max_tokens), c.max_seqs)

    def _seq_bucket(self, n_seqs: int) -> int:
        """Decode windows bucket the seq axis: their flat token budget IS
        the seq count."""
        c = self.config
        if not c.bucket_tokens:
            return c.max_seqs
        s = 1
        while s < n_seqs:
            s *= 2
        return min(s, c.max_seqs)

    def _wrapper_for(self, key: Tuple[int, int]) -> RaggedBatchWrapper:
        if key not in self._wrappers:
            self._wrappers[key] = RaggedBatchWrapper(
                key[0], key[1], self.config.max_ctx, self.config.block_size,
                pad_page=self.kv.config.pad_page_flag)
        return self._wrappers[key]

    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        """The forward's ONE host-to-device copy: the packed metadata."""
        return torch.from_numpy(packed).to(self.device)

    # ------------------------------------------------------------------ #
    # Admission control (reference :158-242)
    # ------------------------------------------------------------------ #
    def query(self, uid: int, max_request_tokens: int, max_request_seqs: int):
        """Return (max_length, free_blocks) budget info for a uid."""
        seq = self.state_manager.get_sequence(uid)
        seen = seq.seen_tokens if seq else 0
        return self.config.max_ctx - seen, self.state_manager.free_blocks

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> SchedulingResult:
        if len(uids) > self.config.max_seqs:
            return SchedulingResult.BatchSequenceLimitExceeded
        blocks_needed = 0
        for uid, n in zip(uids, lengths):
            seq = self.state_manager.get_sequence(uid)
            seen = seq.seen_tokens if seq else 0
            if seen + n > self.config.max_ctx:
                return SchedulingResult.SequenceTooLong
            cur = seq.cur_allocated_blocks if seq else 0
            blocks_needed += max(-(-(seen + n) // self.config.block_size) - cur,
                                 0)
        if blocks_needed > self.state_manager.free_blocks:
            return SchedulingResult.KVCacheLimitExceeded
        return SchedulingResult.Success

    # ------------------------------------------------------------------ #
    # Core forward (reference put :107)
    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def put(self, uids: Sequence[int],
            tokens_list: Sequence[Sequence[int]]) -> torch.Tensor:
        """One forward over the given sequence chunks → last-token logits
        [n_seqs, vocab] (float32, on the engine's device) in input order."""
        verdict = self.can_schedule(uids, [len(t) for t in tokens_list])
        if verdict != SchedulingResult.Success:
            raise RuntimeError(f"cannot schedule batch: {verdict}")
        self._decode_state = None      # host forward invalidates device meta
        bucket = self.bucket_for(sum(len(t) for t in tokens_list), len(uids))
        wrapper = self._wrapper_for(bucket)
        wrapper.clear()
        for uid, toks in zip(uids, tokens_list):
            seq = self.state_manager.get_or_create_sequence(uid)
            if not self.state_manager.maybe_allocate_kv(seq, len(toks)):
                raise RuntimeError("KV allocation failed after can_schedule")
            wrapper.insert_sequence(seq, list(toks))
        batch = wrapper.finalize()
        step = build_ragged_step(
            self.cfg, max_q=bucket[0], num_blocks=self._num_blocks,
            attn_impl=self.config.attn_impl, max_seqs=bucket[1],
            max_blocks=wrapper.max_blocks)
        logits = step(self.model, self.kv.pages, self._upload(batch.pack()))
        for uid in batch.uids:
            self.state_manager.get_sequence(uid).post_forward()
        self._touch_heat(batch.uids)
        return logits[:batch.n_seqs]

    def flush(self, uids: Sequence[int]) -> None:
        self._decode_state = None
        for uid in uids:
            self.state_manager.flush_sequence(uid)
            self._uid_tenants.pop(uid, None)

    # ------------------------------------------------------------------ #
    # Memory accounting (host side)
    # ------------------------------------------------------------------ #
    def set_tenant(self, uid: int, tenant: Optional[str]) -> None:
        """Label ``uid``'s KV footprint with its tenant; cleared on flush."""
        if tenant:
            self._uid_tenants[int(uid)] = str(tenant)

    def _touch_heat(self, uids: Sequence[int]) -> None:
        """One heat-clock tick + whole-table touch for every sequence a
        dispatched forward covers (a decode window reads ALL of a
        sequence's context pages; prefill writes its fresh ones)."""
        if self.heat is None:
            return
        self.heat.tick()
        blocks: List[int] = []
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is not None:
                blocks.extend(seq.blocks)
        self.heat.touch(blocks)

    def memory_snapshot(self):
        """Heat-tracker snapshot with live holder/tenant attribution, or
        None when tracking is off."""
        if self.heat is None:
            return None
        holders = {uid: list(seq.blocks)
                   for uid, seq in self.state_manager._seqs.items()}
        return self.heat.snapshot(holders=holders,
                                  tenants=dict(self._uid_tenants))

    def register_memory_sources(self, ledger) -> None:
        """The JAX engine wires its state into the telemetry plane's
        ``MemoryLedger``; the port has no telemetry plane yet."""
        raise NotImplementedError(
            "register_memory_sources needs the telemetry MemoryLedger, "
            "which is not ported yet (ROADMAP M11); memory_snapshot() and "
            "kv_swap.stats() give the same numbers")

    def kv_used_fraction(self) -> float:
        """Fraction of the KV block pool currently allocated (the
        scheduler's KV-pressure signal)."""
        total = self.state_manager.allocator.total_blocks
        return 1.0 - self.state_manager.free_blocks / total

    def lifetime_reservation(self, prompt_len: int,
                             max_new: int) -> Tuple[int, int]:
        """Whole-lifetime KV reservation for a request: (tokens, blocks),
        capped at max_ctx (with an eos an early stop can keep
        prompt+max_new under the cap)."""
        need = min(prompt_len + max_new, self.config.max_ctx)
        return need, -(-need // self.config.block_size)

    # ------------------------------------------------------------------ #
    # Radix prefix KV reuse (config.prefix_cache)
    # ------------------------------------------------------------------ #
    @property
    def prefix_cache(self):
        return self.state_manager.prefix_cache

    @torch.inference_mode()
    def _copy_pages(self, src_block: int, dst_block: int) -> None:
        """Copy one logical page across every layer's physical slot — the
        copy-on-write of a shared partial page."""
        pages = self.kv.pages
        pages.index_copy_(0, self.kv.phys_pages([dst_block]),
                          pages.index_select(
                              0, self.kv.phys_pages([src_block])))
        self._decode_state = None       # pages changed behind K7's state
        if self.heat is not None:
            # the private copy inherits the shared page's heat: same rows,
            # same access history
            self.heat.transfer(src_block, dst_block)

    @torch.inference_mode()
    def _write_page_rows(self, block: int, rows) -> None:
        """Write one logical page's canonical rows ``[L, block_size, 2*KV,
        HD]`` (float32, host) into every layer's physical slot — the
        restore leg of a host-tier prefix spill. The rows cross as float32
        (from the tier's pinned buffer) and narrow to the pool's dtype on
        the device, a pure cast."""
        pages = self.kv.pages
        rows = torch.as_tensor(rows).to(pages.device, non_blocking=True)
        rows = rows.to(pages.dtype)
        pages.index_copy_(0, self.kv.phys_pages([block]), rows)
        self._decode_state = None

    def graft_prefix(self, uid: int, tokens: Sequence[int]) -> int:
        """Admission-side prefix reuse: graft the longest cached prefix of
        ``tokens`` into a fresh sequence and return how many tokens it
        covers (0 = miss / cache off); the caller prefills only the
        remainder. Full matched pages are SHARED (one extra allocator ref
        each); a trailing partial page is copied into a private block
        before the graft returns — the sequence's next forward appends
        into that page mid-row, and writing a shared page would corrupt
        every other holder. When no block is free for the copy the partial
        page is dropped from the match. With a host tier, the match
        extends through host-spilled full pages, each written back into a
        fresh block and recommitted to the trie.

        Until ``share_blocks`` takes its refs, the matched pages are held
        by the trie alone, so the evictions that make room here spare
        them: the chain's tail is a childless refcount-1 leaf, and
        evicting it would hand its block back as the fresh one."""
        cache = self.prefix_cache
        if cache is None or len(tokens) < 2:
            return 0
        seq = self.state_manager.get_sequence(uid)
        if seq is not None and (seq.blocks or seq.seen_tokens):
            raise ValueError(f"prefix graft into a non-fresh sequence "
                             f"uid={uid}")
        matched, blocks, partial = cache.match(list(tokens))
        if self.kv_swap is not None and not partial:
            # extend the trie match through host-spilled full pages: each
            # is written into a fresh block, recommitted to the trie (which
            # takes the owning ref), then shared like any matched page
            alloc = self.state_manager.allocator
            bs = self.config.block_size
            while matched + bs <= len(tokens) - 1:
                path = tuple(int(t) for t in tokens[:matched + bs])
                rows = self.kv_swap.peek_prefix(path)
                if rows is None:
                    break
                if alloc.free_blocks < 1:
                    cache.evict(1, keep=blocks)
                if alloc.free_blocks < 1:
                    break
                blk = int(alloc.allocate(1)[0])
                self._write_page_rows(blk, rows)
                cache.commit(list(tokens), blocks + [blk],
                             upto=matched + bs)
                alloc.free([blk])       # the trie's ref now owns the page
                self.kv_swap.confirm_prefix(path)
                blocks.append(blk)
                matched += bs
        if not matched:
            return 0
        self._decode_state = None
        # create the descriptor FIRST: get_or_create can raise on the
        # tracked-sequence cap, and nothing may be allocated before it
        seq = self.state_manager.get_or_create_sequence(uid)
        if partial:
            # copy-on-write of the tail page, or shrink the match
            alloc = self.state_manager.allocator
            if alloc.free_blocks < 1:
                cache.evict(1, keep=blocks)
            if alloc.free_blocks < 1:
                matched -= partial
                blocks = blocks[:-1]
                if not matched:
                    return 0
            else:
                private = int(alloc.allocate(1)[0])
                self._copy_pages(blocks[-1], private)
                # the sequence owns `private`; share only the full pages
                self.state_manager.share_blocks(seq, blocks[:-1],
                                                matched - partial)
                seq.blocks.append(private)
                seq.seen_tokens = matched
                return matched
        self.state_manager.share_blocks(seq, blocks, matched)
        return matched

    def commit_prefix(self, uid: int, tokens: Sequence[int],
                      allow_partial: bool = False) -> int:
        """Commit ``uid``'s prompt pages to the radix cache (no-op when
        off). Called at prefill completion (full pages only — the sequence
        keeps appending into its partial tail) and again at retirement with
        ``allow_partial=True``, when the tail page goes quiet for good.
        → pages newly inserted."""
        cache = self.prefix_cache
        seq = self.state_manager.get_sequence(uid)
        if cache is None or seq is None:
            return 0
        upto = min(len(tokens), seq.seen_tokens)
        return cache.commit(list(tokens), seq.blocks, upto=upto,
                            allow_partial=allow_partial)

    # ------------------------------------------------------------------ #
    # Speculative decoding: verify windows over the paged path
    # ------------------------------------------------------------------ #
    def _verify_step_for(self, key: Tuple[int, int]):
        """The verify step of a bucket (``model_runner.build_verify_step``)."""
        return build_verify_step(
            self.cfg, max_q=key[0], num_blocks=self._num_blocks,
            attn_impl=self.config.attn_impl, max_seqs=key[1],
            max_blocks=self._wrapper_for(key).max_blocks)

    def rollback_kv(self, uid: int, new_seen: int) -> None:
        """Truncate ``uid``'s KV length to ``new_seen`` tokens: the
        rejection path of a verify window, and the draft engine's resync.

        Pages are never copied or freed: the rows past the new length are
        dead and the sequence's next append overwrites them (positions come
        from ``seen_tokens``). Blocks stay allocated, so a whole-lifetime
        reservation survives any number of rollbacks; the over-hold is at
        most one window. The device-resident decode state is dropped: it
        was advanced past the rollback point."""
        seq = self.state_manager.get_sequence(uid)
        if seq is None:
            raise ValueError(f"rollback of unknown uid {uid}")
        if not 0 <= new_seen <= seq.seen_tokens:
            raise ValueError(f"rollback can only truncate: {new_seen} not in "
                             f"[0, {seq.seen_tokens}]")
        seq.seen_tokens = int(new_seen)
        seq.in_flight_tokens = 0
        self._decode_state = None

    @torch.inference_mode()
    def verify_decode(self, uids: Sequence[int], seed_tokens: Sequence[int],
                      drafts: Sequence[Sequence[int]]) -> "VerifyResult":
        """One speculative verify window: score every sequence's ``[seed] +
        draft`` row in ONE ragged multi-token forward (K6 on the paged
        path), accept the longest draft prefix that matches the model's
        greedy argmax, and roll the KV length back past the first
        rejection.

        Position 0's argmax is taken over the context vanilla decode would
        see for the seed, and draft position j stays in the chain only when
        every earlier candidate matched, so the emitted tokens are the
        greedy stream, up to ``1 + len(draft)`` at a time; every window
        emits at least one token.

        The full ``1 + len(draft)`` rows are allocated and appended up
        front (``kv_used_fraction`` counts speculative pages while the
        window runs); rejection truncates the length (:meth:`rollback_kv`).
        The window shares the ``decode_window`` fault site with fused
        decode windows: a poisoned row emits nothing and rolls back to its
        length before the window, its batchmates are untouched."""
        n = len(uids)
        if not n == len(seed_tokens) == len(drafts):
            raise ValueError("uids, seed_tokens and drafts differ in length")
        lens = [1 + len(d) for d in drafts]
        if sum(lens) > self.config.max_tokens:
            # before any allocator or descriptor state changes: the pack
            # would raise halfway through the inserts otherwise
            raise RuntimeError(
                f"verify window needs {sum(lens)} flat tokens ({n} seqs + "
                f"drafts) > max_tokens {self.config.max_tokens}; cap the "
                f"draft lengths")
        verdict = self.can_schedule(uids, lens)
        if verdict != SchedulingResult.Success:
            raise RuntimeError(f"cannot schedule verify window: {verdict}")
        self._decode_state = None      # host forward invalidates device meta
        bucket = self.bucket_for(sum(lens), n)
        wrapper = self._wrapper_for(bucket)
        wrapper.clear()
        ctx_before = []
        for uid, seed, draft in zip(uids, seed_tokens, drafts):
            seq = self.state_manager.get_or_create_sequence(uid)
            ctx_before.append(seq.seen_tokens)
            if not self.state_manager.maybe_allocate_kv(seq, 1 + len(draft)):
                raise RuntimeError("KV allocation failed after can_schedule")
            wrapper.insert_sequence(seq, [int(seed)] + [int(t) for t in draft])
        batch = wrapper.finalize()
        meta = self._upload(batch.pack())
        step = self._verify_step_for(bucket)
        first_use = _first_use(("verify", str(self.device), bucket))

        t0 = time.perf_counter()
        self.decode_windows_dispatched += 1
        poisoned = False
        try:
            inject("decode_window", step=self.decode_windows_dispatched)
        except InjectedNaN:
            poisoned = True
            self._poison_kv(uids[0])
        greedy_dev, bad_dev = step(self.model, self.kv.pages, meta)
        greedy = greedy_dev.cpu().numpy()
        bad = bad_dev.cpu().numpy()
        duration_s = time.perf_counter() - t0

        accepted: List[List[int]] = []
        nonfinite_uids: List[int] = []
        drafted = accepted_draft = 0
        for row, (uid, draft) in enumerate(zip(uids, drafts)):
            self.state_manager.get_sequence(uid).post_forward()
            if bad[row]:
                # no speculative KV is left behind; the caller flushes it
                self.rollback_kv(uid, ctx_before[row])
                nonfinite_uids.append(uid)
                accepted.append([])
                continue
            off = int(batch.q_offset[row])
            g = [int(t) for t in greedy[off:off + 1 + len(draft)]]
            a = 0
            while a < len(draft) and int(draft[a]) == g[a]:
                a += 1
            drafted += len(draft)
            accepted_draft += a
            accepted.append(g[:a + 1])
            # the seed and the a matched drafts are context; later rows
            # are dead until overwritten
            self.rollback_kv(uid, ctx_before[row] + 1 + a)
        self._touch_heat(uids)
        return VerifyResult(
            uids=list(uids), accepted=accepted,
            nonfinite_uids=nonfinite_uids, drafted=drafted,
            accepted_draft=accepted_draft,
            emitted=sum(len(t) for t in accepted), duration_s=duration_s,
            compiled=first_use, poisoned=poisoned)

    # ------------------------------------------------------------------ #
    # Fused multi-step decode (device-resident loop)
    # ------------------------------------------------------------------ #
    def decode_batch(self, uids: Sequence[int],
                     seed_tokens: Sequence[int], steps: int,
                     temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     top_k: Optional[int] = None) -> np.ndarray:
        """Run ``steps`` decode iterations for ``uids`` on the device and
        wait for the tokens [steps, n_seqs] (host numpy); the last generated
        token is NOT appended to the cache (it is the next call's seed)."""
        return self.decode_batch_async(uids, seed_tokens, steps,
                                       temperature=temperature,
                                       generator=generator,
                                       top_k=top_k).tokens()

    @torch.inference_mode()
    def decode_batch_async(self, uids: Sequence[int],
                           seed_tokens: Sequence[int], steps: int,
                           temperature: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           top_k: Optional[int] = None) -> "DecodeWindow":
        """Enqueue a fused decode window WITHOUT waiting for its tokens.

        Each sequence starts from ``seed_tokens[i]`` and decodes ``steps``
        tokens with no host synchronisation between steps: sampling runs
        on the device, KV blocks for the whole window are allocated up
        front so the block table is static, and the packed metadata
        advances on the device.

        Device-resident continuation: when the next window targets the same
        uids with unchanged block tables, the advanced metadata of this one
        is reused — no host repack, no upload. If this window was already
        drained, seeds that differ from its last tokens force a repack; a
        window enqueued before the previous one was drained takes its seeds
        from the device state.
        """
        n = len(uids)
        verdict = self.can_schedule(uids, [steps] * n)
        if verdict != SchedulingResult.Success:
            raise RuntimeError(f"cannot schedule decode window: {verdict}")
        s_b = self._seq_bucket(n)
        bucket = (s_b, s_b)
        ctx_before = []
        grew = False
        for uid in uids:
            seq = self.state_manager.get_or_create_sequence(uid)
            ctx_before.append(seq.seen_tokens)
            prev = seq.cur_allocated_blocks
            if not self.state_manager.maybe_allocate_kv(seq, steps):
                raise RuntimeError("KV allocation failed after can_schedule")
            grew |= seq.cur_allocated_blocks != prev

        st = self._decode_state
        uids_t = tuple(uids)
        same_stream = (st is not None and st["uids"] == uids_t
                       and st["bucket"] == bucket
                       and all(st["seen"][u] ==
                               self.state_manager.get_sequence(u).seen_tokens
                               for u in uids))
        resume = same_stream and not grew
        if resume and "last_tokens" in st:
            # the caller knows the stream: a different seed wins over resume
            resume = tuple(int(t) for t in seed_tokens) == st["last_tokens"]
        if resume:
            self.decode_resume_hits += 1
            meta_dev = st["meta"]
        else:
            if same_stream and "last_tokens" not in st:
                # chaining off an UNDRAINED window that cannot resume (block
                # growth): the true next tokens are in the advanced meta's
                # tokens field; reading them waits for that window
                seed_tokens = st["meta"][:n].tolist()
            wrapper = self._wrapper_for(bucket)
            wrapper.clear()
            for uid, tok in zip(uids, seed_tokens):
                wrapper.insert_sequence(
                    self.state_manager.get_sequence(uid), [int(tok)])
            meta_dev = self._upload(wrapper.finalize().pack())

        c = self.config
        top_k = c.top_k if top_k is None else int(top_k)
        first_use = _first_use(("decode", str(self.device), bucket, steps,
                                float(temperature), top_k))
        # fault-injection site (DSTPU_FAULT_INJECT site=decode_window):
        # `slow` sleeps here, `kill` dies here, `nan` poisons the FIRST
        # scheduled sequence's cached context so the window genuinely
        # produces non-finite logits for that row. t0 starts BEFORE the
        # site so an injected stall lands inside the window's wall time,
        # where the scheduler's hang check looks
        t0 = time.perf_counter()
        self.decode_windows_dispatched += 1
        poisoned = False
        try:
            inject("decode_window", step=self.decode_windows_dispatched)
        except InjectedNaN:
            poisoned = True
            if resume:
                # the resume path skipped the repack: take the true next
                # tokens from the advanced device meta and rebuild on the
                # host, so the window dispatches against fresh metadata
                seed_tokens = meta_dev[:n].tolist()
                wrapper = self._wrapper_for(bucket)
                wrapper.clear()
                for uid, tok in zip(uids, seed_tokens):
                    wrapper.insert_sequence(
                        self.state_manager.get_sequence(uid), [int(tok)])
                meta_dev = self._upload(wrapper.finalize().pack())
                resume = False
            self._poison_kv(uids[0])

        loop = build_decode_loop(
            self.cfg, max_q=bucket[0], max_seqs=bucket[1],
            max_blocks=self._wrapper_for(bucket).max_blocks,
            block_size=c.block_size, num_blocks=self._num_blocks,
            attn_impl=c.attn_impl, steps=steps, temperature=temperature,
            top_k=top_k)
        toks, meta_out, nonfinite = loop(
            self.model, self.kv.pages, meta_dev,
            self._generator if generator is None else generator)
        seen = {}
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            seq.in_flight_tokens = steps
            seq.post_forward()
            seen[uid] = seq.seen_tokens
        self._touch_heat(uids)
        # a poisoned window leaves no resumable state: its advanced meta
        # was computed over poisoned pages
        self._decode_state = None if poisoned else {
            "uids": uids_t, "bucket": bucket, "meta": meta_out, "seen": seen}
        mean_ctx = float(np.mean(ctx_before)) + steps / 2.0 if n else 0.0
        return DecodeWindow(self, toks, n, steps, resume, nonfinite,
                            self._decode_state, list(uids), mean_ctx=mean_ctx,
                            t0=t0, compiled=first_use)

    @torch.inference_mode()
    def _poison_kv(self, uid: int) -> None:
        """Write NaN over every privately held cached page of ``uid``
        across all layers (the ``decode_window``/``nan`` payload). Pages
        with more than one holder (shared through the radix cache) are
        SKIPPED: poisoning a shared system-prompt page would leak NaN into
        every co-tenant. A decoding sequence always owns its tail page
        (fresh allocation or copy-on-write), which is enough to drive its
        logits non-finite."""
        seq = self.state_manager.get_sequence(uid)
        if seq is None or not seq.blocks:
            return
        alloc = self.state_manager.allocator
        own = [b for b in seq.blocks if alloc.refcount(b) == 1]
        if not own:
            logger.warning(f"nan injection skipped: uid {uid} owns no "
                           f"private page")
            return
        self.kv.pages.index_fill_(0, self.kv.phys_pages(own), float("nan"))
        self._decode_state = None

    def _record_decode_roofline(self, window: "DecodeWindow") -> None:
        """Feed a drained decode window into the analytic HBM roofline
        (decode is bandwidth-bound, so %-of-peak HBM, not MFU, is its
        utilization number) and keep the report on
        ``last_decode_roofline``. A ``compiled`` window's report is kept
        too, flagged ``compile_polluted``: its wall time includes the
        first-use costs. (The JAX engine also publishes the report as
        telemetry gauges; the port's telemetry plane is ROADMAP M11.)"""
        if not window.n_seqs or not window.duration_s:
            return
        from ...profiling.roofline import device_spec
        from ...profiling.serving_roofline import (decode_roofline_report,
                                                   decode_window_bytes,
                                                   format_decode_roofline)

        cfg = self.cfg
        kv_cfg = self.kv.config
        bytes_by_kernel = decode_window_bytes(
            num_layers=cfg.num_layers, num_kv_heads=kv_cfg.num_kv_heads,
            head_dim=kv_cfg.head_dim,
            kv_dtype_bytes=self.kv.pages.element_size(),
            param_bytes=self._param_bytes, n_seqs=window.n_seqs,
            steps=window.steps, mean_ctx=window.mean_ctx)
        report = decode_roofline_report(bytes_by_kernel, window.duration_s,
                                        window.n_seqs, window.steps,
                                        spec=device_spec(self.device))
        report["resumed"] = window.resumed
        report["compile_polluted"] = window.compiled
        self.last_decode_roofline = report
        if not window.compiled:
            logger.debug(format_decode_roofline(report))

    # ------------------------------------------------------------------ #
    # Dynamic SplitFuse scheduling (MII-layer policy, host-only logic)
    # ------------------------------------------------------------------ #
    def schedule(self, pending: Dict[int, List[int]]
                 ) -> List[Tuple[int, List[int]]]:
        """One-shot scheduling over a pending dict: decodes first (1 token
        each), then prompt chunks split to fill the token budget."""
        budget = self.config.max_tokens
        picked: List[Tuple[int, List[int]]] = []
        for uid, toks in list(pending.items()):
            if len(toks) == 1 and budget >= 1 and \
                    len(picked) < self.config.max_seqs:
                picked.append((uid, toks))
                budget -= 1
        for uid, toks in list(pending.items()):
            if len(toks) > 1 and budget > 0 and \
                    len(picked) < self.config.max_seqs:
                chunk = toks[:budget]
                picked.append((uid, chunk))
                budget -= len(chunk)
        return picked

    # ------------------------------------------------------------------ #
    # Convenience generation loop (greedy/temperature)
    # ------------------------------------------------------------------ #
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Batched generation through the continuous batcher: SplitFuse
        prefill chunks + fused on-device decode windows, with KV
        backpressure (prompts queue instead of raising when the cache is
        full)."""
        pool = self.kv.config.num_blocks
        for p in prompts:
            if len(p) > self.config.max_ctx or (
                    eos_token_id is None and
                    len(p) + max_new_tokens > self.config.max_ctx):
                raise RuntimeError(
                    f"cannot schedule batch: {SchedulingResult.SequenceTooLong}"
                    f" (prompt {len(p)} + {max_new_tokens} new > max_ctx "
                    f"{self.config.max_ctx})")
            need = min(len(p) + max_new_tokens, self.config.max_ctx)
            if -(-need // self.config.block_size) > pool:
                raise RuntimeError(
                    f"cannot schedule batch: "
                    f"{SchedulingResult.KVCacheLimitExceeded} (request needs "
                    f"{need} tokens; pool holds "
                    f"{pool * self.config.block_size})")
        batcher = ContinuousBatcher(self, max_new_tokens=max_new_tokens,
                                    temperature=temperature,
                                    eos_token_id=eos_token_id,
                                    generator=generator)
        for u, p in enumerate(prompts):
            batcher.add_request(u, list(p))
        done = batcher.run()
        self.last_generate_stats = dict(batcher.stats)
        return [done[u] for u in range(len(prompts))]

    def serialize(self, path: str) -> None:
        """Persist the serving parameters (reference :1100): tag ``model``
        of the port's numpy checkpoint engine under ``path``, a universal
        directory either package's ``load_universal`` reads."""
        from ...checkpoint.universal.layout import universal_name
        from ...runtime.checkpoint_engine.numpy_checkpoint_engine import (
            NumpyCheckpointEngine,
        )

        leaves = {universal_name(name): {"param": p}
                  for name, p in self.model.named_parameters()}
        NumpyCheckpointEngine(path).save(
            {"leaves": leaves, "meta": {}, "step": 0}, "model")


@dataclasses.dataclass
class VerifyResult:
    """Outcome of one verify window (:meth:`InferenceEngineV2.
    verify_decode`).

    ``accepted[i]`` is the greedy chain emitted for ``uids[i]``: ``1 +
    a_i`` tokens, ``a_i`` the matched draft prefix; its LAST token is the
    next seed (not yet in the KV cache, as after ``put`` and decode). A
    uid in ``nonfinite_uids`` emitted nothing and its KV length is back to
    where it was before the window."""

    uids: List[int]
    accepted: List[List[int]]
    nonfinite_uids: List[int]
    drafted: int                 # draft tokens scored
    accepted_draft: int          # of those, matched the greedy chain
    emitted: int                 # tokens produced (>= len(uids) - poisoned)
    duration_s: float            # verify forward wall time
    compiled: bool               # first use of this verify bucket
    poisoned: bool               # the decode_window nan injection fired

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_draft / self.drafted if self.drafted else 0.0


class DecodeWindow:
    """Handle for an enqueued fused decode window; :meth:`tokens` waits for
    the result and (once) feeds the window's wall time into the decode
    HBM roofline.

    ``duration_s`` is enqueue→drain WALL time, from before the fault site
    to :meth:`tokens`: host work done between the enqueue and
    :meth:`tokens` inflates it and understates the roofline's tok/s.
    ``mean_ctx`` is the sequences' mean context over the window (their
    length at the start plus half the steps). ``compiled`` is True on the
    first window of its decode-loop key in the process (see
    ``_KEYS_RUN``)."""

    def __init__(self, engine: InferenceEngineV2, toks_dev: torch.Tensor,
                 n_seqs: int, steps: int, resumed: bool,
                 nonfinite_dev: torch.Tensor, state: Optional[dict],
                 uids: Sequence[int], mean_ctx: float, t0: float,
                 compiled: bool):
        self.engine = engine
        self.n_seqs = n_seqs
        self.steps = steps
        self.resumed = resumed
        self.mean_ctx = mean_ctx
        self.compiled = compiled
        self._t0 = t0
        self.duration_s: Optional[float] = None
        #: uids in row order, so the nonfinite flags map back to requests
        self.uids = list(uids)
        self._toks_dev = toks_dev
        self._nonfinite_dev = nonfinite_dev
        self._toks: Optional[np.ndarray] = None
        #: per-sequence poison flags [n_seqs], set at drain: True when that
        #: sequence's logits went non-finite during the window
        self.nonfinite: Optional[np.ndarray] = None
        self._state = state

    def tokens(self) -> np.ndarray:
        """Wait for the generated tokens [steps, n_seqs]."""
        if self._toks is None:
            self._toks = self._toks_dev[:, :self.n_seqs].cpu().numpy()
            self.nonfinite = self._nonfinite_dev[:self.n_seqs].cpu().numpy()
            self.duration_s = time.perf_counter() - self._t0
            self._toks_dev = None
            self._nonfinite_dev = None
            if self._state is not None and \
                    self.engine._decode_state is self._state:
                # the last sampled token is the next window's seed: once it
                # is host-known, resume can honour caller-supplied seeds
                self._state["last_tokens"] = tuple(
                    int(t) for t in self._toks[-1])
            self.engine._record_decode_roofline(self)
        return self._toks

    def nonfinite_uids(self) -> List[int]:
        """uids whose logits went non-finite during this window (waits for
        the window if needed)."""
        self.tokens()
        return [u for u, bad in zip(self.uids, self.nonfinite) if bad]


class ContinuousBatcher:
    """Stateful continuous-batching front end — admission, SplitFuse
    scheduling, KV backpressure and eviction at O(batch) host cost per
    step, independent of the queued-request count.

      * ``_decodes`` — uids with a next token ready (each costs 1 budget
        token), rotated round-robin so no stream starves;
      * ``_waiting`` / ``_prefilling`` — FIFO admission queue and the
        prompts being chunked; only the queue HEAD is examined;
      * finished sequences are flushed at once (blocks return to the pool).

    ``stats`` accumulates the wall time and tokens of the forwards it runs:
    ``put_*`` for SplitFuse forwards (the host waits for their sampled
    tokens), ``window_*`` for fused decode windows (enqueue → drain).
    """

    def __init__(self, engine: InferenceEngineV2, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        from collections import OrderedDict, deque

        self.eng = engine
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_token_id = eos_token_id
        self._generator = generator if generator is not None else \
            torch.Generator(device=engine.device).manual_seed(0)
        self._waiting = deque()                    # uids not yet admitted
        self._prompts: Dict[int, List[int]] = {}   # uid -> full prompt
        self._prefill_pos: Dict[int, int] = {}     # uid -> tokens consumed
        self._prefilling: "OrderedDict[int, None]" = OrderedDict()
        self._decodes: "OrderedDict[int, int]" = OrderedDict()  # uid -> next tok
        self.produced: Dict[int, List[int]] = {}
        self.finished: Dict[int, List[int]] = {}
        self.rejected: List[int] = []          # impossible under any load
        self.touched = 0
        self.stats = {"put_calls": 0, "put_tokens": 0, "put_s": 0.0,
                      "window_calls": 0, "window_tokens": 0, "window_s": 0.0}

    # -------------------------- admission ----------------------------- #
    def add_request(self, uid: int, tokens: List[int]) -> None:
        if uid in self._prompts or uid in self.finished:
            raise ValueError(f"uid {uid} already submitted")
        self.produced[uid] = []
        if not tokens:                 # nothing to condition on
            self.finished[uid] = []
            return
        self._prompts[uid] = list(tokens)
        self._prefill_pos[uid] = 0
        self._waiting.append(uid)

    @property
    def pending(self) -> int:
        return len(self._waiting) + len(self._prefilling) + len(self._decodes)

    # -------------------------- scheduling ---------------------------- #
    def next_batch(self) -> List[Tuple[int, List[int]]]:
        """Pick (uid, chunk) pairs for one forward. Examines at most
        max_seqs decode uids + the prefilling set + the queue head."""
        c = self.eng.config
        budget = c.max_tokens
        picked: List[Tuple[int, List[int]]] = []
        self.touched = 0

        # 1. ready decodes, round-robin
        n_dec = min(len(self._decodes), c.max_seqs, budget)
        for _ in range(n_dec):
            uid, tok = self._decodes.popitem(last=False)
            picked.append((uid, [tok]))
            budget -= 1
            self.touched += 1
        # 2. in-flight prefills continue (they hold KV blocks)
        for uid in list(self._prefilling):
            if budget <= 0 or len(picked) >= c.max_seqs:
                break
            pos = self._prefill_pos[uid]
            chunk = self._prompts[uid][pos:pos + budget]
            picked.append((uid, chunk))
            budget -= len(chunk)
            self.touched += 1
        # 3. admit from the queue HEAD while budget and KV blocks allow;
        #    admission reserves blocks for the request's whole lifetime
        while self._waiting and budget > 0 and len(picked) < c.max_seqs:
            uid = self._waiting[0]
            self.touched += 1
            need, need_blocks = self.eng.lifetime_reservation(
                len(self._prompts[uid]), self.max_new_tokens)
            if (len(self._prompts[uid]) > c.max_ctx
                    or need_blocks > self.eng.kv.config.num_blocks):
                logger.warning(
                    f"rejecting uid {uid}: prompt+decode needs {need} tokens "
                    f"({need_blocks} blocks) — exceeds max_ctx {c.max_ctx} / "
                    f"pool {self.eng.kv.config.num_blocks} blocks")
                self._waiting.popleft()
                self.rejected.append(uid)
                self.finished[uid] = []
                self._prompts.pop(uid, None)
                self._prefill_pos.pop(uid, None)
                continue
            seq = self.eng.state_manager.get_or_create_sequence(uid)
            if not self.eng.state_manager.maybe_allocate_kv(seq, need):
                break          # KV backpressure: head waits, queue intact
            self._waiting.popleft()
            self._prefilling[uid] = None
            picked.append((uid, self._prompts[uid][:budget]))
            budget -= len(picked[-1][1])
        return picked

    # ------------------------------ step ------------------------------ #
    def step(self) -> List[int]:
        """Run one engine forward (or a fused decode window when every live
        sequence is decoding); returns uids finished this step."""
        just_finished: List[int] = []
        pure_decode = (not self._prefilling and not self._waiting
                       and self._decodes and self.eos_token_id is None
                       and len(self._decodes) <= min(
                           self.eng.config.max_seqs,
                           self.eng.config.max_tokens))
        if pure_decode:
            uids = list(self._decodes)
            steps = min(self.max_new_tokens - len(self.produced[u])
                        for u in uids)
            if steps > 2:      # one window size per power of two
                steps = 1 << (steps.bit_length() - 1)
            if steps > 1:
                t0 = time.perf_counter()
                toks = self.eng.decode_batch(
                    uids, [self._decodes[u] for u in uids], steps,
                    self.temperature, self._generator)
                self.stats["window_s"] += time.perf_counter() - t0
                self.stats["window_calls"] += 1
                self.stats["window_tokens"] += steps * len(uids)
                for col, uid in enumerate(uids):
                    self.produced[uid].extend(int(t) for t in toks[:, col])
                    del self._decodes[uid]
                    if len(self.produced[uid]) >= self.max_new_tokens:
                        self._retire(uid, just_finished)
                    else:
                        self._decodes[uid] = self.produced[uid][-1]
                return just_finished

        batch = self.next_batch()
        if not batch:
            return just_finished
        t0 = time.perf_counter()
        logits = self.eng.put([u for u, _ in batch], [t for _, t in batch])
        with torch.inference_mode():
            toks = sample_tokens(logits[:len(batch)], self._generator,
                                 self.temperature).cpu().numpy()
        self.stats["put_s"] += time.perf_counter() - t0
        self.stats["put_calls"] += 1
        self.stats["put_tokens"] += sum(len(t) for _, t in batch)
        for row, (uid, chunk) in enumerate(batch):
            if uid in self._prefilling:
                self._prefill_pos[uid] += len(chunk)
                if self._prefill_pos[uid] < len(self._prompts[uid]):
                    continue                       # mid-prompt; logits unused
                del self._prefilling[uid]
            tok = int(toks[row])
            self.produced[uid].append(tok)
            if ((self.eos_token_id is not None and tok == self.eos_token_id)
                    or len(self.produced[uid]) >= self.max_new_tokens):
                self._retire(uid, just_finished)
            else:
                self._decodes[uid] = tok
        return just_finished

    def _retire(self, uid: int, finished_acc: List[int]) -> None:
        self.eng.flush([uid])                      # blocks back to the pool
        self.finished[uid] = self.produced[uid]
        self._prompts.pop(uid, None)
        self._prefill_pos.pop(uid, None)
        finished_acc.append(uid)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request completes."""
        guard = 0

        def total_tokens():
            return sum(len(v) for v in self.produced.values()) + \
                sum(self._prefill_pos.get(u, 0) for u in self._prefilling)

        while self.pending:
            before = total_tokens()
            self.step()
            guard = guard + 1 if total_tokens() == before else 0
            if guard > 3:
                raise RuntimeError("scheduler made no progress "
                                   f"({self.pending} pending)")
        return self.finished
