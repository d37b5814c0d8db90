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
from ...models.transformer import CausalLM, TransformerConfig
from ...utils.logging import logger
from .model_runner import build_decode_loop, build_ragged_step, sample_tokens
from .ragged.kv_cache import BlockedKVCache, KVCacheConfig
from .ragged.ragged_wrapper import RaggedBatchWrapper
from .ragged.sequence_descriptor import DSStateManager


class SchedulingResult(Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    KVCacheLimitExceeded = 3
    SequenceTooLong = 4


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    """Reference: inference/v2/config_v2.py. The fields this slice uses,
    with the JAX package's defaults."""

    max_tokens: int = 256            # token budget per forward (SplitFuse chunk)
    max_seqs: int = 16
    max_ctx: int = 2048
    block_size: int = 64
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


class InferenceEngineV2:
    """Serves a :class:`CausalLM` from a paged KV cache.

    ``device=None`` means CUDA and raises when CUDA is absent; the CPU runs
    only when named (``device="cpu"``). The model's parameters are moved to
    the device and cast to ``config.dtype`` in place."""

    def __init__(self, model: CausalLM,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 device=None):
        self.device = get_accelerator().resolve_device(device)
        self.model = model
        self.cfg = model.config
        if not isinstance(self.cfg, TransformerConfig):
            raise NotImplementedError(
                f"ragged serving needs a TransformerConfig model; got "
                f"{type(self.cfg).__name__}")
        self.config = config or RaggedInferenceEngineConfig()
        c = self.config
        if c.attn_impl not in ("paged", "gather"):
            raise ValueError(
                f"attn_impl must be 'paged' or 'gather', got {c.attn_impl!r}")
        # enough pages for max_seqs sequences of max_ctx tokens
        num_blocks = c.max_seqs * -(-c.max_ctx // c.block_size)
        self.state_manager = DSStateManager(num_blocks=num_blocks,
                                            block_size=c.block_size)
        self.kv = BlockedKVCache(KVCacheConfig(
            num_layers=self.cfg.num_layers, num_blocks=num_blocks,
            block_size=c.block_size, num_kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.head_dim, dtype=c.dtype), device=self.device)
        model.to(device=self.device, dtype=c.dtype)
        self._num_blocks = num_blocks
        self._wrappers: Dict[Tuple[int, int], RaggedBatchWrapper] = {}
        #: device-resident continuous-decode state: the advanced packed
        #: metadata of the last fused window, reusable by the next window
        #: with NO host repack / upload (see decode_batch_async)
        self._decode_state: Optional[Dict] = None
        self.decode_resume_hits = 0
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
        return logits[:batch.n_seqs]

    def flush(self, uids: Sequence[int]) -> None:
        self._decode_state = None
        for uid in uids:
            self.state_manager.flush_sequence(uid)

    def lifetime_reservation(self, prompt_len: int,
                             max_new: int) -> Tuple[int, int]:
        """Whole-lifetime KV reservation for a request: (tokens, blocks),
        capped at max_ctx (with an eos an early stop can keep
        prompt+max_new under the cap)."""
        need = min(prompt_len + max_new, self.config.max_ctx)
        return need, -(-need // self.config.block_size)

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
        grew = False
        for uid in uids:
            seq = self.state_manager.get_or_create_sequence(uid)
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
        loop = build_decode_loop(
            self.cfg, max_q=bucket[0], max_seqs=bucket[1],
            max_blocks=self._wrapper_for(bucket).max_blocks,
            block_size=c.block_size, num_blocks=self._num_blocks,
            attn_impl=c.attn_impl, steps=steps, temperature=temperature,
            top_k=c.top_k if top_k is None else int(top_k))
        toks, meta_out, nonfinite = loop(
            self.model, self.kv.pages, meta_dev,
            self._generator if generator is None else generator)
        seen = {}
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            seq.in_flight_tokens = steps
            seq.post_forward()
            seen[uid] = seq.seen_tokens
        self._decode_state = {"uids": uids_t, "bucket": bucket,
                              "meta": meta_out, "seen": seen}
        return DecodeWindow(self, toks, n, steps, resume, nonfinite,
                            self._decode_state)

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


class DecodeWindow:
    """Handle for an enqueued fused decode window; :meth:`tokens` waits for
    the result."""

    def __init__(self, engine: InferenceEngineV2, toks_dev: torch.Tensor,
                 n_seqs: int, steps: int, resumed: bool,
                 nonfinite_dev: torch.Tensor, state: dict):
        self.engine = engine
        self.n_seqs = n_seqs
        self.steps = steps
        self.resumed = resumed
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
            self._toks_dev = None
            self._nonfinite_dev = None
            if self.engine._decode_state is self._state:
                # the last sampled token is the next window's seed: once it
                # is host-known, resume can honour caller-supplied seeds
                self._state["last_tokens"] = tuple(
                    int(t) for t in self._toks[-1])
        return self._toks


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
