"""Speculative decoding for the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2/speculative.py``): the drafters and the
loop of verify windows.

A drafter proposes up to k candidate tokens per sequence; the target
model scores the seed and all k candidates in ONE ragged multi-token
forward (:meth:`~.engine_v2.InferenceEngineV2.verify_decode`, K6 on the
paged path) and the longest candidate prefix that matches the target's
own greedy argmax is accepted. Every accepted position is the greedy
token of the context vanilla decode would have there, so speculation
changes speed, not content (on the card the verify windows and fused
decode run different kernels at different token counts, so the two may
part at near-ties of the logits).

Two drafters, in cost order (a caller builds one directly, or the
lifecycle scheduler builds it from a :class:`SpeculativeConfig` through
:func:`make_drafter`):

  * :class:`NGramDrafter`: host-side suffix matching over the request's
    own prompt and generated tokens; no second model, no device work;
  * :class:`DraftModelDrafter`: a small model served by its own
    :class:`~.engine_v2.InferenceEngineV2` on the same device (built from
    a training checkpoint by :func:`draft_engine_from_checkpoint`, or
    handed in); its paged KV follows the accepted stream through the same
    ``rollback_kv`` truncation the target uses on rejection.

Rejection is cheap on the paged cache: the window appends all its rows up
front, and rejection truncates the sequence's length; blocks are never
copied or freed mid-block, and the next append overwrites the dead rows.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ...utils.logging import logger

SPEC_MODES = ("off", "ngram", "draft_model")


@dataclasses.dataclass
class SpeculativeConfig:
    """Knobs for the serving spec-dec layer.

    ``mode``: drafter selection (``off`` | ``ngram`` | ``draft_model``).
    ``k``: draft candidates per verify window — the speedup ceiling is
    ``k+1`` tokens per model step at acceptance 1.0; past the stream's
    typical run length extra candidates are pure rejected work.
    ``ngram_max``/``ngram_min``: longest/shortest suffix the n-gram
    drafter tries to match (longest first — longer context, better
    prediction).
    """

    mode: str = "off"
    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.mode not in SPEC_MODES:
            raise ValueError(f"speculative.mode must be one of {SPEC_MODES},"
                             f" got {self.mode!r}")
        if self.k < 1:
            raise ValueError(f"speculative.k must be >= 1, got {self.k}")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError("need 1 <= ngram_min <= ngram_max, got "
                             f"[{self.ngram_min}, {self.ngram_max}]")


class NGramDrafter:
    """Prompt/self n-gram lookup drafter — no second model, O(accepted
    tokens) host work per verify window.

    Per uid it maintains a suffix-match index over the FULL token stream
    (prompt + generated): for each n in [ngram_min, ngram_max] a dict from
    n-gram tuple to its most recent start positions strictly BEFORE the
    current suffix.  ``draft`` matches the stream's longest indexed suffix
    and proposes the k tokens that followed an earlier occurrence — the
    classic prompt-lookup decoding recipe.  Among the remembered
    occurrences it prefers the most recent one with at least k tokens of
    continuation (the latest match in a short-period repetition sits right
    at the end of the stream and has nothing left to copy), falling back
    to whichever occurrence has the longest continuation.  The index is
    extended incrementally — per call the host work is O(new tokens), not
    O(stream), so the per-window tax stays flat at 32k-context lengths.
    Extension detection compares only a bounded tail window (a full
    prefix compare would itself be O(stream) per window): a stream that
    grew and matches the last ``TAIL_CHECK`` indexed tokens is treated as
    append-only — which the scheduler's streams always are (preemption
    resume keeps ``produced``; uid reuse goes through ``flush``).  A
    pathological caller that diverges mid-stream while matching the tail
    can only cost draft QUALITY (bad candidates are rejected by the
    verify pass — correctness never depends on the drafter); a shrunk or
    tail-mismatched stream rebuilds from scratch.
    """

    #: occurrences remembered per n-gram: enough that one of them has a
    #: full-k continuation for any repetition period up to ~KEEP·period
    KEEP = 4
    #: extension-check window (see class docstring)
    TAIL_CHECK = 32

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError("need 1 <= ngram_min <= ngram_max, got "
                             f"[{ngram_min}, {ngram_max}]")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._toks: Dict[int, List[int]] = {}
        #: per uid, per n: {ngram tuple -> up to KEEP most recent starts,
        #: oldest first}, plus the count of start positions already indexed
        self._index: Dict[int, Dict[int, Dict[Tuple[int, ...],
                                              List[int]]]] = {}
        self._indexed: Dict[int, Dict[int, int]] = {}

    def _sync(self, uid: int, tokens: Sequence[int]) -> None:
        stored = self._toks.get(uid)
        ns = len(stored) if stored is not None else 0
        w = min(ns, self.TAIL_CHECK)
        if stored is None or len(tokens) < ns or (
                w and list(tokens[ns - w:ns]) != stored[ns - w:]):
            self._toks[uid] = stored = []
            self._index[uid] = {n: {} for n in range(self.ngram_min,
                                                     self.ngram_max + 1)}
            self._indexed[uid] = {n: 0 for n in self._index[uid]}
            ns = 0
        stored.extend(int(t) for t in tokens[ns:])   # O(delta)
        toks = stored
        L = len(toks)
        for n, idx in self._index[uid].items():
            # index every start except the current suffix's own (L - n):
            # lookups must land on a strictly EARLIER occurrence
            for start in range(self._indexed[uid][n], L - n):
                hits = idx.setdefault(tuple(toks[start:start + n]), [])
                hits.append(start)
                del hits[:-self.KEEP]
            self._indexed[uid][n] = max(self._indexed[uid][n], L - n)

    def draft(self, uid: int, tokens: Sequence[int], k: int) -> List[int]:
        """Propose up to ``k`` tokens to follow ``tokens[-1]`` (the decode
        seed).  ``tokens`` is the request's full stream: prompt + produced.
        Returns [] when no suffix of the stream has occurred before."""
        if k <= 0 or not tokens:
            return []
        self._sync(uid, tokens)
        toks = self._toks[uid]
        L = len(toks)
        for n in range(min(self.ngram_max, L), self.ngram_min - 1, -1):
            hits = self._index[uid][n].get(tuple(toks[L - n:]))
            if not hits:
                continue
            # most recent occurrence with a full k-token continuation,
            # else the longest continuation available
            full = [p for p in hits if p + n + k <= L]
            pos = full[-1] if full else min(hits)
            return toks[pos + n:pos + n + k]
        return []

    def flush(self, uid: int) -> None:
        self._toks.pop(uid, None)
        self._index.pop(uid, None)
        self._indexed.pop(uid, None)


class DraftModelDrafter:
    """Draft-model drafter: greedy-decodes K candidates from a SMALL model
    served by its own :class:`InferenceEngineV2` on the same device.

    The draft engine's paged KV shadows the accepted stream lazily: each
    ``draft`` call diffs the caller's stream against what the draft cache
    holds, truncates past the divergence point with the same zero-copy
    ``rollback_kv`` the target uses (rejected draft rows simply get
    overwritten), appends any missing accepted tokens through ``put``, and
    runs one fused K-step decode window for the candidates.  This makes
    preemption/resume and rejection handling free — the drafter never
    needs to be told, it just resyncs.

    Build the draft engine from a training checkpoint with
    :func:`draft_engine_from_checkpoint` (parameters only), or hand one
    in: an engine over the target's own model object (its own small pool,
    no weight copy) drafts the target's greedy chain.
    """

    def __init__(self, engine):
        self.eng = engine
        self._hist: Dict[int, List[int]] = {}   # tokens in the draft KV

    def draft(self, uid: int, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not tokens:
            return []
        eng = self.eng
        c = eng.config
        # capacity guard: the draft decode extends the cache to
        # len(tokens) - 1 + k tokens
        k = min(k, c.max_ctx - len(tokens))
        if k <= 0:
            return []
        tokens = [int(t) for t in tokens]
        target_ctx = tokens[:-1]              # seed is decoded, not put()
        known = self._hist.get(uid, [])
        cp = 0
        m = min(len(known), len(target_ctx))
        while cp < m and known[cp] == target_ctx[cp]:
            cp += 1
        if cp < len(known):
            # diverged (rejected candidates from the previous window):
            # truncate, then overwrite — no page copies
            eng.rollback_kv(uid, cp)
        pos = cp
        while pos < len(target_ctx):          # append missing accepted ctx
            chunk = target_ctx[pos:pos + c.max_tokens]
            eng.put([uid], [chunk])
            pos += len(chunk)
        toks = eng.decode_batch([uid], [tokens[-1]], k)
        cand = [int(t) for t in toks[:, 0]]
        # decode_batch appends seed..cand[:-1]; the last candidate is the
        # draft cache's next seed, not cached — mirror that bookkeeping
        self._hist[uid] = tokens + cand[:-1]
        return cand

    def flush(self, uid: int) -> None:
        self._hist.pop(uid, None)
        if self.eng.state_manager.get_sequence(uid) is not None:
            self.eng.flush([uid])


def make_drafter(config: SpeculativeConfig, draft_engine=None):
    """Config → drafter instance (None for mode='off')."""
    if config.mode == "off":
        return None
    if config.mode == "ngram":
        return NGramDrafter(ngram_max=config.ngram_max,
                            ngram_min=config.ngram_min)
    if draft_engine is None:
        raise ValueError("speculative.mode='draft_model' needs a draft "
                         "engine (see draft_engine_from_checkpoint)")
    return DraftModelDrafter(draft_engine)


def draft_engine_from_checkpoint(ckpt_dir: str, model, engine_config=None,
                                 tag: Optional[str] = None, dtype=None,
                                 device=None):
    """A draft engine serving the parameters of a training checkpoint of
    the port (``engine_factory.build_engine_from_ds_checkpoint``: the
    parameters only, cast to the serving dtype; optimizer state is never
    read)."""
    from .engine_factory import build_engine_from_ds_checkpoint

    return build_engine_from_ds_checkpoint(ckpt_dir, model,
                                           engine_config=engine_config,
                                           tag=tag, dtype=dtype,
                                           device=device)


def speculative_decode(engine, drafter, uids: Sequence[int],
                       seed_tokens: Sequence[int],
                       histories: Sequence[Sequence[int]], steps: int,
                       k: int) -> Tuple[Dict[int, List[int]], Dict]:
    """Engine-direct speculative decoding: run verify windows over ``uids``
    until every sequence has at least ``steps`` new tokens.

    Returns the FULL accepted streams — a sequence may overshoot
    ``steps`` by up to k tokens (callers compare prefixes).  Trimming
    here would desync callers that chain further windows: the engine's
    KV already contains the overshoot, so the continuation seed must be
    the true last accepted token.

    ``histories[i]`` is uid i's full stream so far, ENDING with
    ``seed_tokens[i]`` (the next decode input, not yet cached) — the same
    invariant the lifecycle scheduler maintains (``lifecycle.py``, which
    drives verify windows itself because it interleaves lifecycle
    passes).

    Returns ``({uid: first-steps tokens}, stats)`` where stats carries
    windows / drafted / accepted_draft / draft_s / verify_s for
    acceptance-rate and overhead reporting."""
    if not len(uids) == len(seed_tokens) == len(histories):
        raise ValueError("uids, seed_tokens and histories differ in length")
    produced: Dict[int, List[int]] = {u: [] for u in uids}
    hist = {u: [int(t) for t in h] for u, h in zip(uids, histories)}
    seeds = {u: int(s) for u, s in zip(uids, seed_tokens)}
    for u, h in hist.items():
        if not h or h[-1] != seeds[u]:
            raise ValueError(f"history for uid {u} must end with its seed "
                             f"token")
    stats = {"windows": 0, "drafted": 0, "accepted_draft": 0,
             "emitted": 0, "draft_s": 0.0, "verify_s": 0.0}
    while min(len(produced[u]) for u in uids) < steps:
        t0 = time.perf_counter()
        drafts = [drafter.draft(u, hist[u], k)[:k] if drafter else []
                  for u in uids]
        draft_s = time.perf_counter() - t0
        res = engine.verify_decode(uids, [seeds[u] for u in uids], drafts)
        if res.nonfinite_uids:
            raise RuntimeError(f"non-finite logits for uids "
                               f"{res.nonfinite_uids} during verify window")
        for u, acc in zip(uids, res.accepted):
            produced[u].extend(acc)
            hist[u].extend(acc)
            seeds[u] = acc[-1]
        stats["windows"] += 1
        stats["drafted"] += res.drafted
        stats["accepted_draft"] += res.accepted_draft
        stats["emitted"] += res.emitted
        stats["draft_s"] += draft_s
        stats["verify_s"] += res.duration_s
    if stats["drafted"]:
        stats["acceptance_rate"] = round(
            stats["accepted_draft"] / stats["drafted"], 4)
    else:
        stats["acceptance_rate"] = 0.0
        logger.debug("speculative_decode: drafter proposed nothing "
                     f"({stats['windows']} windows degenerated to "
                     "single-token verify)")
    return produced, stats
