"""Serving request lifecycle for the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2/lifecycle.py``): admission, deadlines,
cancellation, KV-pressure preemption, and the decode watchdog.

The :class:`ContinuousBatcher` (engine_v2.py) drives a CLOSED set of
requests to completion; a server faces an OPEN stream where requests die
mid-flight: clients disconnect, deadlines pass, the KV pool saturates, a
decode window hangs or goes NaN.  :class:`LifecycleScheduler` owns that
survivability layer on top of the engine primitives:

  * **Bounded admission + overload shedding** — ``submit`` rejects when the
    waiting queue is full (or the server is draining) and computes a
    ``Retry-After`` from the decode roofline's predicted drain rate, so an
    overloaded server answers in O(1) instead of queueing unboundedly
    (``serving/shed``).
  * **Deadlines and TTFT timeouts** — checked every scheduler iteration,
    which is at most one bounded decode window (``window_steps`` tokens)
    long: an expired request is flushed and its KV blocks reclaimed at the
    next window boundary — mid-stream, never "after it finishes"
    (``serving/deadline_expired``, ``serving/ttft_timeout``).
  * **Cancellation** — ``cancel(uid)`` (client disconnect) flushes the
    sequence and returns its blocks to the pool; the freed blocks are
    immediately re-admittable (``serving/cancelled``).
  * **KV-pressure preemption** — when the pool is above the high watermark
    and the queue head cannot reserve blocks, the lowest-priority decoding
    request is preempted: its generated tokens are spilled host-side (they
    already live there), its blocks are flushed, and it re-queues for
    **prefill recompute** — the resume prompt is ``prompt + produced[:-1]``
    and the next decode seed is ``produced[-1]``, which rebuilds exactly
    the KV state the interrupted stream had, so greedy decode continues
    bit-identically on the CPU (``serving/preempted``; test-asserted under
    both attn impls).  On the card a recompute re-prefills in other chunks
    and later windows have other batchmates, so the kernels round
    differently and the resumed stream may part from the uninterrupted one
    at a near-tie of the logits.  With a host tier the victim's rows are
    swapped out instead and the resume is a copy back.
  * **Decode watchdog** — every drained window reports per-sequence
    non-finite flags (model_runner.build_decode_loop): poisoned requests
    are flushed ALONE (kernel-level NaN isolation extended to the
    scheduler, ``serving/nan_isolated``) and a window whose wall time blows
    the hang deadline raises a ``serving_window_hang`` incident — both
    reflected in ``/healthz`` as ``degraded``.  A window flagged
    ``compiled`` (the first of its decode-loop key in the process, which
    may pay the kernel libraries' first-use build) is exempt.

Whole-lifetime block reservation at admission (as in ContinuousBatcher)
means a live request can never hit out-of-blocks mid-flight; the only
allocation point is admission, which is exactly where the ``kv_alloc``
fault-injection site fires.

Thread safety: ``submit``/``cancel`` are called from HTTP handler threads,
``step``/``drain`` from the driver thread; all state is guarded by one
reentrant lock.  Request callbacks (``on_event``) run inline under that
lock and must only hand off (enqueue) — the HTTP server's callbacks do.
Every engine call (and so every CUDA launch but a ``/v1/prefill``
answer's wire encoding, see ``server.py``) runs on the thread that calls
``step``.

Telemetry: the JAX scheduler mirrors its counters, histograms, events,
gauges, request-trace spans and goodput books into the telemetry plane.
That plane is not ported yet (ROADMAP M11): ``self.counters`` is kept, as
the JAX scheduler keeps it with no telemetry hub installed, and every
other hook is a no-op, each in one place below (``_record_goodput``,
``_goodput_residual``, and the methods under "Telemetry hooks").
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ...utils.logging import logger
from .engine_v2 import InferenceEngineV2
from .model_runner import sample_tokens


def _record_goodput(category: str, seconds: float, **labels) -> None:
    """Goodput accounting (wall time by category): ROADMAP M11, a no-op
    until the port has the telemetry plane."""


@contextlib.contextmanager
def _goodput_residual(category: str):
    """The goodput ledger's residual envelope: ROADMAP M11, a no-op."""
    yield


class RequestState(Enum):
    QUEUED = "queued"          # admitted to the waiting queue
    PREFILL = "prefill"        # holds KV blocks, prompt chunks in flight
    DECODE = "decode"          # generating
    FINISHED = "finished"      # terminal: completed normally
    CANCELLED = "cancelled"    # terminal: client cancelled / disconnected
    EXPIRED = "expired"        # terminal: deadline / TTFT timeout / drain
    SHED = "shed"              # terminal: rejected at admission (overload)
    FAILED = "failed"          # terminal: poisoned window, engine error

TERMINAL_STATES = (RequestState.FINISHED, RequestState.CANCELLED,
                   RequestState.EXPIRED, RequestState.SHED,
                   RequestState.FAILED)


@dataclasses.dataclass
class ServeRequest:
    """One request's full lifecycle record.

    ``deadline_s`` / ``ttft_timeout_s`` are RELATIVE seconds at submit time
    and converted to absolute monotonic deadlines on admission.  ``priority``
    is higher-wins (preemption victims are picked lowest-priority first).
    ``on_event(event, request)`` fires on: ``tokens`` (new tokens appended —
    the streaming hook), ``finished``, ``cancelled``, ``expired``,
    ``preempted``, ``failed``.
    """

    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    priority: int = 0
    deadline_s: Optional[float] = None
    ttft_timeout_s: Optional[float] = None
    on_event: Optional[Callable[[str, "ServeRequest"], None]] = None
    #: per-request speculative-decoding override (`/v1/generate` grows
    #: ``speculative: {mode, k}``): ``spec_mode`` None inherits the
    #: scheduler default; "off" disables; any other mode enables the
    #: scheduler's configured drafter.  ``spec_k`` overrides the draft
    #: length for this request only.
    spec_mode: Optional[str] = None
    spec_k: Optional[int] = None
    #: QoS attribution (serving/fleet/qos): the admission class the
    #: router charged; stamped so every shed/latency record downstream
    #: names its tenant.  None = direct traffic, accounted as "default".
    tenant: Optional[str] = None
    #: disaggregated prefill (serving/fleet): ``prefill_only`` requests
    #: stop at prefill completion and export their KV rows into
    #: ``kv_shipment`` (a kv_ship.KVShipment) instead of decoding;
    #: ``kv_import`` carries a shipment produced elsewhere — its rows are
    #: grafted at admission so only the unshipped prompt tail (>= 1 token)
    #: prefills locally and the stream continues bit-exactly.
    prefill_only: bool = False
    #: (a kv_ship.KVShipment, or a DSKV1 frame as bytes, which admission
    #: decodes onto the engine's device)
    kv_import: Optional[object] = None
    #: fleet-wide request-trace context: the JAX scheduler appends typed
    #: spans under it and returns the finished trace in ``trace_result``.
    #: Request tracing is ROADMAP M11; both stay None in the port
    trace: Optional[object] = None
    trace_result: Optional[dict] = None

    # -- runtime state (scheduler-owned) --
    state: RequestState = RequestState.QUEUED
    kv_shipment: Optional[object] = None     # prefill_only export result
    prefix_hit_tokens: int = 0               # prompt tokens grafted, not run
    produced: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    arrival_t: float = 0.0
    first_token_t: Optional[float] = None
    finished_t: Optional[float] = None
    preempt_count: int = 0
    deadline_t: Optional[float] = None       # absolute, from deadline_s
    ttft_deadline_t: Optional[float] = None  # absolute, from ttft_timeout_s
    _admit_order: int = 0
    _prefill_pos: int = 0
    _resume_seed: Optional[int] = None       # set while resuming a preempt
    _prefix_counted: bool = False            # hit/miss recorded once
    #: wall-clock (time.time) marks for span timestamps (the spans are
    #: ROADMAP M11) — kept separate from the scheduler's injectable
    #: ``clock``
    _twall_submit: float = 0.0
    _twall_queue: float = 0.0                # reset on preemption re-queue
    _import_s: float = 0.0                   # kv_ship_import wall inside
    #                                          the last _reserve_for call

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.produced)

    @property
    def resume_prompt(self) -> List[int]:
        """Tokens to (re)prefill: the original prompt, plus — after a
        preemption — every produced token except the last, which becomes
        the decode seed instead (rebuilding the exact pre-preemption KV
        state)."""
        if self._resume_seed is None:
            return self.prompt
        return self.prompt + self.produced[:-1]

    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    def tpot_s(self) -> Optional[float]:
        """Time per output token over the decode phase."""
        if self.first_token_t is None or self.finished_t is None \
                or len(self.produced) < 2:
            return None
        return (self.finished_t - self.first_token_t) / \
            (len(self.produced) - 1)

    def _fire(self, event: str) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event, self)
            except Exception as e:  # noqa: BLE001 — a sink bug must not kill scheduling
                logger.warning(f"request {self.uid} on_event({event}) "
                               f"failed: {e!r}")


@dataclasses.dataclass
class AdmissionVerdict:
    admitted: bool
    reason: Optional[str] = None       # "queue_full" | "draining"
    retry_after_s: Optional[float] = None


class LifecycleScheduler:
    """Open-world serving scheduler over :class:`InferenceEngineV2`.

    One ``step()`` runs either a mixed prefill/admission forward (``put``)
    or one bounded fused decode window, after processing cancellations and
    deadline expiries — so no request ever waits more than one window for
    its lifecycle events to take effect.  The first token of a request is
    the engine's greedy choice (``model_runner.sample_tokens`` at
    temperature 0, as ``generate`` takes it), on the engine's device.
    """

    def __init__(self, engine: InferenceEngineV2, max_queue: int = 64,
                 window_steps: int = 8, kv_high_watermark: float = 0.9,
                 preempt: bool = True, hang_deadline_s: float = 30.0,
                 eos_token_id: Optional[int] = None,
                 fallback_tok_per_s: float = 32.0,
                 degraded_window_s: float = 60.0,
                 speculative=None, drafter=None,
                 clock: Callable[[], float] = time.monotonic):
        self.eng = engine
        self.max_queue = int(max_queue)
        self.window_steps = int(window_steps)
        self.kv_high_watermark = float(kv_high_watermark)
        self.preempt_enabled = bool(preempt)
        self.hang_deadline_s = float(hang_deadline_s)
        self.eos_token_id = eos_token_id
        self.fallback_tok_per_s = float(fallback_tok_per_s)
        self.degraded_window_s = float(degraded_window_s)
        self.clock = clock
        #: speculative decoding (SpeculativeConfig + drafter): when armed,
        #: decode windows become VERIFY windows — the drafter proposes K
        #: candidates per stream, the engine scores seed+K in one ragged
        #: pass, and the longest greedy-matching prefix is accepted.
        #: Greedy streams stay bit-exact; only tok/s changes.  A drafter
        #: instance may be handed in (draft_model mode needs its engine);
        #: otherwise it is built from the config.
        self.spec = speculative
        self.drafter = drafter
        if self.spec is not None and self.drafter is None:
            from .speculative import make_drafter

            self.drafter = make_drafter(self.spec)

        #: component label on spans this scheduler records (the serving
        #: server overwrites it with ``serve:<port>`` at start so fleet
        #: waterfalls name the replica, even in-process)
        self.trace_component = "serve"
        self._lock = threading.RLock()
        self._reqs: Dict[int, ServeRequest] = {}
        self._waiting: "collections.deque[int]" = collections.deque()
        self._prefilling: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._decodes: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()          # uid -> next seed token
        self._cancel_requested: set = set()
        self._admit_seq = 0
        self.draining = False
        self.counters: "collections.Counter[str]" = collections.Counter()
        self.last_incident_t: Optional[float] = None
        self.last_incident_kind: Optional[str] = None
        self.last_shed_t: Optional[float] = None

    # ------------------------------------------------------------------ #
    # Ingress (HTTP handler threads)
    # ------------------------------------------------------------------ #
    def submit(self, req: ServeRequest) -> AdmissionVerdict:
        """Admit to the bounded queue, or shed with a Retry-After."""
        with self._lock:
            t_shed0 = time.perf_counter()
            now = self.clock()
            req.arrival_t = now
            req._twall_submit = req._twall_queue = time.time()
            if req.deadline_s is not None:
                req.deadline_t = now + req.deadline_s
            if req.ttft_timeout_s is not None:
                req.ttft_deadline_t = now + req.ttft_timeout_s
            if req.uid in self._reqs:
                raise ValueError(f"uid {req.uid} already submitted")
            if not req.prompt:
                # nothing to condition on: trivially complete
                req.state = RequestState.FINISHED
                req.finish_reason = "empty_prompt"
                req.finished_t = now
                self._reqs[req.uid] = req
                self._trace_finish(req)
                req._fire("finished")
                return AdmissionVerdict(True)
            if self.draining:
                req.state = RequestState.SHED
                req.finish_reason = "draining"
                self._count("serving/shed")
                self._event("serving_shed", uid=req.uid, reason="draining",
                            tenant=req.tenant or "default",
                            trace=self._trace_id(req))
                self._tspan(req, "admission", t0=req._twall_submit,
                            dur_s=0.0, shed="draining",
                            tenant=req.tenant or "default")
                self._trace_finish(req)
                _record_goodput("shed", time.perf_counter() - t_shed0,
                               tenant=req.tenant or "default")
                return AdmissionVerdict(False, "draining",
                                        self.predicted_drain_s())
            if len(self._waiting) >= self.max_queue:
                req.state = RequestState.SHED
                req.finish_reason = "queue_full"
                self.last_shed_t = now
                self._count("serving/shed")
                self._event("serving_shed", uid=req.uid, reason="queue_full",
                            tenant=req.tenant or "default",
                            queue_depth=len(self._waiting),
                            trace=self._trace_id(req))
                self._tspan(req, "admission", t0=req._twall_submit,
                            dur_s=0.0, shed="queue_full",
                            tenant=req.tenant or "default")
                self._trace_finish(req)
                _record_goodput("shed", time.perf_counter() - t_shed0,
                               tenant=req.tenant or "default")
                return AdmissionVerdict(False, "queue_full",
                                        self.retry_after_s())
            self._reqs[req.uid] = req
            self._waiting.append(req.uid)
            self._count("serving/requests")
            self._publish_gauges()
            return AdmissionVerdict(True)

    def cancel(self, uid: int) -> bool:
        """Request cancellation (client disconnect); takes effect at the
        next scheduler iteration — at most one decode window away."""
        with self._lock:
            if uid not in self._reqs or \
                    self._reqs[uid].state in TERMINAL_STATES:
                return False
            self._cancel_requested.add(uid)
            return True

    def request(self, uid: int) -> Optional[ServeRequest]:
        with self._lock:
            return self._reqs.get(uid)

    @property
    def pending(self) -> int:
        """Live (non-terminal) request count."""
        with self._lock:
            return (len(self._waiting) + len(self._prefilling)
                    + len(self._decodes))

    # ------------------------------------------------------------------ #
    # Load prediction (Retry-After / drain estimates)
    # ------------------------------------------------------------------ #
    def predicted_tok_per_s(self) -> float:
        """Decode drain rate from the last clean decode-window roofline;
        the configured fallback before any window has been measured."""
        r = self.eng.last_decode_roofline
        if r and not r.get("compile_polluted") and \
                r.get("decode_tok_per_s", 0) > 0:
            return float(r["decode_tok_per_s"])
        return self.fallback_tok_per_s

    def outstanding_tokens(self) -> int:
        with self._lock:
            return sum(self._reqs[u].remaining
                       for bucket in (self._waiting, self._prefilling,
                                      self._decodes)
                       for u in bucket)

    def retry_after_s(self) -> float:
        """Seconds until one queue slot is predicted to free: the whole
        backlog's remaining tokens over the predicted drain rate, scaled to
        one slot."""
        backlog = self.outstanding_tokens()
        slots = max(len(self._waiting) + len(self._prefilling)
                    + len(self._decodes), 1)
        per_slot = backlog / slots / self.predicted_tok_per_s()
        return float(min(max(per_slot, 1.0), 120.0))

    def predicted_drain_s(self) -> float:
        """Predicted seconds to drain every live request (the Retry-After
        while draining, and the basis for drain-deadline sizing)."""
        return float(min(max(
            self.outstanding_tokens() / self.predicted_tok_per_s(),
            1.0), 600.0))

    # ------------------------------------------------------------------ #
    # Lifecycle passes
    # ------------------------------------------------------------------ #
    def _retire(self, req: ServeRequest, state: RequestState, reason: str,
                event: str, counter: Optional[str] = None) -> None:
        """Move a request to a terminal state, reclaiming its KV blocks."""
        uid = req.uid
        holds_blocks = uid in self._prefilling or uid in self._decodes
        self._waiting = collections.deque(
            u for u in self._waiting if u != uid)
        self._prefilling.pop(uid, None)
        self._decodes.pop(uid, None)
        if holds_blocks:
            self.eng.flush([uid])
        if self.drafter is not None:
            self.drafter.flush(uid)
        ksw = getattr(self.eng, "kv_swap", None)
        if ksw is not None:
            ksw.drop(uid)       # parked rows die with the request
        req.state = state
        req.finish_reason = reason
        req.finished_t = self.clock()
        if counter:
            self._count(counter)
        self._event(event, uid=uid, reason=reason,
                    produced=len(req.produced), trace=self._trace_id(req))
        self._trace_finish(req)
        req._fire(event.replace("serving_", ""))
        self._publish_gauges()

    def _process_cancellations(self) -> List[int]:
        done = []
        for uid in sorted(self._cancel_requested):
            req = self._reqs.get(uid)
            if req is not None and req.state not in TERMINAL_STATES:
                self._retire(req, RequestState.CANCELLED, "cancelled",
                             "serving_cancelled", "serving/cancelled")
                done.append(uid)
        self._cancel_requested.clear()
        return done

    def _process_expiries(self) -> List[int]:
        now = self.clock()
        done = []
        for req in list(self._reqs.values()):
            if req.state in TERMINAL_STATES:
                continue
            if req.deadline_t is not None and now >= req.deadline_t:
                self._retire(req, RequestState.EXPIRED, "deadline",
                             "serving_expired", "serving/deadline_expired")
                done.append(req.uid)
            elif (req.ttft_deadline_t is not None
                    and req.first_token_t is None
                    and now >= req.ttft_deadline_t):
                self._retire(req, RequestState.EXPIRED, "ttft_timeout",
                             "serving_expired", "serving/ttft_timeout")
                done.append(req.uid)
        return done

    # ------------------------------------------------------------------ #
    # KV-pressure preemption
    # ------------------------------------------------------------------ #
    def _maybe_preempt_for(self, head: ServeRequest) -> bool:
        """Preempt the lowest-priority decoding request so ``head`` can be
        admitted — only above the KV high watermark, and never a victim
        with strictly higher priority than the starved head."""
        if not self.preempt_enabled or not self._decodes:
            return False
        if self.eng.kv_used_fraction() < self.kv_high_watermark:
            return False
        victims = [self._reqs[u] for u in self._decodes]
        # anti-ping-pong: among equal priorities, a head that has itself
        # been preempted N times may only evict victims preempted >= N
        # times — two requests can then never evict each other in a cycle
        # (observed livelock: a 3-block and an 8-block request alternately
        # preempting each other forever on a 10-block pool)
        victims = [v for v in victims
                   if v.priority < head.priority
                   or (v.priority == head.priority
                       and v.preempt_count >= head.preempt_count)]
        if not victims:
            return False
        # lowest priority first; among equals the latest-admitted loses
        # (least work thrown away for FIFO arrival orders)
        victim = min(victims, key=lambda r: (r.priority, -r._admit_order))
        uid = victim.uid
        # host tier on: park the victim's coldest contiguous page-prefix
        # BEFORE the flush (the export is a pure read of still-live pages)
        # so resume is a swap-in instead of a prefill recompute; 0 tokens
        # spilled degrades to the pre-tier evict+recompute path
        swapped = 0
        ksw = getattr(self.eng, "kv_swap", None)
        if ksw is not None and victim.produced:
            swapped = ksw.spill(
                uid, victim.prompt + victim.produced[:-1])
        del self._decodes[uid]
        self.eng.flush([uid])                 # spill: produced stays host-side
        victim.state = RequestState.QUEUED
        victim.preempt_count += 1
        victim._resume_seed = victim.produced[-1]
        victim._prefill_pos = 0
        self._waiting.append(uid)             # re-admitted behind the head
        self._count("serving/preempted")
        if swapped:
            self._count("serving/swap_out")
            self._count("serving/swap_out_tokens", swapped)
        self._event("serving_preempted", uid=uid, for_uid=head.uid,
                    produced=len(victim.produced), swapped=swapped,
                    kv_used=round(self.eng.kv_used_fraction(), 4),
                    trace=self._trace_id(victim))
        self._tspan(victim, "preempt", t0=time.time(), dur_s=0.0,
                    for_uid=head.uid, produced=len(victim.produced))
        victim._twall_queue = time.time()     # the next queue_wait span
        victim._fire("preempted")
        logger.info(f"KV pressure: preempted uid {uid} "
                    f"({len(victim.produced)} tokens spilled) to admit "
                    f"uid {head.uid}")
        return True

    # ------------------------------------------------------------------ #
    # Scheduling
    # ------------------------------------------------------------------ #
    def _reserve_for(self, req: ServeRequest) -> Optional[bool]:
        """Whole-lifetime KV reservation for admission.  Returns True on
        success, False on transient exhaustion (backpressure), None when
        the request can never fit (rejected).

        Before reserving, two graft paths may pre-seed the sequence's KV:

          * a ``kv_import`` shipment (disaggregated prefill handoff) is
            validated against the request's own prompt and scattered into
            freshly-allocated pages — only the unshipped tail prefills;
          * otherwise the radix prefix cache is consulted and the longest
            committed prefix is grafted (shared full pages + a CoW'd
            partial tail).

        Either way ``_prefill_pos`` advances past the grafted rows and the
        reservation covers only the remainder.  On a FAILED reservation
        the graft is fully released (flush) so a waiting queue head holds
        zero blocks — grafted pages stay evictable in the trie, and the
        retry re-grafts for a few microseconds of host work."""
        c = self.eng.config
        need, need_blocks = self.eng.lifetime_reservation(
            len(req.resume_prompt), req.remaining)
        if (len(req.resume_prompt) > c.max_ctx
                or (self.eos_token_id is None
                    and len(req.resume_prompt) + req.remaining > c.max_ctx)
                or need_blocks > self.eng.kv.config.num_blocks):
            # impossible under ANY load (an eos can cut a long generation
            # short, so only the eos-less overrun is deterministic): reject
            # now instead of wedging the queue head
            return None
        sm = self.eng.state_manager
        ksw = getattr(self.eng, "kv_swap", None)
        swapped_in = False
        if sm.get_sequence(req.uid) is None:
            req._prefill_pos = 0
            if (ksw is not None and req._resume_seed is not None
                    and ksw.entry(req.uid) is not None):
                # swap-in resume: the preempt path parked this uid's rows
                # host-side, and they cover MORE than any original
                # kv_import shipment (prompt + produced so far), so this
                # branch wins.  Same cheap feasibility gate as kv_import:
                # evict cache slack, then bail before touching the device.
                if need_blocks > sm.allocator.free_blocks and \
                        sm.prefix_cache is not None:
                    sm.prefix_cache.evict(
                        need_blocks - sm.allocator.free_blocks)
                if need_blocks > sm.allocator.free_blocks:
                    return False
                t0w, t0p = time.time(), time.perf_counter()
                n = ksw.restore(req.uid, req.resume_prompt)
                if n:
                    req._import_s = time.perf_counter() - t0p
                    self._tspan(req, "kv_swap_in", t0=t0w,
                                dur_s=req._import_s, tokens=n)
                    req._prefill_pos = n
                    swapped_in = True
                    self._count("serving/swap_in")
                    self._count("serving/swap_in_tokens", n)
                elif ksw.entry(req.uid) is not None:
                    return False    # transient exhaustion: rows stay
                                    # parked, the queue head retries
                else:
                    # rows were LRU-evicted / failed re-attestation /
                    # fault-injected away: recompute (bit-exact, slower)
                    self._count("serving/swap_miss")
            elif req.kv_import is not None:
                if isinstance(req.kv_import, (bytes, bytearray)):
                    # a DSKV1 frame posted to the server: decoded here, on
                    # the thread that runs the engine, onto its device
                    # (K10a dequantizes the int8 wire)
                    from .kv_ship import from_wire

                    try:
                        req.kv_import = from_wire(bytes(req.kv_import),
                                                  device=self.eng.device)
                    except ValueError:
                        return None        # a damaged frame: no retry helps
                ship = req.kv_import
                attested = [int(t) for t in
                            req.resume_prompt[:ship.n_tokens]]
                if (ship.n_tokens > len(req.resume_prompt) - 1
                        or list(ship.tokens) != attested):
                    # wrong conversation's KV: no retry can fix this
                    return None
                # feasibility gate BEFORE the device write: a blocked
                # queue head retries every pass, and importing (pages
                # scatter + decode-state invalidation) only to flush on a
                # failed reservation would repeat that work per window.
                # Evict cache slack first, then bail cheaply.
                if need_blocks > sm.allocator.free_blocks and \
                        sm.prefix_cache is not None:
                    sm.prefix_cache.evict(
                        need_blocks - sm.allocator.free_blocks)
                if need_blocks > sm.allocator.free_blocks:
                    return False
                from .kv_ship import import_kv

                t0w, t0p = time.time(), time.perf_counter()
                if not import_kv(self.eng, ship, req.uid):
                    return False           # transient exhaustion
                req._import_s = time.perf_counter() - t0p
                self._tspan(req, "kv_ship_import", t0=t0w,
                            dur_s=req._import_s, tokens=ship.n_tokens)
                req._prefill_pos = ship.n_tokens
            elif self.eng.prefix_cache is not None:
                matched = self.eng.graft_prefix(req.uid, req.resume_prompt)
                if matched:
                    req._prefill_pos = matched
        seq = sm.get_or_create_sequence(req.uid)
        # tenant label rides the reservation so the memory plane can
        # attribute this uid's KV pages fractionally per tenant
        self.eng.set_tenant(req.uid, req.tenant or "default")
        if not sm.maybe_allocate_kv(seq, need - seq.seen_tokens):
            # roll back so a shed/preempted retry starts clean: grafted /
            # imported blocks are released (shared pages survive in the
            # trie), an empty descriptor is popped
            if seq.blocks or seq.seen_tokens:
                sm.flush_sequence(req.uid)
            else:
                sm._seqs.pop(req.uid, None)
            req._prefill_pos = 0
            return False
        # count the graft ONLY on a successful reservation: a blocked
        # head releases and re-grafts every pass, and counting those
        # retries would inflate the hit stats (cache.note_hit/note_miss
        # exist for the same reason — match() itself is a pure lookup)
        cache = self.eng.prefix_cache
        if swapped_in:
            pass    # swap-in counters were recorded in the branch above
        elif req.kv_import is not None and req._prefill_pos:
            self._count("serving/kv_import")
            self._count("serving/kv_import_tokens", req._prefill_pos)
        elif cache is not None and req.prefix_hit_tokens == 0 \
                and not req._prefix_counted:
            req._prefix_counted = True
            if req._prefill_pos:
                req.prefix_hit_tokens = req._prefill_pos
                cache.note_hit(req._prefill_pos)
                self._count("serving/prefix_hits")
                self._count("serving/prefix_hit_tokens", req._prefill_pos)
            else:
                cache.note_miss()
        return True

    def _build_prefill_batch(self) -> List[Tuple[int, List[int]]]:
        """Chunks for one ``put``: in-flight prefills first, then admit
        from the queue head (with preemption when starved under
        pressure)."""
        c = self.eng.config
        budget = c.max_tokens
        picked: List[Tuple[int, List[int]]] = []
        for uid in list(self._prefilling):
            if budget <= 0 or len(picked) >= c.max_seqs:
                break
            req = self._reqs[uid]
            chunk = req.resume_prompt[req._prefill_pos:
                                      req._prefill_pos + budget]
            picked.append((uid, chunk))
            budget -= len(chunk)
        preempted_this_pass = False
        while self._waiting and budget > 0 and len(picked) < c.max_seqs:
            head = self._reqs[self._waiting[0]]
            t0w, t0p = time.time(), time.perf_counter()
            head._import_s = 0.0
            verdict = self._reserve_for(head)
            if verdict is True:
                # admission succeeded: close the queue_wait segment
                # (re-opened by preemption) and record the reservation /
                # graft work as the admission segment — MINUS the KV
                # import, which has its own kv_ship_import span (segments
                # must stay disjoint or the decomposition sums lie)
                self._tspan(head, "queue_wait", t0=head._twall_queue,
                            dur_s=max(t0w - head._twall_queue, 0.0))
                # tenant rides the admission span so a recorded
                # traces.jsonl stays convertible into a replayable
                # workload even without a router in front
                self._tspan(head, "admission", t0=t0w,
                            dur_s=max(time.perf_counter() - t0p
                                      - head._import_s, 0.0),
                            prefix_hit=head._prefill_pos
                            if head.kv_import is None else 0,
                            tenant=head.tenant or "default")
            if verdict is None:
                self._waiting.popleft()
                self._retire(head, RequestState.FAILED, "impossible",
                             "serving_rejected", "serving/rejected")
                continue
            if verdict is False:
                # backpressure: try one preemption, then re-check; a
                # second failure this pass means the pool genuinely cannot
                # host the head yet — it keeps its place in the queue
                if not preempted_this_pass and self._maybe_preempt_for(head):
                    preempted_this_pass = True
                    continue
                break
            self._waiting.popleft()
            head.state = RequestState.PREFILL
            self._prefilling[head.uid] = None
            self._admit_seq += 1
            head._admit_order = self._admit_seq
            # _prefill_pos may start past 0: grafted prefix / imported KV
            # rows are already cached, so only the remainder runs
            chunk = head.resume_prompt[head._prefill_pos:
                                       head._prefill_pos + budget]
            picked.append((head.uid, chunk))
            budget -= len(chunk)
        return picked

    def _run_prefill(self, batch: List[Tuple[int, List[int]]]) -> List[int]:
        t0w, t0p = time.time(), time.perf_counter()
        logits = self.eng.put([u for u, _ in batch], [t for _, t in batch])
        put_s = time.perf_counter() - t0p
        # the goodput ledger splits the forward's wall across riders by
        # chunk size (preemption recompute vs useful prefill): ROADMAP M11
        finished: List[int] = []
        firsts = None                # the rows' greedy tokens, host-side
        now = self.clock()
        for row, (uid, chunk) in enumerate(batch):
            req = self._reqs[uid]
            # the whole forward's wall is attributed to every rider: the
            # request really did spend that time inside this batch
            self._tspan(req, "prefill", t0=t0w, dur_s=put_s,
                        tokens=len(chunk), batch=len(batch),
                        resume=req._resume_seed is not None)
            req._prefill_pos += len(chunk)
            if req._prefill_pos < len(req.resume_prompt):
                continue                       # mid-prompt; logits unused
            # prefill complete: commit the full prompt pages to the radix
            # cache NOW (not at retirement) so concurrent staggered
            # requests sharing the prefix hit while this one still decodes
            self.eng.commit_prefix(uid, req.resume_prompt)
            if req.prefill_only:
                # disaggregated-prefill producer: export the rows, finish
                # without decoding a single token (_retire pops the
                # prefilling entry and reclaims the blocks — the export
                # above it is a pure read).  The shipment's rows are a
                # COPY of the pages, enqueued on this thread's stream
                # before _retire frees the blocks: a later put that reuses
                # them is enqueued after the copy on the same stream, so it
                # cannot overwrite what the copy reads, and the /v1/prefill
                # handler thread encodes (K9a on the int8 wire) a tensor
                # nothing else writes, enqueued after the copy as well
                from .kv_ship import export_kv

                te_w, te_p = time.time(), time.perf_counter()
                req.kv_shipment = export_kv(self.eng, uid,
                                            req.resume_prompt)
                self._tspan(req, "kv_ship_encode", t0=te_w,
                            dur_s=time.perf_counter() - te_p,
                            tokens=req.kv_shipment.n_tokens)
                self._count("serving/completed")
                self._retire(req, RequestState.FINISHED, "prefill_done",
                             "serving_finished", "serving/prefill_exported")
                finished.append(uid)
                continue
            del self._prefilling[uid]
            req.state = RequestState.DECODE
            if req._resume_seed is not None:
                # preemption resume: KV is rebuilt, the next decode seed is
                # the spilled stream's last token — NOT a fresh argmax
                # (which would re-derive the token it already produced)
                seed = int(req._resume_seed)
                req._resume_seed = None
                self._tspan(req, "resume", t0=time.time(), dur_s=0.0,
                            produced=len(req.produced))
            else:
                if firsts is None:
                    # the greedy rule of the port's generate, on the
                    # device, one copy to the host for the whole batch
                    with torch.inference_mode():
                        firsts = sample_tokens(
                            logits[:len(batch)]).cpu().tolist()
                seed = int(firsts[row])
                req.produced.append(seed)
                req.first_token_t = now
                self._observe("serving/ttft_s", req.ttft_s())
                req._fire("tokens")
                if self._finished_by(req, seed):
                    self._finish(req)
                    finished.append(uid)
                    continue
            self._decodes[uid] = seed
        self._publish_gauges()
        return finished

    def _finished_by(self, req: ServeRequest, tok: int) -> bool:
        return ((self.eos_token_id is not None and tok == self.eos_token_id)
                or req.remaining <= 0)

    def _finish(self, req: ServeRequest) -> None:
        self._decodes.pop(req.uid, None)
        # the tail prompt page goes quiet forever now — commit it too
        # (allow_partial), so sub-page prefixes become reusable; full pages
        # were committed at prefill completion
        self.eng.commit_prefix(req.uid, req.prompt, allow_partial=True)
        self.eng.flush([req.uid])
        if self.drafter is not None:
            self.drafter.flush(req.uid)
        ksw = getattr(self.eng, "kv_swap", None)
        if ksw is not None:
            ksw.drop(req.uid)
        req.state = RequestState.FINISHED
        req.finish_reason = "eos" if (
            self.eos_token_id is not None and req.produced
            and req.produced[-1] == self.eos_token_id) else "length"
        req.finished_t = self.clock()
        self._count("serving/completed")
        self._observe("serving/tpot_s", req.tpot_s())
        self._event("serving_finished", uid=req.uid,
                    produced=len(req.produced), reason=req.finish_reason,
                    trace=self._trace_id(req))
        self._trace_finish(req)
        req._fire("finished")
        self._publish_gauges()

    def _run_decode_window(self) -> List[int]:
        """One bounded fused decode window over up to max_seqs decoding
        requests (round-robin rotated), with watchdog + NaN isolation at
        drain."""
        c = self.eng.config
        n = min(len(self._decodes), c.max_seqs, c.max_tokens)
        uids = []
        for _ in range(n):
            uid, seed = self._decodes.popitem(last=False)
            uids.append(uid)
            self._decodes[uid] = seed          # rotate to the back
        # context-cap guard (eos-expected requests reserve less than
        # prompt+max_new): a sequence with no KV room left cannot decode —
        # retire it instead of wedging the window
        room = {}
        for uid in list(uids):
            seq = self.eng.state_manager.get_sequence(uid)
            room[uid] = c.max_ctx - seq.seen_tokens
            if room[uid] <= 0:
                uids.remove(uid)
                self._retire(self._reqs[uid], RequestState.FAILED,
                             "ctx_overflow", "serving_rejected",
                             "serving/rejected")
        if not uids:
            return []
        if self.drafter is not None and \
                any(self._spec_k_for(self._reqs[u]) > 0 for u in uids):
            return self._run_verify_window(uids, room)
        steps = min(self.window_steps,
                    min(self._reqs[u].remaining for u in uids),
                    min(room[u] for u in uids))
        if steps > 2:       # pow2 quantize: one decode-loop key per window size
            steps = 1 << (steps.bit_length() - 1)
        seeds = [self._decodes[u] for u in uids]
        window = self.eng.decode_batch_async(uids, seeds, steps)
        toks = window.tokens()
        streams = [[int(t) for t in toks[:, col]]
                   for col in range(len(uids))]
        return self._apply_window_results(
            uids, streams, set(window.nonfinite_uids()),
            wall_s=window.duration_s, compiled=window.compiled)

    def _apply_window_results(self, uids: List[int],
                              streams: List[List[int]], poisoned: set,
                              wall_s: Optional[float],
                              compiled: bool,
                              span_kind: str = "decode_window",
                              span_wall_s: Optional[float] = None
                              ) -> List[int]:
        """Shared tail of fused-decode and verify windows: post-hoc hang
        detection, per-request NaN isolation, eos truncation, finish /
        rotate bookkeeping.  ``streams[i]`` is uid i's newly produced
        tokens (ignored for poisoned uids).  ``span_wall_s`` narrows the
        recorded span below the hang-check wall when part of the wall is
        attributed elsewhere (verify windows: drafting has its own
        span)."""
        finished: List[int] = []
        # goodput: the window wall is attributed ONCE (not per rider) —
        # first-use windows are ``compile`` (here: the first use of the
        # key's shapes, which may pay the kernel libraries' build), drained
        # windows are useful decode work (verify windows include their
        # draft host time)
        if wall_s is not None:
            _record_goodput("compile" if compiled else "compute", wall_s)
        # window span per rider — a first-use (compiled) window is typed
        # ``compile``, keeping the decode_window decomposition clean of
        # first-use pollution exactly like the roofline
        if wall_s is not None:
            span_s = wall_s if span_wall_s is None else span_wall_s
            t0w = time.time() - span_s
            kind = "compile" if compiled else span_kind
            for uid, stream in zip(uids, streams):
                self._tspan(self._reqs[uid], kind, t0=t0w, dur_s=span_s,
                            n_seqs=len(uids), tokens=len(stream),
                            window=self.eng.decode_windows_dispatched)
        if not compiled and wall_s is not None \
                and wall_s > self.hang_deadline_s:
            # post-hoc hang detection: the window drained, but took longer
            # than the deadline — a stuck DMA / pathological host stall.
            self.last_incident_t = self.clock()
            self.last_incident_kind = "window_hang"
            self._count("serving/window_hang")
            self._event("serving_window_hang", uids=list(uids),
                        duration_s=round(wall_s, 3),
                        deadline_s=self.hang_deadline_s,
                        traces=[self._trace_id(self._reqs[u])
                                for u in uids])

        if poisoned:
            self.last_incident_t = self.clock()
            self.last_incident_kind = "nan"
        for uid, stream in zip(uids, streams):
            req = self._reqs[uid]
            if uid in poisoned:
                # flush ONLY the poisoned request; batchmates are clean by
                # the kernel-level isolation property and keep decoding
                self._count("serving/nan_isolated")
                self._retire(req, RequestState.FAILED, "nan",
                             "serving_nan_isolated")
                finished.append(uid)
                continue
            stream = list(stream)
            if self.eos_token_id is not None and \
                    self.eos_token_id in stream:
                stream = stream[:stream.index(self.eos_token_id) + 1]
            req.produced.extend(stream)
            req._fire("tokens")
            if self._finished_by(req, req.produced[-1]):
                self._finish(req)
                finished.append(uid)
            else:
                self._decodes[uid] = req.produced[-1]
        self._publish_gauges()
        return finished

    # ------------------------------------------------------------------ #
    # Speculative decoding (verify windows)
    # ------------------------------------------------------------------ #
    def _spec_k_for(self, req: ServeRequest) -> int:
        """Effective draft length for a request: the per-request override
        (``speculative: {mode, k}`` on ``/v1/generate``) on top of the
        scheduler default.  A request's ``spec_mode`` acts as a toggle for
        the SERVER-configured drafter — a single scheduler runs one
        drafter, so requesting a different mode than the server's enables
        that drafter rather than building another."""
        if self.drafter is None:
            return 0
        mode = req.spec_mode if req.spec_mode is not None else \
            (self.spec.mode if self.spec else "off")
        if mode == "off":
            return 0
        k = req.spec_k if req.spec_k is not None else \
            (self.spec.k if self.spec else 0)
        return max(int(k), 0)

    def _run_verify_window(self, uids: List[int],
                           room: Dict[int, int]) -> List[int]:
        """One speculative verify window over the rotated decode set.

        Per stream the drafter proposes up to ``spec_k`` candidates —
        capped at ``remaining - 1`` and ``room - 1`` so the speculative
        append can never outgrow the whole-lifetime block reservation or
        the context cap (the admission invariant that live requests never
        allocate KV mid-flight survives speculation: verify-window allocs
        are always no-ops under a reservation), and at the engine's flat
        token budget: the window packs ``sum(1 + k_i)`` tokens into one
        ragged batch, so with every stream drafting the wide batch could
        exceed ``max_tokens`` and fail the pack — the leftover budget
        after the mandatory one-token-per-stream rows is dealt out in
        rotation order instead (late streams draft less this window, and
        the rotation moves the full allowance around).  Streams whose
        drafter has nothing to say ride along with an empty draft (a
        1-token verify is exactly one vanilla decode step).  Greedy
        bit-exactness, watchdog/NaN isolation, eos handling and
        preemption bookkeeping all mirror the fused-decode path."""
        t_d0w, t_d0 = time.time(), time.perf_counter()
        budget = self.eng.config.max_tokens - len(uids)   # draft allowance
        seeds, drafts = [], []
        for u in uids:
            req = self._reqs[u]
            cap = max(0, min(self._spec_k_for(req), req.remaining - 1,
                             room[u] - 1, budget))
            d = []
            if cap > 0:
                d = [int(t) for t in self.drafter.draft(
                    u, req.prompt + req.produced, cap)][:cap]
            budget -= len(d)
            drafts.append(d)
            seeds.append(self._decodes[u])
        draft_s = time.perf_counter() - t_d0
        for u, d in zip(uids, drafts):
            self._tspan(self._reqs[u], "draft", t0=t_d0w, dur_s=draft_s,
                        k=len(d))
        # (the JAX engine also takes draft_wall_s for its telemetry gauges,
        # ROADMAP M11)
        result = self.eng.verify_decode(uids, seeds, drafts)
        self._count("serving/spec_windows")
        if result.drafted:
            self._count("serving/spec_drafted", result.drafted)
        if result.accepted_draft:
            self._count("serving/spec_accepted", result.accepted_draft)
        return self._apply_window_results(
            uids, result.accepted, set(result.nonfinite_uids),
            wall_s=result.duration_s + draft_s, compiled=result.compiled,
            span_kind="verify", span_wall_s=result.duration_s)

    def step(self) -> List[int]:
        """One scheduler iteration; returns uids that reached a terminal
        state.  Lifecycle passes (cancel, expiry) run FIRST, so no request
        outlives its deadline by more than one bounded window."""
        with self._lock:
            done = self._process_cancellations()
            done += self._process_expiries()
            # prefill/admission first — finishing prefills frees the decode
            # path to run fused windows over the full live set.  A BLOCKED
            # queue head (reservation failed, no eligible preemption
            # victim) yields an empty batch: fall through to the decode
            # window so the live set keeps draining toward the capacity
            # the head is waiting for.
            batch = self._build_prefill_batch() \
                if (self._prefilling or self._waiting) else []
            if batch:
                done += self._run_prefill(batch)
            elif self._decodes:
                done += self._run_decode_window()
            return done

    def run_until_idle(self, max_iters: int = 10_000) -> None:
        """Drive until no live work remains (tests / batch mode)."""
        idle_guard = 0
        for _ in range(max_iters):
            if not self.pending:
                return
            before = self._progress_mark()
            self.step()
            idle_guard = idle_guard + 1 \
                if self._progress_mark() == before else 0
            if idle_guard > 3:
                raise RuntimeError(
                    f"scheduler made no progress ({self.pending} pending)")
        raise RuntimeError(f"not idle after {max_iters} iterations")

    def _progress_mark(self) -> Tuple[int, int]:
        return (sum(len(r.produced) for r in self._reqs.values())
                + sum(r._prefill_pos for r in self._reqs.values()),
                self.pending)

    # ------------------------------------------------------------------ #
    # Drain (SIGTERM path)
    # ------------------------------------------------------------------ #
    def start_drain(self) -> None:
        with self._lock:
            if not self.draining:
                self.draining = True
                self._event("serving_drain_start",
                            pending=self.pending,
                            predicted_s=self.predicted_drain_s())

    def drain(self, deadline_s: float = 30.0) -> Dict[str, int]:
        """Stop admitting, finish in-flight work bounded by the deadline;
        whatever is still live at the deadline is expired and flushed.
        Returns {completed, expired} counts for this drain."""
        self.start_drain()
        # goodput: the drain envelope is a residual — the windows it runs
        # attribute their own walls (compute/compile), only the loop's
        # remaining wall (scheduling, expiry mop-up) lands in ``drain``
        with _goodput_residual("drain"):
            t_end = self.clock() + deadline_s
            completed = 0
            while self.pending and self.clock() < t_end:
                try:
                    finished = self.step()
                except Exception as e:  # noqa: BLE001 — a raising step
                    # must not wedge the drain: whatever is still live gets
                    # expired and flushed by the mop-up below, and the
                    # server still exits
                    logger.error(f"drain step failed: {e!r}")
                    break
                for uid in finished:
                    if self._reqs[uid].state == RequestState.FINISHED:
                        completed += 1
            expired = 0
            with self._lock:
                for req in list(self._reqs.values()):
                    if req.state not in TERMINAL_STATES:
                        self._retire(req, RequestState.EXPIRED,
                                     "drain_deadline", "serving_expired",
                                     "serving/drain_expired")
                        expired += 1
                self._event("serving_drain_done", completed=completed,
                            expired=expired)
        return {"completed": completed, "expired": expired}

    # ------------------------------------------------------------------ #
    # Health / telemetry plumbing
    # ------------------------------------------------------------------ #
    def health_state(self) -> Tuple[str, List[str]]:
        """Serving status for /healthz: ``draining`` > ``degraded``
        (recent NaN/hang incident) > ``saturated`` (queue full or recent
        shed) > ``healthy``."""
        with self._lock:
            now = self.clock()
            if self.draining:
                return "draining", [f"{self.pending} request(s) in flight"]
            if self.last_incident_t is not None and \
                    now - self.last_incident_t <= self.degraded_window_s:
                return "degraded", [
                    f"{self.last_incident_kind} incident "
                    f"{now - self.last_incident_t:.0f}s ago"]
            reasons = []
            if len(self._waiting) >= self.max_queue:
                reasons.append(f"queue full ({len(self._waiting)}"
                               f"/{self.max_queue})")
            if self.last_shed_t is not None and \
                    now - self.last_shed_t <= self.degraded_window_s:
                reasons.append(
                    f"shed traffic {now - self.last_shed_t:.0f}s ago")
            if reasons:
                return "saturated", reasons
            return "healthy", []

    # ------------------------------------------------------------------ #
    # Telemetry hooks.  ``counters`` is kept (the JAX scheduler's own
    # record with no telemetry hub installed: /healthz and /metrics read
    # it); the rest mirrors into the telemetry plane, metrics registry and
    # request-trace store, which are ROADMAP M11: each is a no-op here.
    # ------------------------------------------------------------------ #
    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def _observe(self, name: str, value: Optional[float]) -> None:
        """Histogram sample (serving/ttft_s, serving/tpot_s): M11."""

    def _event(self, kind: str, **fields) -> None:
        """Structured event (serving_shed, serving_preempted, ...): M11."""

    def _publish_gauges(self) -> None:
        """Queue depth, active sequences, KV pressure, prefix hit rate
        gauges: M11."""

    def _tspan(self, req: ServeRequest, kind: str, t0: float, dur_s: float,
               **attrs) -> None:
        """A typed request-trace span: M11."""

    def _trace_finish(self, req: ServeRequest) -> None:
        """Close the request's trace into ``trace_result``: M11."""

    def _trace_id(self, req: ServeRequest) -> Optional[str]:
        return None
