"""HTTP ingest front end over the lifecycle scheduler, for the PyTorch port
(counterpart of ``deepspeed_tpu/inference/v2/server.py``)::

    python -m deepspeed_tpu_torch.inference.v2.server --model tiny --port 0

Built on the stdlib ``ThreadingHTTPServer``, one server exposes:

  * ``POST /v1/generate`` — submit a request (JSON body; token-id prompts).
    Non-streaming answers once the request reaches a terminal state;
    ``"stream": true`` answers as Server-Sent Events (``tokens`` events as
    they are produced, then one terminal event), reusing the live plane's
    SSE plumbing.  Overload shedding maps to HTTP: ``429`` (queue full) /
    ``503`` (draining), both with a ``Retry-After`` computed from the
    decode roofline's predicted drain rate.  A client disconnect mid-stream
    cancels the request — its KV blocks return to the pool at the next
    scheduler iteration.  ``kv_import`` (a base64 DSKV1 frame from another
    replica's ``/v1/prefill``) continues a prefilled prompt.
  * ``POST /v1/prefill`` — prefill only, answered with the prompt's KV
    rows as a base64 DSKV1 frame (``wire``: ``fp32`` or ``int8``).
  * ``GET /metrics`` — Prometheus text: the scheduler's counters, rendered
    directly (the JAX server renders its telemetry registry when one is
    installed; the port's telemetry plane is ROADMAP M11).
  * ``GET /healthz`` — serving states ``healthy`` | ``saturated`` (queue
    full / recent shedding) | ``draining`` (SIGTERM received) |
    ``degraded`` (recent NaN-poisoned or hung decode window); anything but
    ``healthy`` answers 503 so a dumb prober needs zero JSON parsing.
  * ``GET /traces``, ``/goodput``, ``/memory`` — 404 "not installed", as
    the JAX server answers with no trace store or ledger installed (the
    port's request tracing and ledgers are ROADMAP M11).

Threads: the driver thread runs ``scheduler.step`` and so every engine
call (puts, windows, the host tier's copies) and, at admission, the
decoding of a posted ``kv_import`` frame onto the engine's device (K10a on
the int8 wire).  Handler threads only submit and cancel — and a
``/v1/prefill`` answer encodes its shipment's rows on the handler thread
(K9a on the int8 wire), rows the scheduler copied out of the pool.

Graceful drain: SIGTERM (or :meth:`ServingServer.drain_and_stop`) flips
``/healthz`` to ``draining`` immediately, sheds new submissions with 503,
finishes (or deadline-expires) in-flight requests bounded by the drain
deadline, then stops the HTTP server and returns — ``main`` exits 0.
"""
from __future__ import annotations

import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import urlparse

from ...utils.logging import logger
from .lifecycle import (
    TERMINAL_STATES,
    AdmissionVerdict,
    LifecycleScheduler,
    RequestState,
    ServeRequest,
    _record_goodput,
)

#: terminal request state → HTTP status for the non-streaming answer
_TERMINAL_HTTP = {
    RequestState.FINISHED: 200,
    RequestState.EXPIRED: 504,     # deadline / TTFT passed server-side
    RequestState.CANCELLED: 499,   # client closed (nginx convention)
    RequestState.FAILED: 500,
}


#: what GET answers for the JAX server's telemetry endpoints, as it does
#: with nothing installed (ROADMAP M11)
_NOT_INSTALLED = {
    "/traces": "request tracing disabled (no trace store installed)",
    "/goodput": "goodput accounting not installed",
    "/memory": "memory ledger not installed",
}


class _ServingHandler(BaseHTTPRequestHandler):
    server_version = "dstpu-serve/1"
    protocol_version = "HTTP/1.1"
    _streaming = False

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        logger.debug("dstpu-serve: " + format % args)

    # ---------------------------------------------------------------- #
    def _send(self, code: int, body: bytes, content_type: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Any,
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(code, json.dumps(obj, default=str,
                                    sort_keys=True).encode() + b"\n",
                   "application/json", headers)

    # ---------------------------------------------------------------- #
    def do_GET(self):  # noqa: N802 — stdlib hook name
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._get_metrics()
            elif url.path == "/healthz":
                self._get_healthz()
            elif url.path in _NOT_INSTALLED:
                self._send_json(404, {"error": _NOT_INSTALLED[url.path]})
            elif url.path == "/":
                self._send_json(200, {"endpoints": [
                    "/v1/generate (POST)", "/v1/prefill (POST)", "/metrics",
                    "/healthz", "/traces", "/goodput", "/memory"]})
            else:
                self._send_json(404, {"error": f"unknown path {url.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — a handler bug must not 500 silently
            logger.warning(f"dstpu-serve {url.path} failed: {e!r}")
            if self._streaming:
                self.close_connection = True
                return
            try:
                self._send_json(500, {"error": repr(e)})
            except (OSError, ValueError):
                pass

    def do_POST(self):  # noqa: N802 — stdlib hook name
        url = urlparse(self.path)
        try:
            if url.path == "/v1/generate":
                self._post_generate()
            elif url.path == "/v1/prefill":
                self._post_prefill()
            else:
                self._send_json(404, {"error": f"unknown path {url.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.warning(f"dstpu-serve {url.path} failed: {e!r}")
            if self._streaming:
                self.close_connection = True
                return
            try:
                self._send_json(500, {"error": repr(e)})
            except (OSError, ValueError):
                pass

    # ---------------------------------------------------------------- #
    def _get_metrics(self) -> None:
        srv: "_ServingHTTPServer" = self.server
        lines = []
        for name, value in sorted(srv.owner.scheduler.counters.items()):
            prom = name.replace("/", "_")
            lines.append(f"# TYPE {prom} counter")
            lines.append(f"{prom} {value}")
        text = "\n".join(lines) + ("\n" if lines else "")
        self._send(200, text.encode(), "text/plain; version=0.0.4")

    def _get_healthz(self) -> None:
        """Machine-readable health: a structured JSON body (state, queue
        depth, KV pressure, predicted drain rate) the fleet router
        balances on — no prometheus-text scraping in the routing hot
        path.  Content negotiation keeps old plain-text consumers
        working: an ``Accept`` header preferring ``text/plain`` gets the
        bare status word (dumb probers also never parse anything — the
        status CODE alone says healthy/not)."""
        srv: "_ServingHTTPServer" = self.server
        sched = srv.owner.scheduler
        status, reasons = sched.health_state()
        code = 200 if status == "healthy" else 503
        accept = self.headers.get("Accept", "")
        if "text/plain" in accept and "application/json" not in accept:
            self._send(code, (status + "\n").encode(), "text/plain")
            return
        body = {
            "status": status,
            "state": status,            # alias: the router's field name
            "reasons": reasons,
            "pending": sched.pending,
            "queue_depth": len(sched._waiting),
            "kv_pressure": round(sched.eng.kv_used_fraction(), 4),
            "predicted_tok_per_s": round(sched.predicted_tok_per_s(), 3),
            "predicted_drain_s": round(sched.predicted_drain_s(), 3),
            "counters": dict(sched.counters),
            "ts": time.time(),
        }
        self._send_json(code, body)

    # ---------------------------------------------------------------- #
    def _post_generate(self) -> None:
        srv: "_ServingHTTPServer" = self.server
        owner = srv.owner
        length = int(self.headers.get("Content-Length", 0))
        # kv_import bodies carry base64 KV pages (L*n*2*KV*HD floats) and
        # legitimately dwarf a plain prompt — give them the same 64 MB
        # ceiling the router's ingest uses, keep 8 MB for everything else
        if length <= 0 or length > 64 * 1024 * 1024:
            self._send_json(400, {"error": "missing/oversized body"})
            return
        try:
            payload = json.loads(self.rfile.read(length))
            prompt = [int(t) for t in payload["prompt"]]
            # per-request speculative decoding: {"mode": off|ngram|
            # draft_model, "k": int} — mode toggles the server-configured
            # drafter, k overrides the draft length (see lifecycle.
            # LifecycleScheduler._spec_k_for)
            spec = payload.get("speculative") or {}
            if not isinstance(spec, dict):
                raise TypeError("speculative must be an object")
            spec_mode = spec.get("mode")
            if spec_mode is not None:
                from .speculative import SPEC_MODES

                if spec_mode not in SPEC_MODES:
                    raise ValueError(f"speculative.mode must be one of "
                                     f"{SPEC_MODES}")
            spec_k = spec.get("k")
            if spec_k is not None:
                spec_k = int(spec_k)
                if spec_k < 1:
                    raise ValueError("speculative.k must be >= 1")
            kv_import = None
            if payload.get("kv_import"):
                # disaggregated prefill handoff: a base64 DSKV1 frame from
                # a prefill replica's /v1/prefill response.  Only its
                # header is read here (host work); the scheduler decodes
                # the rows onto the engine's device at admission, on the
                # driver thread
                import base64
                import binascii

                from .kv_ship import read_header

                try:
                    kv_import = base64.b64decode(payload["kv_import"],
                                                 validate=True)
                except binascii.Error as e:
                    raise ValueError(f"kv_import is not base64: {e}")
                read_header(kv_import)
        except (ValueError, TypeError, KeyError) as e:
            self._send_json(400, {"error": f"bad request body: {e!r}"})
            return
        if spec_mode not in (None, "off") and \
                owner.scheduler.drafter is None:
            # fail at ADMISSION, not mid-stream: a replica without a
            # drafter cannot honor a speculative request, and silently
            # decoding vanilla would misreport what the client asked for
            self._send_json(400, {
                "error": "speculative decoding requested but no drafter "
                         "is configured on this replica",
                "reason": "no_drafter"})
            return
        stream = bool(payload.get("stream", False))
        # the request-trace context (forwarded or minted) is ROADMAP M11
        ctx = None

        events: "queue.Queue" = queue.Queue()
        req, verdict = owner.submit_request(
            prompt=prompt,
            max_new_tokens=int(payload.get("max_new_tokens", 32)),
            priority=int(payload.get("priority", 0)),
            deadline_s=payload.get("deadline_s"),
            ttft_timeout_s=payload.get("ttft_timeout_s"),
            spec_mode=spec_mode, spec_k=spec_k,
            kv_import=kv_import, tenant=payload.get("tenant"), trace=ctx,
            sink=events)
        if not verdict.admitted:
            code = 503 if verdict.reason == "draining" else 429
            self._send_json(code, {
                "error": "overloaded", "reason": verdict.reason,
                "tenant": req.tenant or "default",
                "retry_after_s": verdict.retry_after_s,
                **self._trace_fields(req),
            }, headers={"Retry-After":
                        str(int(round(verdict.retry_after_s or 1)))})
            return
        if stream:
            self._stream_response(owner, req, events)
        else:
            self._blocking_response(owner, req, events)

    def _post_prefill(self) -> None:
        """Disaggregated-prefill producer endpoint: prefill the posted
        tokens through the normal lifecycle (admission, shedding, prefix
        cache — everything /v1/generate gets) and answer with the KV rows
        as a base64 DSKV1 frame.  The caller (a router) ships the frame to
        a decode replica as ``kv_import``.  ``wire: "int8"`` quantizes
        the rows through the fused-wire kernel (K9a)."""
        srv: "_ServingHTTPServer" = self.server
        owner = srv.owner
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > 8 * 1024 * 1024:
            self._send_json(400, {"error": "missing/oversized body"})
            return
        try:
            payload = json.loads(self.rfile.read(length))
            prompt = [int(t) for t in payload["prompt"]]
            wire = payload.get("wire", "fp32")
            from .kv_ship import WIRE_FORMATS

            if wire not in WIRE_FORMATS:
                raise ValueError(f"wire must be one of {WIRE_FORMATS}")
            if not prompt:
                raise ValueError("empty prompt")
        except (ValueError, TypeError, KeyError) as e:
            self._send_json(400, {"error": f"bad request body: {e!r}"})
            return
        t0 = time.perf_counter()
        ctx = None                      # request tracing: ROADMAP M11
        events: "queue.Queue" = queue.Queue()
        req, verdict = owner.submit_request(
            prompt=prompt, max_new_tokens=0,
            priority=int(payload.get("priority", 0)),
            deadline_s=payload.get("deadline_s"),
            prefill_only=True, tenant=payload.get("tenant"),
            trace=ctx, sink=events)
        if not verdict.admitted:
            code = 503 if verdict.reason == "draining" else 429
            self._send_json(code, {
                "error": "overloaded", "reason": verdict.reason,
                "tenant": req.tenant or "default",
                "retry_after_s": verdict.retry_after_s,
                **self._trace_fields(req),
            }, headers={"Retry-After":
                        str(int(round(verdict.retry_after_s or 1)))})
            return
        while True:
            try:
                event, tokens, reason, state = events.get(
                    timeout=owner.request_poll_s)
            except queue.Empty:
                if owner.stopping.is_set():
                    self._send_json(503, {"error": "server stopping"})
                    return
                continue
            if state in TERMINAL_STATES:
                break
        if state != RequestState.FINISHED or req.kv_shipment is None:
            self._send_json(_TERMINAL_HTTP.get(state, 500), {
                "error": "prefill failed", "state": state.value,
                "finish_reason": reason, **self._trace_fields(req)})
            return
        from .kv_ship import to_b64

        # on this handler thread: the rows are the scheduler's copy of the
        # pool's pages (lifecycle._run_prefill), enqueued on the same
        # stream before this encode, which nothing else writes
        frame = to_b64(req.kv_shipment, wire=wire)
        self._send_json(200, {
            "uid": req.uid, "n_tokens": req.kv_shipment.n_tokens,
            "wire": wire, "prefix_hit_tokens": req.prefix_hit_tokens,
            "ship_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "kv": frame,
            **self._trace_fields(req),
        })

    @staticmethod
    def _trace_fields(req: ServeRequest) -> Dict[str, Any]:
        """In-band trace payload for a terminal answer: the trace id plus,
        when the upstream hop asked for them, this replica's finished
        spans.  Empty while request tracing is ROADMAP M11 (``req.trace``
        stays None)."""
        if req.trace is None:
            return {}
        out: Dict[str, Any] = {"trace_id": req.trace.trace_id}
        if req.trace.return_spans and req.trace_result is not None:
            out["trace"] = {
                "trace": req.trace_result["trace"],
                "uid": req.trace_result.get("uid"),
                "spans": req.trace_result.get("spans") or [],
                "flags": req.trace_result.get("flags") or [],
                "wall_s": req.trace_result.get("wall_s"),
            }
        return out

    def _blocking_response(self, owner: "ServingServer", req: ServeRequest,
                           events: "queue.Queue") -> None:
        while True:
            try:
                event, tokens, reason, state = events.get(
                    timeout=owner.request_poll_s)
            except queue.Empty:
                if owner.stopping.is_set():
                    self._send_json(503, {"error": "server stopping"})
                    return
                continue
            if state in TERMINAL_STATES:
                break
        self._send_json(_TERMINAL_HTTP.get(state, 200), {
            "uid": req.uid, "tokens": tokens, "finish_reason": reason,
            "state": state.value, "ttft_s": req.ttft_s(),
            "tpot_s": req.tpot_s(),
            **self._trace_fields(req),
        })

    def _client_gone(self) -> bool:
        """Prompt disconnect detection: an SSE client never sends more
        bytes, so a readable socket returning EOF means it closed.  Write
        failure alone is NOT enough — small event payloads buffer into the
        kernel without error and a short generation can finish before the
        first RST comes back."""
        import select
        import socket as _socket

        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, _socket.MSG_PEEK) == b""
        except OSError:
            return True

    def _stream_response(self, owner: "ServingServer", req: ServeRequest,
                         events: "queue.Queue") -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self._streaming = True
        sent = 0
        try:
            while True:
                if self._client_gone():
                    raise BrokenPipeError
                try:
                    event, tokens, reason, state = events.get(
                        timeout=owner.request_poll_s)
                except queue.Empty:
                    if owner.stopping.is_set():
                        return
                    continue
                fresh = tokens[sent:]
                if fresh or state in TERMINAL_STATES:
                    payload = {"uid": req.uid, "tokens": fresh,
                               "n_total": len(tokens)}
                    if state in TERMINAL_STATES:
                        payload["finish_reason"] = reason
                        payload["state"] = state.value
                        payload.update(self._trace_fields(req))
                    self.wfile.write(
                        f"event: {event}\ndata: "
                        f"{json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()
                    sent = len(tokens)
                if state in TERMINAL_STATES:
                    return
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: cancel → the scheduler flushes
            # the sequence and its blocks return to the pool
            owner.scheduler.cancel(req.uid)
            owner.kick()


class _ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "ServingServer" = None


class ServingServer:
    """Owner object: HTTP thread + scheduler driver thread + drain logic.

    The driver thread single-threads every engine interaction (the
    scheduler lock makes submit/cancel safe from handler threads, but the
    engine's forwards and windows, its host tier's pending copies and their
    events stay on one thread).  ``port=0`` binds a free port (tests).
    ``telemetry`` is kept for the JAX signature; the port's telemetry
    plane is ROADMAP M11, so it must be None."""

    def __init__(self, scheduler: LifecycleScheduler, telemetry=None,
                 port: int = 8791, bind: str = "0.0.0.0",
                 drain_deadline_s: float = 30.0,
                 driver_idle_s: float = 0.02, request_poll_s: float = 0.1):
        if telemetry is not None:
            raise NotImplementedError(
                "a telemetry hub needs the telemetry plane, which is not "
                "ported yet (ROADMAP M11)")
        self.scheduler = scheduler
        self.requested_port = int(port)
        self.bind = bind
        self.drain_deadline_s = float(drain_deadline_s)
        self.driver_idle_s = float(driver_idle_s)
        self.request_poll_s = float(request_poll_s)
        self.port: Optional[int] = None
        self.stopping = threading.Event()
        self.drained = threading.Event()
        self._work = threading.Event()
        self._uid_lock = threading.Lock()
        self._next_uid = 0
        self._server: Optional[_ServingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._driver_thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- #
    def submit_request(self, prompt: List[int], max_new_tokens: int = 32,
                       priority: int = 0, deadline_s=None,
                       ttft_timeout_s=None, spec_mode=None, spec_k=None,
                       prefill_only: bool = False, kv_import=None,
                       tenant=None, trace=None, sink: "queue.Queue" = None
                       ) -> "tuple[ServeRequest, AdmissionVerdict]":
        """Build + submit one request; lifecycle events are copied into
        ``sink`` as ``(event, tokens_copy, finish_reason, state)`` tuples
        (the handler threads consume them without touching scheduler
        state)."""
        with self._uid_lock:
            uid = self._next_uid
            self._next_uid += 1

        def on_event(event: str, r: ServeRequest) -> None:
            if sink is not None:
                sink.put((event, list(r.produced), r.finish_reason, r.state))

        req = ServeRequest(
            uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
            priority=priority,
            deadline_s=float(deadline_s) if deadline_s is not None else None,
            ttft_timeout_s=(float(ttft_timeout_s)
                            if ttft_timeout_s is not None else None),
            spec_mode=spec_mode, spec_k=spec_k,
            prefill_only=prefill_only, kv_import=kv_import,
            tenant=(str(tenant) if tenant else None),
            trace=trace, on_event=on_event)
        verdict = self.scheduler.submit(req)
        self.kick()
        return req, verdict

    def kick(self) -> None:
        """Wake the driver (new work / cancellation)."""
        self._work.set()

    # ---------------------------------------------------------------- #
    def _drive(self) -> None:
        while not self.stopping.is_set():
            if self.scheduler.pending:
                try:
                    self.scheduler.step()
                except Exception as e:  # noqa: BLE001 — driver must survive
                    logger.error(f"scheduler step failed: {e!r}")
                    time.sleep(self.driver_idle_s)
            else:
                # goodput: the empty-queue wait is the driver's explicit
                # idle — recorded so "idle because no traffic" is a
                # measured category, not just the derived remainder
                t_idle0 = time.perf_counter()
                self._work.wait(self.driver_idle_s)
                self._work.clear()
                _record_goodput("idle", time.perf_counter() - t_idle0)

    # ---------------------------------------------------------------- #
    def start(self) -> "ServingServer":
        if self._server is not None:
            return self
        srv = _ServingHTTPServer((self.bind, self.requested_port),
                                 _ServingHandler)
        srv.owner = self
        self._server = srv
        self.port = srv.server_address[1]
        # fleet waterfalls name the replica on every span, even when the
        # whole fleet shares one process (tests)
        self.scheduler.trace_component = f"serve:{self.port}"
        self._http_thread = threading.Thread(
            target=srv.serve_forever, name="dstpu-serve-http",
            kwargs={"poll_interval": 0.2}, daemon=True)
        self._http_thread.start()
        self._driver_thread = threading.Thread(
            target=self._drive, name="dstpu-serve-driver", daemon=True)
        self._driver_thread.start()
        logger.info(f"dstpu-serve on http://{self.bind}:{self.port} "
                    f"(/v1/generate /v1/prefill /metrics /healthz)")
        return self

    def drain_and_stop(self, deadline_s: Optional[float] = None) -> Dict:
        """SIGTERM path: shed new work immediately, let the driver finish
        in-flight requests bounded by the deadline, flush what remains,
        stop.  Idempotent."""
        deadline_s = self.drain_deadline_s if deadline_s is None \
            else float(deadline_s)
        self.scheduler.start_drain()   # /healthz → draining; submits → 503
        completed0 = self.scheduler.counters["serving/completed"]
        t_end = time.monotonic() + deadline_s
        # the driver thread keeps stepping while we wait; the tail drain()
        # call only mops up whatever is still live at the deadline
        while self.scheduler.pending and time.monotonic() < t_end:
            time.sleep(min(self.driver_idle_s, 0.05))
        tail = self.scheduler.drain(
            deadline_s=max(t_end - time.monotonic(), 0.0))
        summary = {"completed": int(
            self.scheduler.counters["serving/completed"] - completed0),
            "expired": tail["expired"]}
        self.drained.set()
        self.stop()
        return summary

    def stop(self) -> None:
        self.stopping.set()
        self._work.set()
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        for t in (self._http_thread, self._driver_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._http_thread = self._driver_thread = None

    def hard_kill(self) -> None:
        """SIGKILL analogue for in-process (threaded) tests: stop serving
        IMMEDIATELY — no drain, no flush, no terminal SSE events.  The
        listening socket closes, in-flight streams see EOF mid-body, and
        whatever the scheduler held is abandoned exactly as a killed
        process would abandon it."""
        self.stopping.set()            # handlers bail at their next poll
        self._work.set()
        srv, self._server = self._server, None
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:            # half-dead socket: exactly the point
                pass
        # no thread joins, no scheduler drain: the "process" is gone


# ------------------------------------------------------------------- #
# CLI (python -m deepspeed_tpu_torch.inference.v2.server)
# ------------------------------------------------------------------- #
def tiny_engine_config(args):
    """CLI budget flags → the tiny engine's config (shared by the main
    tiny engine and a tiny draft engine so their settings cannot
    diverge); float32, as the JAX server's tiny engine."""
    import torch

    from .engine_v2 import RaggedInferenceEngineConfig

    return RaggedInferenceEngineConfig(
        max_tokens=args.max_tokens, max_seqs=args.max_seqs,
        max_ctx=args.max_ctx, block_size=args.block_size,
        num_blocks=args.num_blocks, dtype=torch.float32,
        attn_impl=args.attn_impl,
        prefix_cache=getattr(args, "prefix_cache", False),
        host_tier_mb=getattr(args, "host_tier_mb", 0.0))


def _tiny_model(device, seed: int = 0):
    import torch

    from ...accelerator import get_accelerator
    from ...models.transformer import (CausalLM, TransformerConfig,
                                       init_params)

    dev = get_accelerator().resolve_device(device)
    cfg = TransformerConfig.tiny()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return CausalLM(cfg, init_params(cfg, gen, torch.float32, dev)), dev


def build_tiny_engine(args):
    """The tiny model's engine for smoke tests and local bring-up, random
    weights from seed 0, on ``args.device`` (None means CUDA; the CPU only
    when named)."""
    from .engine_v2 import InferenceEngineV2

    model, dev = _tiny_model(getattr(args, "device", None))
    return InferenceEngineV2(model, tiny_engine_config(args), device=dev)


def _needs_m10(what: str):
    return NotImplementedError(
        f"{what}: building an engine from a HuggingFace model name or "
        f"directory (engine_factory.build_hf_engine) is not ported yet "
        f"(ROADMAP M10); use --model tiny")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.inference.v2.server",
        description="Serving front end: request lifecycle, overload "
                    "shedding, KV-pressure preemption, graceful drain.")
    p.add_argument("--port", type=int, default=8791)
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--device", default=None,
                   help="the engine's device: CUDA unless given ('cpu' "
                        "runs the kernels' plain versions)")
    p.add_argument("--model", default="tiny",
                   help="'tiny' (bring-up); an HF model dir/name needs "
                        "ROADMAP M10")
    p.add_argument("--ckpt", default=None,
                   help="serve params from a framework training checkpoint "
                        "(train→serve handoff; --model supplies the arch)")
    p.add_argument("--attn-impl", default="paged",
                   choices=["paged", "gather"])
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--max-seqs", type=int, default=16)
    p.add_argument("--max-ctx", type=int, default=2048)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix KV reuse: committed prompt pages are "
                        "shared across requests (refcounts + copy-on-write;"
                        " multi-tenant traffic with a common system prompt "
                        "skips its prefill)")
    p.add_argument("--host-tier-mb", type=float, default=0.0,
                   help="host-memory page tier capacity in MB (0 = off); "
                        "KV-pressure preemption then swaps cold pages out "
                        "instead of evicting, and resume is an H2D copy")
    p.add_argument("--queue-cap", type=int, default=64,
                   help="admission queue bound; beyond it requests are "
                        "shed with 429 + Retry-After")
    p.add_argument("--window-steps", type=int, default=8,
                   help="fused decode window bound — the lifecycle "
                        "(deadline/cancel/preempt) reaction granularity")
    p.add_argument("--kv-watermark", type=float, default=0.9,
                   help="KV pool high watermark above which a starved "
                        "queue head may preempt the lowest-priority decode")
    p.add_argument("--no-preempt", action="store_true")
    p.add_argument("--hang-deadline", type=float, default=30.0,
                   help="decode-window wall-time budget before a "
                        "serving_window_hang incident is raised")
    p.add_argument("--drain-deadline", type=float, default=30.0,
                   help="SIGTERM → exit budget: in-flight requests get "
                        "this long to finish before being expired")
    p.add_argument("--eos", type=int, default=None)
    p.add_argument("--spec-mode", default="off",
                   choices=["off", "ngram", "draft_model"],
                   help="speculative decoding drafter: 'ngram' = free "
                        "host-side prompt-lookup, 'draft_model' = small "
                        "draft model (--draft-model/--draft-ckpt); "
                        "per-request override via the 'speculative' body "
                        "field")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft candidates per verify window (speedup "
                        "ceiling is k+1 tokens per model step)")
    p.add_argument("--draft-model", default=None,
                   help="draft model for --spec-mode draft_model: 'tiny' "
                        "(an HF model dir/name needs ROADMAP M10)")
    p.add_argument("--draft-ckpt", default=None,
                   help="load draft-model params from a framework training"
                        " checkpoint (params only)")
    args = p.parse_args(argv)

    if args.model != "tiny":
        raise _needs_m10(f"--model {args.model}")
    if args.ckpt:
        raise SystemExit("--ckpt needs a real --model architecture")
    engine = build_tiny_engine(args)

    spec = drafter = None
    if args.spec_mode != "off":
        from .speculative import SpeculativeConfig, make_drafter

        spec = SpeculativeConfig(mode=args.spec_mode, k=args.spec_k)
        draft_engine = None
        if args.spec_mode == "draft_model":
            if args.draft_model not in (None, "tiny"):
                raise _needs_m10(f"--draft-model {args.draft_model}")
            if args.draft_ckpt:
                # params-only handoff; the tiny model names the arch
                from .speculative import draft_engine_from_checkpoint

                arch, dev = _tiny_model(args.device)
                draft_engine = draft_engine_from_checkpoint(
                    args.draft_ckpt, arch,
                    engine_config=tiny_engine_config(args), device=dev)
            else:
                draft_engine = build_tiny_engine(args)
        drafter = make_drafter(spec, draft_engine=draft_engine)

    scheduler = LifecycleScheduler(
        engine, max_queue=args.queue_cap, window_steps=args.window_steps,
        kv_high_watermark=args.kv_watermark, preempt=not args.no_preempt,
        hang_deadline_s=args.hang_deadline, eos_token_id=args.eos,
        speculative=spec, drafter=drafter)
    server = ServingServer(scheduler, port=args.port, bind=args.bind,
                           drain_deadline_s=args.drain_deadline)
    server.start()

    done = threading.Event()
    rc = {"code": 0}

    def _drain_then_exit():
        try:
            server.drain_and_stop()
        except Exception as e:  # noqa: BLE001 — a failed drain must still exit
            logger.error(f"drain failed: {e!r}")
            rc["code"] = 1
        finally:
            done.set()          # never leave main() blocked on SIGTERM

    def _term(signum, frame):
        logger.info(f"signal {signum}: draining "
                    f"(deadline {args.drain_deadline}s)")
        threading.Thread(target=_drain_then_exit, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    print(f"dstpu-serve listening on http://{args.bind}:{server.port}",
          flush=True)
    # The kernel may deliver a process-directed SIGTERM to a non-main
    # thread; the Python-level handler only runs once the main thread
    # re-enters the eval loop, so it must never park in an untimed wait.
    while not done.wait(0.5):
        pass
    return rc["code"]


if __name__ == "__main__":
    raise SystemExit(main())
