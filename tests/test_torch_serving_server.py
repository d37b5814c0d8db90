"""The port's HTTP serving front end (``inference/v2/server.py``) on the
CPU: a ``ServingServer`` on 127.0.0.1, port 0, over a float32 engine with
the tiny model's weights (``models/convert.py`` carries them), at the
geometry of ``tests/unit/test_serving_server.py``.

Blocking and SSE answers must equal the JAX ``LifecycleScheduler``'s
tokens for the same prompts; errors map to 400, 504, 429 (with
``Retry-After``) and 503; ``/healthz`` answers with the JAX server's keys;
``/metrics`` renders the counters; ``/v1/prefill`` on both wires feeds
``kv_import`` to the stream the prompt gives directly; a client that drops
its SSE stream cancels the request (the scheduler is held back until the
cancellation arrives, so the request cannot finish first); the
command-line server answers and drains on SIGTERM; drain runs last.
"""
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from deepspeed_tpu.inference.v2 import lifecycle as jax_lifecycle
from deepspeed_tpu.inference.v2 import server as jax_server
from deepspeed_tpu_torch.inference.v2 import server
from deepspeed_tpu_torch.inference.v2.lifecycle import (LifecycleScheduler,
                                                        RequestState)

from .torch_serving import jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(max_tokens=16, max_seqs=4, max_ctx=96, block_size=8)
PROMPTS = [[3, 5, 7, 11], [4, 5, 7, 11], [6, 1, 2], [9, 9, 8, 7, 6]]
NEW = 6
LONG = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 2, 4, 6, 8, 10, 12, 14]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX scheduler's tokens for PROMPTS (NEW each, one batch) and
    LONG (12), and the JAX server's /healthz body."""
    eng = jax_engine_for(tiny_weights(), **GEOMETRY)
    sched = jax_lifecycle.LifecycleScheduler(eng, window_steps=4)
    for u, p in enumerate(PROMPTS + [LONG]):
        sched.submit(jax_lifecycle.ServeRequest(
            uid=u, prompt=p, max_new_tokens=NEW if u < len(PROMPTS) else 12))
    sched.run_until_idle()
    tokens = [[int(t) for t in sched.request(u).produced]
              for u in range(len(PROMPTS) + 1)]
    srv = jax_server.ServingServer(sched, port=0, bind="127.0.0.1").start()
    try:
        health = json.loads(_get(srv, "/healthz")[1])
    finally:
        srv.stop()
    return {"tokens": tokens[:-1], "long": tokens[-1], "healthz": health}


@pytest.fixture(scope="module")
def serving():
    eng = port_engine_for(tiny_weights(), **GEOMETRY)
    sched = LifecycleScheduler(eng, window_steps=4, max_queue=16,
                               degraded_window_s=0.5)
    srv = server.ServingServer(sched, port=0, bind="127.0.0.1").start()
    yield srv, sched, eng
    srv.stop()


def _request(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _post(srv, body, path="/v1/generate"):
    return _request(srv.port, path, body)


def _get(srv, path, headers=None, timeout=10):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _wait(cond, timeout=30.0):
    """Poll ``cond`` until it holds or ``timeout`` passes. → its last
    value."""
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# --------------------------------------------------------------------- #
# /v1/generate
# --------------------------------------------------------------------- #
def test_blocking_answers_equal_jax_scheduler(serving, jax_side):
    """Four clients post at once; each answer equals the JAX scheduler's
    stream for its prompt."""
    srv, _, _ = serving
    answers = [None] * len(PROMPTS)

    def client(i):
        answers[i] = _post(srv, {"prompt": PROMPTS[i],
                                 "max_new_tokens": NEW})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for (code, _, out), ref in zip(answers, jax_side["tokens"]):
        assert code == 200
        assert out["state"] == "finished" and out["finish_reason"] == "length"
        assert out["tokens"] == ref
        assert out["ttft_s"] is not None and out["tpot_s"] is not None


def test_streaming_sse_yields_tokens_then_terminal(serving, jax_side):
    srv, _, _ = serving
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/generate",
        data=json.dumps({"prompt": PROMPTS[1], "max_new_tokens": NEW,
                         "stream": True}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        body = r.read().decode()
    events = [json.loads(line[len("data: "):])
              for line in body.splitlines() if line.startswith("data: ")]
    assert len(events) >= 2                      # chunks + terminal
    streamed = [t for e in events for t in e["tokens"]]
    assert streamed == jax_side["tokens"][1]
    assert len(streamed) == events[-1]["n_total"]
    assert events[-1]["finish_reason"] == "length"
    assert events[-1]["state"] == "finished"


@pytest.mark.parametrize("body", [
    {"max_new_tokens": 4},                                  # no prompt
    {"prompt": [1, 2], "speculative": {"mode": "medusa"}},  # unknown mode
    {"prompt": [1, 2], "speculative": {"k": 0}},            # k < 1
    {"prompt": [1, 2], "speculative": "ngram"},             # not an object
    {"prompt": [1, 2], "kv_import": "not base64 at all!"},
    {"prompt": [1, 2], "kv_import": "Tk9QRQ=="},            # not DSKV1
])
def test_bad_body_is_400(serving, body):
    code, _, out = _post(serving[0], body)
    assert code == 400 and "bad request body" in out["error"]


def test_speculative_without_drafter_is_400(serving):
    code, _, out = _post(serving[0], {"prompt": [1, 2],
                                      "speculative": {"mode": "ngram"}})
    assert code == 400 and out["reason"] == "no_drafter"


def test_deadline_expiry_maps_to_504(serving):
    code, _, out = _post(serving[0], {"prompt": [3, 5], "max_new_tokens": 64,
                                      "deadline_s": 0.0})
    assert code == 504
    assert out["state"] == "expired" and out["finish_reason"] == "deadline"


# --------------------------------------------------------------------- #
# Health, shedding, metrics
# --------------------------------------------------------------------- #
def test_healthz_keys_equal_the_jax_server(serving, jax_side):
    srv, _, _ = serving
    code, body, _ = _get(srv, "/healthz")
    assert code == 200
    health = json.loads(body)
    assert health["status"] == health["state"] == "healthy"
    # (the JAX body adds "goodput" and "memory" when its ledgers are
    # installed in the process, which the port's M11 has not ported)
    assert sorted(health) == sorted(k for k in jax_side["healthz"]
                                    if k not in ("goodput", "memory"))
    code, body, headers = _get(srv, "/healthz",
                               headers={"Accept": "text/plain"})
    assert code == 200 and body == "healthy\n"
    assert headers["Content-Type"] == "text/plain"


def test_queue_full_is_429_with_retry_after(serving):
    srv, sched, _ = serving
    old_cap = sched.max_queue
    sched.max_queue = 0                  # every submission sheds
    try:
        for path in ("/v1/generate", "/v1/prefill"):
            code, headers, out = _post(srv, {"prompt": [3, 5],
                                             "max_new_tokens": 4}, path)
            assert code == 429 and out["reason"] == "queue_full"
            assert int(headers["Retry-After"]) >= 1
        code, body, _ = _get(srv, "/healthz")
        assert code == 503 and json.loads(body)["status"] == "saturated"
    finally:
        sched.max_queue = old_cap
    time.sleep(0.6)                      # saturation decays (window 0.5 s)
    assert _get(srv, "/healthz")[0] == 200


def test_metrics_and_uninstalled_endpoints(serving):
    srv, _, _ = serving
    code, text, _ = _get(srv, "/metrics")
    assert code == 200
    assert "# TYPE serving_requests counter" in text
    assert "serving_shed" in text and "serving_completed" in text
    for path in ("/traces", "/goodput", "/memory"):
        code, body, _ = _get(srv, path)
        assert code == 404 and "installed" in json.loads(body)["error"]


# --------------------------------------------------------------------- #
# /v1/prefill → kv_import
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_prefill_then_kv_import_continues_the_stream(serving, jax_side, wire):
    srv, sched, eng = serving
    imported0 = sched.counters["serving/kv_import_tokens"]
    code, _, pre = _post(srv, {"prompt": LONG[:-1], "wire": wire},
                         "/v1/prefill")
    assert code == 200 and pre["wire"] == wire
    assert pre["n_tokens"] == len(LONG) - 1
    code, _, out = _post(srv, {"prompt": LONG, "max_new_tokens": 12,
                               "kv_import": pre["kv"]})
    assert code == 200 and out["state"] == "finished"
    assert out["tokens"] == jax_side["long"]
    assert sched.counters["serving/kv_import_tokens"] - imported0 == \
        len(LONG) - 1
    assert _wait(lambda: eng.state_manager.free_blocks ==
                 eng.state_manager.allocator.total_blocks)


def test_prefill_bad_wire_is_400(serving):
    code, _, _ = _post(serving[0], {"prompt": [1, 2], "wire": "fp64"},
                       "/v1/prefill")
    assert code == 400


# --------------------------------------------------------------------- #
# Client disconnect
# --------------------------------------------------------------------- #
def test_client_disconnect_cancels_and_reclaims(serving):
    """The scheduler is held back (outside its lock) once the stream has
    its first tokens, until the cancellation is requested: the request
    cannot finish before the server sees the FIN."""
    srv, sched, eng = serving
    total = eng.state_manager.allocator.total_blocks
    step = sched.step
    held = {"uid": None, "waits": 0}

    def gated_step():
        uid = held["uid"]
        if uid is not None and sched.request(uid) is not None \
                and sched.request(uid).produced:
            held["waits"] += 1
            _wait(lambda: uid in sched._cancel_requested, timeout=30)
        return step()

    requests0 = sched.counters["serving/requests"]
    sched.step = gated_step
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [5, 6, 7], "max_new_tokens": 80, "stream": True}),
            headers={"Content-Type": "application/json"})
        assert _wait(lambda: sched.counters["serving/requests"] > requests0)
        held["uid"] = uid = max(sched._reqs)
        resp = conn.getresponse()
        resp.read(32)                    # the first event arrived
        resp.close()                     # both holders of the socket must
        conn.close()                     # close for the FIN to go out
        assert _wait(lambda: sched.request(uid).state ==
                     RequestState.CANCELLED)
    finally:
        del sched.step
    assert len(sched.request(uid).produced) < 80 and held["waits"] >= 1
    assert _wait(lambda: eng.state_manager.free_blocks == total)
    assert sched.counters["serving/cancelled"] >= 1


# --------------------------------------------------------------------- #
# The command line
# --------------------------------------------------------------------- #
def test_cli_rejects_hf_models_until_m10():
    with pytest.raises(NotImplementedError, match="M10"):
        server.main(["--model", "meta-llama/Llama-3-8B", "--device", "cpu"])


def test_cli_serves_and_drains_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.v2.server",
         "--model", "tiny", "--device", "cpu", "--port", "0",
         "--bind", "127.0.0.1"],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    try:
        port = None
        for line in proc.stdout:
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None, "the server printed no listening line"
        code, _, out = _request(port, "/v1/generate",
                                {"prompt": [3, 5, 7], "max_new_tokens": 4})
        assert code == 200 and len(out["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# --------------------------------------------------------------------- #
# Drain (last: draining is terminal for the fixture)
# --------------------------------------------------------------------- #
def test_drain_completes_inflight_then_sheds_new(serving):
    srv, sched, eng = serving
    results = queue.Queue()
    completed0 = sched.counters["serving/completed"]
    requests0 = sched.counters["serving/requests"]
    t = threading.Thread(target=lambda: results.put(_post(
        srv, {"prompt": [6, 7, 8], "max_new_tokens": 80})), daemon=True)
    t.start()
    assert _wait(lambda: sched.counters["serving/requests"] > requests0)
    sched.start_drain()
    code, headers, out = _post(srv, {"prompt": [1, 2], "max_new_tokens": 4})
    assert code == 503 and out["reason"] == "draining"
    assert int(headers["Retry-After"]) >= 1
    # the in-flight request may finish before drain_and_stop takes its
    # own count: the summary counts what finished from there on
    completed1 = sched.counters["serving/completed"]
    summary = srv.drain_and_stop(deadline_s=60)
    code, _, out = results.get(timeout=30)
    assert code == 200 and out["state"] == "finished"
    assert len(out["tokens"]) == 80
    assert summary == {"completed": sched.counters["serving/completed"]
                       - completed1, "expired": 0}
    assert sched.counters["serving/completed"] - completed0 == 1
    assert eng.state_manager.free_blocks == \
        eng.state_manager.allocator.total_blocks
