"""The port's LifecycleScheduler against the JAX package's, on the CPU in
float32 with the tiny model's weights (``models/convert.py`` carries them).

Each scenario of ``tests/unit/test_serving_lifecycle.py`` (admission and
shedding, deadlines and cancellation, KV-pressure preemption, the decode
watchdog, drain) runs once through the JAX scheduler and once through the
port's, at the reference's geometry, with a ``FakeClock`` where the
reference uses one. Then the paths the reference file leaves out: a
swap-in resume from the host tier, a prefix-cache hit counted once,
verify windows with the n-gram drafter and per-request overrides, the
``kv_import`` continuation on both wires and the ``prefill_only`` export.

Produced tokens, terminal states, finish reasons and ``counters`` must be
EQUAL. The JAX engines take the dense page-gather attention (the plain
reference of their paged kernels; one engine per geometry serves the
module, since its compiled programs are the slow part); the port's take
``paged`` (the plain K6/K7 on CPU tensors) unless a scenario names
``gather``.
"""
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import kv_ship as jax_ship
from deepspeed_tpu.inference.v2 import lifecycle as jax_lifecycle
from deepspeed_tpu.inference.v2 import speculative as jax_spec
from deepspeed_tpu.runtime.fault import injection as jax_injection
from deepspeed_tpu_torch.inference.v2 import kv_ship, lifecycle, speculative
from deepspeed_tpu_torch.runtime.fault import injection

from .torch_serving import jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

#: the reference file's engine (``_engine``): max_ctx 64, page 8
GEOMETRY = dict(max_tokens=16, max_seqs=4, max_ctx=64, block_size=8)
_JAX_ENGINES = {}


def _jax_engine(**kw):
    """The module's JAX engine for a geometry, handed out empty (the JAX
    engine compiles per instance, and attention is always gather)."""
    kw.pop("attn_impl", None)
    key = tuple(sorted(kw.items()))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = jax_engine_for(tiny_weights(), **GEOMETRY, **kw)
    eng = _JAX_ENGINES[key]
    assert not eng.state_manager._seqs, "a scenario left sequences behind"
    return eng


def _port_engine(**kw):
    return port_engine_for(tiny_weights(), **GEOMETRY, **kw)


JAX = types.SimpleNamespace(name="jax", mk=_jax_engine, lc=jax_lifecycle,
                            inj=jax_injection, ship=jax_ship, spec=jax_spec)
PORT = types.SimpleNamespace(name="port", mk=_port_engine, lc=lifecycle,
                             inj=injection, ship=kv_ship, spec=speculative)


@pytest.fixture(autouse=True)
def _clean_injectors():
    injection.clear()
    jax_injection.clear()
    yield
    injection.clear()
    jax_injection.clear()


class FakeClock:
    """Deterministic clock: deadlines fire exactly when the test says."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(scenario, **kw):
    """Run ``scenario`` through the JAX package and the port; their
    records must be equal. → the port's record."""
    rec = {p.name: scenario(p, **kw) for p in (JAX, PORT)}
    assert rec["port"] == rec["jax"]
    return rec["port"]


def reqs(s, uids):
    """Per uid: produced tokens, state, finish reason, preemptions (None
    for a request the scheduler does not hold)."""
    out = {}
    for u in uids:
        r = s.request(u)
        out[u] = None if r is None else (
            [int(t) for t in r.produced], r.state.value, r.finish_reason,
            r.preempt_count)
    return out


def record(s, uids, **extra):
    return {"reqs": reqs(s, uids), "counters": dict(s.counters), **extra}


def free(eng):
    return eng.state_manager.free_blocks


def total(eng):
    return eng.state_manager.allocator.total_blocks


# --------------------------------------------------------------------- #
# Admission and shedding
# --------------------------------------------------------------------- #
def test_matches_generate():
    prompts = [[3, 5, 7, 11], [4, 5, 7, 11], [5, 5, 7, 11]]

    def sc(p):
        eng = p.mk()
        s = p.lc.LifecycleScheduler(eng, window_steps=4)
        adm = [s.submit(p.lc.ServeRequest(uid=u, prompt=pr,
                                          max_new_tokens=6)).admitted
               for u, pr in enumerate(prompts)]
        s.run_until_idle()
        ref = eng.generate(prompts, max_new_tokens=6)
        return record(s, range(3), admitted=adm,
                      generate=[[int(t) for t in r] for r in ref])

    rec = both(sc)
    assert [rec["reqs"][u][0] for u in range(3)] == rec["generate"]
    assert all(rec["reqs"][u][1] == "finished" for u in range(3))
    assert rec["counters"]["serving/completed"] == 3


def test_queue_cap_sheds_with_retry_after():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk(), max_queue=2)
        adm = [s.submit(p.lc.ServeRequest(uid=u, prompt=[3, 5],
                                          max_new_tokens=8)).admitted
               for u in range(2)]
        v = s.submit(p.lc.ServeRequest(uid=9, prompt=[3, 5],
                                       max_new_tokens=8))
        s.run_until_idle()
        return record(s, [0, 1, 9], admitted=adm,
                      verdict=(v.admitted, v.reason, v.retry_after_s))

    rec = both(sc)
    admitted, reason, retry = rec["verdict"]
    assert not admitted and reason == "queue_full"
    assert 1.0 <= retry <= 120.0
    assert rec["counters"]["serving/shed"] == 1
    assert rec["reqs"][9] is None                # the queue stays bounded
    assert rec["reqs"][0][1] == rec["reqs"][1][1] == "finished"


def test_draining_sheds_immediately():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk())
        s.start_drain()
        v = s.submit(p.lc.ServeRequest(uid=0, prompt=[3], max_new_tokens=4))
        return record(s, [0], verdict=(v.admitted, v.reason),
                      health=s.health_state()[0])

    rec = both(sc)
    assert rec["verdict"] == (False, "draining")
    assert rec["health"] == "draining"


def test_impossible_request_rejected_not_wedged():
    def sc(p):
        eng = p.mk(num_blocks=4)                  # the pool holds 32 tokens
        s = p.lc.LifecycleScheduler(eng, window_steps=4)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[2] * 30,
                                   max_new_tokens=16))   # needs 6 blocks
        s.submit(p.lc.ServeRequest(uid=1, prompt=[3, 5], max_new_tokens=4))
        s.run_until_idle()
        return record(s, [0, 1], free=free(eng))

    rec = both(sc)
    assert rec["reqs"][0][1:3] == ("failed", "impossible")
    assert rec["counters"]["serving/rejected"] == 1
    assert rec["reqs"][1][1] == "finished"
    assert rec["free"] == 4


# --------------------------------------------------------------------- #
# Deadlines and cancellation
# --------------------------------------------------------------------- #
def test_deadline_expires_mid_decode_and_reclaims_blocks():
    def sc(p):
        eng = p.mk(num_blocks=8)
        clock = FakeClock()
        s = p.lc.LifecycleScheduler(eng, window_steps=2, clock=clock)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7, 11],
                                   max_new_tokens=32, deadline_s=5.0))
        s.step()                                  # prefill → decoding
        s.step()                                  # one 2-token window
        at_expiry = (len(s.request(0).produced), s.request(0).state.value)
        free_before = free(eng)
        clock.advance(10.0)                       # past the deadline
        s.step()                                  # the expiry pass fires
        expired = reqs(s, [0])
        free_after = free(eng)
        s.submit(p.lc.ServeRequest(uid=1, prompt=[2] * 30,
                                   max_new_tokens=16))   # the whole pool
        s.run_until_idle()
        return record(s, [0, 1], at_expiry=at_expiry, expired=expired,
                      free=(free_before, free_after, free(eng)))

    rec = both(sc)
    produced, state = rec["at_expiry"]
    assert state == "decode"
    assert rec["expired"][0][1:3] == ("expired", "deadline")
    assert len(rec["expired"][0][0]) == produced < 32    # flushed mid-stream
    assert rec["counters"]["serving/deadline_expired"] == 1
    assert rec["free"][1] == 8 > rec["free"][0]
    assert rec["reqs"][1][1] == "finished"


def test_ttft_timeout_expires_queued_request():
    def sc(p):
        clock = FakeClock()
        s = p.lc.LifecycleScheduler(p.mk(), clock=clock)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5], max_new_tokens=4,
                                   ttft_timeout_s=2.0))
        clock.advance(5.0)
        s.step()
        return record(s, [0])

    rec = both(sc)
    assert rec["reqs"][0][1:3] == ("expired", "ttft_timeout")
    assert rec["counters"]["serving/ttft_timeout"] == 1


def test_cancel_frees_blocks_for_readmission():
    def sc(p):
        eng = p.mk(num_blocks=6)
        # preemption off: this isolates cancel → reclaim → re-admit
        s = p.lc.LifecycleScheduler(eng, window_steps=2, preempt=False)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[2] * 40,
                                   max_new_tokens=8))    # the whole pool
        while s.request(0).state != p.lc.RequestState.DECODE:
            s.step()
        full = free(eng)
        s.submit(p.lc.ServeRequest(uid=1, prompt=[3] * 40, max_new_tokens=8))
        s.step()
        blocked = s.request(1).state.value
        cancelled = s.cancel(0)
        s.step()                                  # the cancellation pass
        after = reqs(s, [0])
        s.run_until_idle()                        # uid 1 reuses the blocks
        return record(s, [0, 1], full=full, blocked=blocked,
                      cancelled=cancelled, after=after, free=free(eng))

    rec = both(sc)
    assert rec["full"] == 0 and rec["blocked"] == "queued"
    assert rec["cancelled"] and rec["after"][0][1] == "cancelled"
    assert rec["counters"]["serving/cancelled"] == 1
    assert rec["reqs"][1][1] == "finished" and len(rec["reqs"][1][0]) == 8
    assert rec["free"] == 6


def test_cancel_unknown_or_terminal_is_noop():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk())
        unknown = s.cancel(123)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3], max_new_tokens=2))
        s.run_until_idle()
        return record(s, [0], cancels=(unknown, s.cancel(0)))

    assert both(sc)["cancels"] == (False, False)


# --------------------------------------------------------------------- #
# KV-pressure preemption
# --------------------------------------------------------------------- #
def _preempt_scenario(p, impl="paged", **kw):
    """uid 0 decodes; a 40-token arrival above the watermark preempts it;
    both finish. → record with the uninterrupted stream as ``ref``."""
    eng = p.mk(num_blocks=10, attn_impl=impl, **kw)
    s = p.lc.LifecycleScheduler(eng, window_steps=4)
    s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7, 11, 13],
                               max_new_tokens=16))
    s.run_until_idle()
    ref = [int(t) for t in s.request(0).produced]
    s = p.lc.LifecycleScheduler(eng, window_steps=4, kv_high_watermark=0.2)
    s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7, 11, 13],
                               max_new_tokens=16))
    s.step()
    s.step()                        # uid 0 decoding, holds 3 of 10 blocks
    before = len(s.request(0).produced)
    # needs 8 blocks > 7 free → the head is blocked above the watermark
    s.submit(p.lc.ServeRequest(uid=1, prompt=[2] * 40, max_new_tokens=24))
    s.run_until_idle()
    return record(s, [0, 1], ref=ref, before=before, free=free(eng))


def _check_preempted(rec):
    assert rec["before"] > 1
    assert rec["counters"]["serving/preempted"] == 1
    assert rec["reqs"][0][3] == 1                     # preempt_count
    assert rec["reqs"][0][1] == rec["reqs"][1][1] == "finished"
    assert rec["reqs"][0][0] == rec["ref"]            # bit-exact resume
    assert rec["free"] == 10                          # pool reclaimed


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_preempt_and_resume_bit_exact(impl):
    rec = both(_preempt_scenario, impl=impl)
    _check_preempted(rec)
    assert "serving/swap_out" not in rec["counters"]


def test_swap_in_resume_from_host_tier():
    """With a host tier the victim's rows are parked host-side at
    preemption and copied back at resume (no recompute): same stream."""
    rec = both(_preempt_scenario, host_tier_mb=1.0)
    _check_preempted(rec)
    c = rec["counters"]
    assert c["serving/swap_out"] == c["serving/swap_in"] == 1
    # whole pages come back; the tail of the last one is recomputed
    assert 0 < c["serving/swap_in_tokens"] <= c["serving/swap_out_tokens"]


def test_no_pingpong_livelock():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk(num_blocks=10), window_steps=4,
                                    kv_high_watermark=0.2)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3] * 30,
                                   max_new_tokens=16))
        s.step()
        s.step()
        s.submit(p.lc.ServeRequest(uid=1, prompt=[2] * 40,
                                   max_new_tokens=24))
        s.run_until_idle()          # raises on livelock / no progress
        return record(s, [0, 1])

    rec = both(sc)
    assert rec["reqs"][0][1] == rec["reqs"][1][1] == "finished"
    assert rec["counters"]["serving/preempted"] <= 2


def test_higher_priority_never_preempted_by_lower():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk(num_blocks=10), window_steps=4,
                                    kv_high_watermark=0.2)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3] * 20,
                                   max_new_tokens=16, priority=5))
        s.step()
        s.step()
        s.submit(p.lc.ServeRequest(uid=1, prompt=[2] * 40,
                                   max_new_tokens=24, priority=0))
        s.run_until_idle()
        return record(s, [0, 1])

    rec = both(sc)
    assert rec["counters"].get("serving/preempted", 0) == 0
    assert rec["reqs"][0][3] == 0
    assert rec["reqs"][0][1] == rec["reqs"][1][1] == "finished"


# --------------------------------------------------------------------- #
# The decode watchdog
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_nan_window_flushes_only_poisoned_request(impl):
    def sc(p):
        out = {}
        for fault in (None, "site=decode_window,kind=nan,times=1"):
            p.inj.clear()
            eng = p.mk(attn_impl=impl)
            s = p.lc.LifecycleScheduler(eng, window_steps=4)
            for uid in range(3):
                s.submit(p.lc.ServeRequest(uid=uid, prompt=[3 + uid, 5, 7, 11],
                                           max_new_tokens=8))
            if fault:
                p.inj.configure(fault)
            s.run_until_idle()
            p.inj.clear()
            out[fault is not None] = record(
                s, range(3), incident=s.last_incident_kind,
                health=s.health_state()[0], free=free(eng) == total(eng))
        return out

    rec = both(sc)
    clean, bad = rec[False], rec[True]
    failed = [u for u in range(3) if bad["reqs"][u][1] == "failed"]
    assert len(failed) == 1 and bad["reqs"][failed[0]][2] == "nan"
    assert bad["counters"]["serving/nan_isolated"] == 1
    assert bad["incident"] == "nan" and bad["health"] == "degraded"
    for u in set(range(3)) - set(failed):
        assert bad["reqs"][u][1] == "finished"
        assert bad["reqs"][u][0] == clean["reqs"][u][0]
    assert bad["free"]


def test_slow_window_raises_hang_incident():
    # the reference's deadline is 0.2 s against a 0.4 s stall; an eager
    # window of the tiny model can pass 0.2 s on a CPU shared by parallel
    # test workers, so the deadline sits far above it and the stall above
    # the deadline
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk(), window_steps=4,
                                    hang_deadline_s=1.5)
        # 13 = 1 (prefill) + 4 + 4 + 2 + 1 + 1
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7],
                                   max_new_tokens=13))
        s.step()                                  # prefill
        s.step()                                  # the first window
        hangs0 = s.counters["serving/window_hang"]
        p.inj.configure("site=decode_window,kind=slow,delay=2.0,times=1")
        s.run_until_idle()
        return record(s, [0], hangs0=hangs0, incident=s.last_incident_kind,
                      health=s.health_state()[0])

    rec = both(sc)
    assert rec["hangs0"] == 0
    assert rec["counters"]["serving/window_hang"] == 1
    assert rec["incident"] == "window_hang" and rec["health"] == "degraded"


def test_kv_alloc_exhausted_is_transient_backpressure():
    def sc(p):
        eng = p.mk()
        s = p.lc.LifecycleScheduler(eng, window_steps=4)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7, 11],
                                   max_new_tokens=6))
        p.inj.configure("site=kv_alloc,kind=exhausted,times=1")
        s.step()
        blocked = s.request(0).state.value
        s.run_until_idle()
        ref = eng.generate([[3, 5, 7, 11]], max_new_tokens=6)[0]
        return record(s, [0], blocked=blocked, ref=[int(t) for t in ref])

    rec = both(sc)
    assert rec["blocked"] == "queued"
    assert rec["reqs"][0][1] == "finished" and rec["reqs"][0][0] == rec["ref"]


# --------------------------------------------------------------------- #
# Drain
# --------------------------------------------------------------------- #
def test_drain_completes_inflight_and_expires_stragglers():
    def sc(p):
        s = p.lc.LifecycleScheduler(p.mk(), window_steps=4)
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7], max_new_tokens=4))
        s.step()                                  # in flight
        return record(s, [0], summary=s.drain(deadline_s=60.0),
                      pending=s.pending)

    rec = both(sc)
    assert rec["summary"] == {"completed": 1, "expired": 0}
    assert rec["reqs"][0][1] == "finished" and rec["pending"] == 0


def test_drain_deadline_expires_remaining():
    def sc(p):
        eng = p.mk()
        s = p.lc.LifecycleScheduler(eng, window_steps=2, clock=FakeClock())
        s.submit(p.lc.ServeRequest(uid=0, prompt=[3, 5, 7],
                                   max_new_tokens=32))
        s.step()
        summary = s.drain(deadline_s=0.0)         # already past it
        return record(s, [0], summary=summary,
                      free=free(eng) == total(eng))

    rec = both(sc)
    assert rec["summary"]["expired"] == 1
    assert rec["reqs"][0][1:3] == ("expired", "drain_deadline")
    assert rec["counters"]["serving/drain_expired"] == 1
    assert rec["free"]


# --------------------------------------------------------------------- #
# Beyond the reference file: prefix reuse, verify windows, kv_import,
# prefill_only
# --------------------------------------------------------------------- #
SHARED = [7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31, 33, 35, 37,
          39, 41, 43, 45]                         # 2.5 pages of 8


def test_prefix_hit_counted_once():
    """A request grafting a committed prefix counts one hit, with its
    grafted tokens, even when its admission is refused for several passes
    first (each retry re-grafts; only the successful reservation counts)."""
    def sc(p):
        eng = p.mk(num_blocks=10, prefix_cache=True)
        s = p.lc.LifecycleScheduler(eng, window_steps=4, preempt=False)
        s.submit(p.lc.ServeRequest(uid=0, prompt=SHARED, max_new_tokens=4))
        s.run_until_idle()                        # commits SHARED's pages
        s.submit(p.lc.ServeRequest(uid=1, prompt=[2] * 40,
                                   max_new_tokens=8))
        s.step()                                  # uid 1 holds 6 blocks
        s.submit(p.lc.ServeRequest(uid=2, prompt=SHARED + [3, 4, 5],
                                   max_new_tokens=24))
        states = []
        while s.request(2).state == p.lc.RequestState.QUEUED:
            s.step()
            states.append(s.request(1).state.value)
        s.run_until_idle()
        cache = eng.prefix_cache
        out = record(s, [0, 1, 2], waited=len(states),
                     hit_tokens=s.request(2).prefix_hit_tokens,
                     cache=(cache.hits, cache.misses))
        cache.clear()
        return out

    rec = both(sc)
    assert rec["waited"] > 1                      # refused, then admitted
    assert rec["counters"]["serving/prefix_hits"] == 1
    assert rec["counters"]["serving/prefix_hit_tokens"] == \
        rec["hit_tokens"] >= 16
    assert rec["cache"][0] == 1
    assert all(rec["reqs"][u][1] == "finished" for u in range(3))


def test_verify_windows_with_ngram_drafter_and_overrides():
    """Verify windows (n-gram drafts, k 3) with one request on the default,
    one at ``spec_k`` 1 and one with ``spec_mode`` off: the greedy streams
    equal ``generate``'s, drafts are accepted."""
    prompts = [[142] * 6, [5, 6, 7, 5, 6, 7, 5, 6, 7], [9, 8, 9, 8, 9, 8]]
    overrides = [{}, {"spec_k": 1}, {"spec_mode": "off"}]

    def sc(p):
        eng = p.mk()
        s = p.lc.LifecycleScheduler(
            eng, window_steps=4,
            speculative=p.spec.SpeculativeConfig(mode="ngram", k=3))
        for u, (pr, o) in enumerate(zip(prompts, overrides)):
            s.submit(p.lc.ServeRequest(uid=u, prompt=pr, max_new_tokens=12,
                                       **o))
        s.run_until_idle()
        ref = eng.generate(prompts, max_new_tokens=12)
        return record(s, range(3), ref=[[int(t) for t in r] for r in ref])

    rec = both(sc)
    assert [rec["reqs"][u][0] for u in range(3)] == rec["ref"]
    c = rec["counters"]
    assert c["serving/spec_windows"] > 0
    assert 0 < c["serving/spec_accepted"] <= c["serving/spec_drafted"]


PROMPT = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 2, 4, 6, 8, 10, 12, 14, 16,
          18, 20]


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_kv_import_continuation(wire):
    """A ``prefill_only`` request exports the prompt less its last token;
    its frame continues on a second scheduler through ``kv_import`` (the
    port's takes the frame's bytes, as its server passes them, and
    decodes them at admission), equal to the locally prefilled stream."""
    def sc(p):
        prod = p.lc.LifecycleScheduler(p.mk(num_blocks=12))
        prod.submit(p.lc.ServeRequest(uid=0, prompt=PROMPT[:-1],
                                      max_new_tokens=0, prefill_only=True))
        prod.run_until_idle()
        frame = p.ship.to_wire(prod.request(0).kv_shipment, wire)
        ship = frame if p is PORT else p.ship.from_wire(frame)
        eng = p.mk()
        s = p.lc.LifecycleScheduler(eng, window_steps=4)
        s.submit(p.lc.ServeRequest(uid=3, prompt=PROMPT, max_new_tokens=6,
                                   kv_import=ship))
        s.submit(p.lc.ServeRequest(uid=4, prompt=PROMPT, max_new_tokens=6))
        s.run_until_idle()
        return record(s, [3, 4], free=free(eng) == total(eng))

    rec = both(sc)
    assert rec["reqs"][3][1] == "finished"
    assert rec["reqs"][3][0] == rec["reqs"][4][0]
    assert rec["counters"]["serving/kv_import"] == 1
    assert rec["counters"]["serving/kv_import_tokens"] == len(PROMPT) - 1
    assert rec["free"]


def test_damaged_kv_import_frame_is_rejected():
    """A frame whose header reads but whose payload is cut short fails
    the request at admission instead of wedging the queue head."""
    frame = PORT.ship.to_wire(PORT.ship.KVShipment(
        tokens=[1, 2], num_layers=2, num_kv_heads=2, head_dim=16,
        src_block_size=8, wire="fp32",
        rows=torch.zeros(2, 2, 4, 16)), "fp32")
    eng = _port_engine()
    s = lifecycle.LifecycleScheduler(eng)
    s.submit(lifecycle.ServeRequest(uid=0, prompt=[1, 2, 3],
                                    max_new_tokens=2, kv_import=frame[:-8]))
    s.submit(lifecycle.ServeRequest(uid=1, prompt=[1, 2, 3],
                                    max_new_tokens=2))
    s.run_until_idle()
    assert reqs(s, [0])[0][1:3] == ("failed", "impossible")
    assert s.request(1).state == lifecycle.RequestState.FINISHED
    assert free(eng) == total(eng)


def test_prefill_only_export():
    """``prefill_only`` finishes at prefill without a token, exports the
    prompt's rows (equal to the JAX engine's within float32 noise) and
    returns its blocks."""
    def sc(p):
        eng = p.mk()
        s = p.lc.LifecycleScheduler(eng)
        s.submit(p.lc.ServeRequest(uid=0, prompt=PROMPT, max_new_tokens=0,
                                   prefill_only=True))
        s.run_until_idle()
        ship = s.request(0).kv_shipment
        rows = ship.rows
        rows = rows.numpy() if hasattr(rows, "numpy") else np.asarray(rows)
        return record(s, [0], tokens=list(ship.tokens),
                      free=free(eng) == total(eng)), rows

    (jax_rec, jax_rows), (port_rec, port_rows) = (sc(JAX), sc(PORT))
    assert port_rec == jax_rec
    assert port_rec["reqs"][0] == ([], "finished", "prefill_done", 0)
    assert port_rec["counters"]["serving/prefill_exported"] == 1
    assert port_rec["tokens"] == PROMPT and port_rec["free"]
    assert port_rows.shape == jax_rows.shape == (2, len(PROMPT), 4, 16)
    np.testing.assert_allclose(port_rows, jax_rows, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# The engine pieces the scheduler reads: the decode roofline, the
# window's ``compiled`` flag
# --------------------------------------------------------------------- #
def test_decode_roofline_matches_jax():
    """``decode_window_bytes`` and ``decode_roofline_report`` give the JAX
    functions' numbers for the same window and peaks; the H100 row and
    the CPU fallback."""
    from deepspeed_tpu.profiling import roofline as jax_roof
    from deepspeed_tpu.profiling import serving_roofline as jax_sr
    from deepspeed_tpu_torch.profiling import roofline, serving_roofline

    kw = dict(num_layers=32, num_kv_heads=8, head_dim=128, kv_dtype_bytes=2,
              param_bytes=16_060_000_000, n_seqs=8, steps=8, mean_ctx=612.5)
    got = serving_roofline.decode_window_bytes(**kw)
    assert got == jax_sr.decode_window_bytes(**kw)
    h100 = roofline.spec_for_kind("NVIDIA H100 80GB HBM3")
    assert (h100.peak_flops, h100.hbm_bandwidth) == (989e12, 3.35e12)
    ref_spec = jax_roof.DeviceSpec(h100.kind, h100.peak_flops,
                                   h100.hbm_bandwidth)
    report = serving_roofline.decode_roofline_report(got, 0.375, 8, 8,
                                                     spec=h100)
    assert report == jax_sr.decode_roofline_report(got, 0.375, 8, 8,
                                                   spec=ref_spec)
    assert "170.7 tok/s" in serving_roofline.format_decode_roofline(report)
    cpu = roofline.device_spec("cpu")
    ref_cpu = jax_roof.CPU_FALLBACK
    assert (cpu.peak_flops, cpu.hbm_bandwidth) == \
        (ref_cpu.peak_flops, ref_cpu.hbm_bandwidth)
    assert roofline.spec_for_kind("TPU v5 lite").hbm_bandwidth == \
        ref_cpu.hbm_bandwidth                 # no TPU rows in the port


def test_decode_window_roofline_and_compiled_flag():
    """A drained window records its roofline on the engine (``mean_ctx``
    the context at the start plus half the steps, the bytes the tiny
    model's); the first window of a decode-loop key in the process is
    flagged ``compiled`` and kept off the scheduler's drain rate, a
    repeat is not."""
    eng = _port_engine()
    s = lifecycle.LifecycleScheduler(eng, fallback_tok_per_s=32.0)
    eng.put([0], [[3, 5, 7, 11]])
    key_top_k = 97                           # a key no other test uses
    first = eng.decode_batch_async([0], [2], 3, top_k=key_top_k)
    assert first.duration_s is None and first.mean_ctx == 4 + 1.5
    first.tokens()
    assert first.compiled and first.duration_s > 0
    r = eng.last_decode_roofline
    assert r["compile_polluted"] and s.predicted_tok_per_s() == 32.0
    again = eng.decode_batch_async([0], [int(first.tokens()[-1, 0])], 3,
                                   top_k=key_top_k)
    again.tokens()
    r = eng.last_decode_roofline
    assert not again.compiled and not r["compile_polluted"]
    assert r["decode_tok_per_s"] == pytest.approx(3 / again.duration_s)
    assert s.predicted_tok_per_s() == r["decode_tok_per_s"]
    assert r["n_seqs"] == 1 and r["steps"] == 3
    assert r["kernels"]["param_stream"]["bytes"] == 3 * eng._param_bytes
    assert r["device_kind"] == "cpu"
