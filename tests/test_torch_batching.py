"""The port's ContinuousBatcher against the JAX package's under KV
pressure, on the CPU, at pools of 4, 6 and 16 blocks (the cases of
``tests/unit/test_continuous_batching.py``).

Backpressure with the queue intact (a pool that holds ~4 live sequences
admits in waves, evicts at completion and recycles every block), a flush
inside an undrained decode window, and whole-lifetime rejection: each
gives the JAX engine's greedy tokens, its rejections and its pool
accounting. The scheduling-cost cases are structural (uids touched a
step), as in the reference.
"""
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu_torch.inference.v2.engine_v2 import (ContinuousBatcher,
                                                        SchedulingResult)

from .torch_serving import host, jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

ENGINE = dict(max_tokens=16)
#: 24 staggered streams, not the reference's 64: a 16-block pool still
#: holds only ~3-4 of them at a time, so admission waits for blocks in
#: waves all the same
CHURN_STREAMS = 24
GENERATE_PROMPTS = [[3, 5, 7, 11, 13], [17, 19], [23, 29, 31]]


def _churn(eng, batcher_cls):
    b = batcher_cls(eng, max_new_tokens=6)
    rng = np.random.default_rng(0)
    for u in range(CHURN_STREAMS):
        b.add_request(u, rng.integers(1, 255, size=int(rng.integers(
            3, 20))).tolist())
    steps, queued = 0, []
    while b.pending:
        b.step()
        queued.append(len(b._waiting))
        steps += 1
        assert steps < 1000, "churn did not converge"
    return {"done": {u: list(t) for u, t in b.finished.items()},
            "steps": steps, "queued": queued,
            "free": eng.state_manager.free_blocks,
            "tracked": eng.state_manager.n_tracked_sequences}


def _batcher_run(eng, batcher_cls, prompts, **kw):
    b = batcher_cls(eng, **kw)
    for u, p in enumerate(prompts):
        b.add_request(u, p)
    done = b.run()
    return {"done": {u: list(t) for u, t in done.items()},
            "rejected": list(b.rejected),
            "free": eng.state_manager.free_blocks}


def _flush_in_window(eng):
    seed = int(host(eng.put([0], [[3, 5, 7, 11]]))[0].argmax())
    window = eng.decode_batch_async([0], [seed], steps=4)
    eng.flush([0])                               # mid-flight eviction
    out = {"free_after_flush": eng.state_manager.free_blocks,
           "state_cleared": eng._decode_state is None}
    toks = np.asarray(window.tokens())           # drains without error
    out["toks"] = toks.tolist()
    out["nonfinite"] = np.asarray(window.nonfinite).tolist()
    seed = int(host(eng.put([1], [[2] * 14]))[0].argmax())
    out["toks2"] = np.asarray(eng.decode_batch([1], [seed], steps=4)).tolist()
    out["resume_hits"] = eng.decode_resume_hits
    eng.flush([1])
    out["free"] = eng.state_manager.free_blocks
    return out


def _runs(make, batcher_cls):
    # the 16-block engine serves the unpressured cases too, after its churn
    pooled = make(num_blocks=16)
    return {
        "churn": _churn(pooled, batcher_cls),
        "generate": pooled.generate(GENERATE_PROMPTS, max_new_tokens=8),
        "batcher": _batcher_run(pooled, batcher_cls, GENERATE_PROMPTS,
                                max_new_tokens=8),
        "eos": _batcher_run(pooled, batcher_cls,
                            [[3, 5], list(range(1, 200)), []],
                            max_new_tokens=8, eos_token_id=1),
        "flush": _flush_in_window(make(num_blocks=6)),
        # 30 + 9 tokens need 5 blocks of the 4; 3 + 9 need 2
        "reject": _batcher_run(make(num_blocks=4), batcher_cls,
                               [[2] * 30, [3, 5, 7]], max_new_tokens=9),
    }


@pytest.fixture(scope="module")
def jax_runs():
    w = tiny_weights()
    return _runs(lambda **kw: jax_engine_for(w, **ENGINE, **kw),
                 jax_engine.ContinuousBatcher)


@pytest.fixture(scope="module")
def port_runs():
    w = tiny_weights()
    return _runs(lambda **kw: port_engine_for(w, **ENGINE, **kw),
                 ContinuousBatcher)


def test_churn_with_tight_kv(jax_runs, port_runs):
    """Staggered requests through a pool that holds ~4 live sequences:
    admission in waves, eviction at completion, every block recycled,
    every stream complete, the JAX engine's tokens."""
    got, ref = port_runs["churn"], jax_runs["churn"]
    assert got == ref
    assert len(got["done"]) == CHURN_STREAMS
    assert all(len(v) == 6 for v in got["done"].values())
    assert max(got["queued"]) > 0          # the queue waited for blocks
    assert got["free"] == 16 and got["tracked"] == 0


def test_batcher_matches_generate(jax_runs, port_runs):
    got, ref = port_runs, jax_runs
    assert got["generate"] == ref["generate"]
    assert got["batcher"] == ref["batcher"]
    assert [got["batcher"]["done"][u] for u in range(3)] == got["generate"]


def test_eos_and_rejection(jax_runs, port_runs):
    got, ref = port_runs["eos"], jax_runs["eos"]
    assert got == ref
    assert got["done"][1] == [] and got["done"][2] == []
    assert got["rejected"] == [1]
    assert 1 <= len(got["done"][0]) <= 8
    assert got["free"] == 16


def test_flush_of_uid_inside_undrained_window(jax_runs, port_runs):
    """flush() while the uid's window is in flight: the window still
    drains, the blocks are back at once, the resume state is gone, and
    the freed blocks serve the next request."""
    got, ref = port_runs["flush"], jax_runs["flush"]
    assert got == ref
    assert got["free_after_flush"] == 6 and got["state_cleared"]
    assert np.asarray(got["toks"]).shape == (4, 1)
    assert got["nonfinite"] == [False]
    assert np.asarray(got["toks2"]).shape == (4, 1)
    assert got["resume_hits"] == 0 and got["free"] == 6


def test_whole_lifetime_reservation_exceeding_pool_rejects(jax_runs,
                                                           port_runs):
    """A request whose prompt + decode reservation exceeds the pool is
    rejected at admission; it does not hold the queue head."""
    eng = port_engine_for(tiny_weights(), **ENGINE, num_blocks=4)
    assert eng.can_schedule([0], [40]) is \
        SchedulingResult.KVCacheLimitExceeded
    got, ref = port_runs["reject"], jax_runs["reject"]
    assert got == ref
    assert got["rejected"] == [0] and got["done"][0] == []
    assert len(got["done"][1]) == 9 and got["free"] == 4


def test_next_batch_touch_count_independent_of_queue_depth():
    touched = {}
    for depth in (100, 5000):
        eng = port_engine_for(tiny_weights(), **ENGINE, num_blocks=16)
        b = ContinuousBatcher(eng, max_new_tokens=4)
        for u in range(depth):
            b.add_request(u, [3, 5, 7])
        b.step()
        touched[depth] = b.touched
    assert touched[5000] == touched[100] <= 4 + 4, touched


def test_steady_state_touch_bound():
    eng = port_engine_for(tiny_weights(), **ENGINE, num_blocks=16)
    b = ContinuousBatcher(eng, max_new_tokens=4)
    for u in range(500):
        b.add_request(u, [3, 5, 7, 11, 13])
    cap = eng.config.max_seqs * 2 + 1
    for _ in range(25):
        b.step()
        assert b.touched <= cap, (b.touched, cap)
