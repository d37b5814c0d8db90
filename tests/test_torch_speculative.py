"""The port's speculative decoding against the JAX package's, on the CPU in
float32 with the tiny model's weights.

One scenario drives either package's engine (duck-typed, as
``tests/torch_serving.py`` does): verify windows with n-gram drafts,
always-wrong drafts, mixed draft lengths with an empty one, and a draft
that needs a new block; a window under ``decode_window``/``nan``; then
``speculative_decode`` with the n-gram, the always-wrong and the
draft-model drafter (a second engine over the same weights). The JAX
engine runs it once, with the dense page-gather attention (the reference
of its paged kernels); the port runs it with ``paged`` (the plain K6 on
CPU tensors) and with ``gather``. Accepted chains, counters,
KV lengths, blocks and free counts must be EQUAL: the greedy argmax of
two float32 forwards agrees wherever the top two logits are further apart
than the frameworks' summation-order noise (~1e-6 on these logits, as
``tests/test_torch_engine.py`` measures), and the tiny model's streams
have no such near-tie.

The drafters, their validation and the port-only parts
(vanilla fused decode as the stream's reference, the draft-model drafter,
``rollback_kv``, the over-budget refusal, ``draft_engine_from_checkpoint``)
follow.
"""
import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.speculative as jax_spec
from deepspeed_tpu.runtime.fault import injection as jax_injection
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, TransformerConfig
from deepspeed_tpu_torch.inference.v2 import speculative as spec
from deepspeed_tpu_torch.inference.v2.speculative import (
    DraftModelDrafter,
    NGramDrafter,
    draft_engine_from_checkpoint,
    speculative_decode,
)
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime.fault import injection

from .torch_serving import host, jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

VOCAB = 256
#: planted repetition: the tiny model's greedy continuation of this prompt
#: is one token repeated, so n-gram drafts are accepted
REPEAT = [142] * 6
#: a prompt whose greedy stream changes token, so drafts are rejected
MIXED = [3, 5, 7, 11]
STEPS = 10
K = 4


@pytest.fixture(autouse=True)
def _clean_injectors(request):
    injection.clear()
    jax_injection.clear()

    def _clear():
        injection.clear()
        jax_injection.clear()

    request.addfinalizer(_clear)


class WrongDrafter:
    """Every candidate is the seed plus one: every draft is rejected, so
    every window rolls back."""

    def draft(self, uid, tokens, k):
        return [(int(tokens[-1]) + 1) % VOCAB] * k

    def flush(self, uid):
        pass


def _seq_state(eng, uids):
    sm = eng.state_manager
    return {"seen": [sm.get_sequence(u).seen_tokens for u in uids],
            "blocks": [sm.get_sequence(u).cur_allocated_blocks for u in uids],
            "free": sm.free_blocks}


def scenario(eng, spec_mod, inj_mod, draft_eng):
    """Verify windows, a poisoned window and speculative_decode runs on
    ``eng`` (the last drafting with ``draft_eng``, an engine over the same
    weights) → a trace of everything the two engines must agree on."""
    trace = {"free0": eng.state_manager.free_blocks, "windows": []}
    uids = [0, 1]
    logits = host(eng.put(uids, [REPEAT, MIXED]))
    hist = {0: REPEAT + [int(logits[0].argmax())],
            1: MIXED + [int(logits[1].argmax())]}
    ngram = spec_mod.NGramDrafter()

    def window(drafts):
        before = _seq_state(eng, uids)
        res = eng.verify_decode(uids, [hist[u][-1] for u in uids], drafts)
        for u, acc in zip(uids, res.accepted):
            hist[u].extend(acc)
        trace["windows"].append({
            "drafts": drafts, "accepted": res.accepted,
            "drafted": res.drafted, "accepted_draft": res.accepted_draft,
            "emitted": res.emitted, "nonfinite": res.nonfinite_uids,
            "poisoned": res.poisoned, "before": before,
            "after": _seq_state(eng, uids)})

    window([WrongDrafter().draft(u, hist[u], 3) for u in uids])
    window([ngram.draft(0, hist[0], 2), []])
    window([ngram.draft(u, hist[u], K) for u in uids])
    # uid 1's draft fills its allocation and one row more: a new block
    st = _seq_state(eng, [1])
    room = st["blocks"][0] * 8 - st["seen"][0]
    window([ngram.draft(0, hist[0], K), WrongDrafter().draft(1, hist[1],
                                                             room)])
    inj_mod.configure("site=decode_window,kind=nan,times=1")
    try:
        window([ngram.draft(u, hist[u], K) for u in uids])
    finally:
        inj_mod.clear()
    eng.flush(uids)
    trace["free_after_flush"] = eng.state_manager.free_blocks

    runs = (("ngram", spec_mod.NGramDrafter(), [2, 3]),
            ("wrong", WrongDrafter(), [4, 5]),
            ("draft", spec_mod.DraftModelDrafter(draft_eng), [6, 7]))
    for name, drafter, uids in runs:
        logits = host(eng.put(uids, [REPEAT, MIXED]))
        seeds = [int(t) for t in logits.argmax(-1)]
        out, stats = spec_mod.speculative_decode(
            eng, drafter, uids, seeds,
            [p + [s] for p, s in zip((REPEAT, MIXED), seeds)], STEPS, K)
        trace[name] = {"seeds": seeds, "streams": [out[u] for u in uids],
                       "stats": {k: stats[k] for k in (
                           "windows", "drafted", "accepted_draft",
                           "emitted", "acceptance_rate")},
                       **_seq_state(eng, uids)}
        eng.flush(uids)
        for uid in uids:
            drafter.flush(uid)
    trace["free_end"] = eng.state_manager.free_blocks
    trace["draft_free_end"] = draft_eng.state_manager.free_blocks
    return trace


@pytest.fixture(scope="module")
def jax_trace():
    return scenario(jax_engine_for(tiny_weights()), jax_spec, jax_injection,
                    jax_engine_for(tiny_weights(), max_seqs=2))


@pytest.fixture(scope="module", params=["paged", "gather"])
def port_trace(request):
    impl = request.param
    return scenario(port_engine_for(tiny_weights(), attn_impl=impl), spec,
                    injection, port_engine_for(tiny_weights(), max_seqs=2,
                                               attn_impl=impl))


@functools.lru_cache(maxsize=None)
def _vanilla(prompt, steps):
    """Greedy stream of ``prompt`` (a tuple): the first token of ``put``,
    then one fused decode window (the port's vanilla decode)."""
    eng = port_engine_for(tiny_weights())
    seed = int(host(eng.put([0], [list(prompt)]))[0].argmax())
    return [seed] + [int(t) for t in eng.decode_batch([0], [seed], steps)[:, 0]]


# --------------------------------------------------------------------- #
# Against the JAX engine
# --------------------------------------------------------------------- #
def test_verify_windows_match_jax(port_trace, jax_trace):
    got, ref = port_trace, jax_trace
    assert got["windows"] == ref["windows"]
    wrong, mixed, ngram, grow, _ = got["windows"]
    assert ngram["accepted_draft"] >= 1          # planted repetition
    # always wrong: one token a row, the KV length one past the window's
    # start, the blocks of the window's whole extent (seed + 3) kept
    assert wrong["accepted_draft"] == 0 and wrong["emitted"] == 2
    before = wrong["before"]
    assert [s + 1 for s in before["seen"]] == wrong["after"]["seen"]
    assert wrong["after"]["blocks"] == [
        max(b, -(-(s + 4) // 8)) for b, s in zip(before["blocks"],
                                                 before["seen"])]
    # an empty draft emits one token
    assert len(mixed["accepted"][1]) == 1 and mixed["drafts"][1] == []
    # the speculative block stays allocated after the rollback
    assert grow["after"]["blocks"][1] == grow["before"]["blocks"][1] + 1
    assert grow["after"]["free"] < grow["before"]["free"]


def test_nan_verify_window_flags_the_same_uid(port_trace, jax_trace):
    got, ref = port_trace["windows"][-1], jax_trace["windows"][-1]
    assert got["poisoned"] and ref["poisoned"]
    assert got["nonfinite"] == ref["nonfinite"] == [0]
    assert got["accepted"][0] == [] and got["accepted"][1]
    # the poisoned row is back at its length before the window
    assert got["after"]["seen"][0] == got["before"]["seen"][0]
    assert port_trace["free_after_flush"] == port_trace["free0"]


def test_speculative_decode_streams_match_jax_and_vanilla(port_trace,
                                                          jax_trace):
    for name in ("ngram", "wrong", "draft"):
        got, ref = port_trace[name], jax_trace[name]
        assert got == ref, name
        for prompt, seed, stream in zip((REPEAT, MIXED), got["seeds"],
                                        got["streams"]):
            assert [seed] + stream[:STEPS] == _vanilla(tuple(prompt), STEPS)
    ngram, wrong = port_trace["ngram"], port_trace["wrong"]
    assert ngram["stats"]["accepted_draft"] >= 1
    assert ngram["stats"]["windows"] < STEPS
    # always wrong: one window a token, every draft rejected, and the KV
    # length is the prompt plus the stream less its pending seed
    assert wrong["stats"]["accepted_draft"] == 0
    assert wrong["stats"]["windows"] == STEPS
    assert wrong["seen"] == [len(p) + len(s) for p, s in
                             zip((REPEAT, MIXED), wrong["streams"])]
    # a draft engine over the target's weights drafts its greedy chain
    assert port_trace["draft"]["stats"]["acceptance_rate"] == 1.0
    assert port_trace["free_end"] == port_trace["free0"]
    assert port_trace["draft_free_end"] == jax_trace["draft_free_end"]


# --------------------------------------------------------------------- #
# Drafters and configuration
# --------------------------------------------------------------------- #
def _streams(seed):
    """Token streams with planted repetition: a random head, a repeated
    segment, a short period and a constant run."""
    rng = np.random.default_rng(seed)
    seg = [int(t) for t in rng.integers(0, 12, 7)]
    head = [int(t) for t in rng.integers(0, 12, 9)]
    return head + seg + [5, 6] * 6 + seg + [9] * 8 + seg[:3]


@pytest.mark.parametrize("ngram_max,ngram_min", [(3, 1), (4, 2), (1, 1)])
def test_ngram_drafter_matches_jax_call_by_call(ngram_max, ngram_min):
    port = NGramDrafter(ngram_max, ngram_min)
    ref = jax_spec.NGramDrafter(ngram_max, ngram_min)
    calls = 0
    for seed in range(3):
        toks = _streams(seed)
        # incremental growth, one and several tokens at a time
        for i in list(range(1, 20)) + list(range(20, len(toks) + 1, 3)):
            k = 1 + i % 5
            assert port.draft(seed, toks[:i], k) == \
                ref.draft(seed, toks[:i], k), (seed, i)
            calls += 1
    # a divergent history rebuilds the index; flush forgets the uid
    for toks in ([1, 2, 3, 1, 2], [9, 8, 9, 8], _streams(7)[:30]):
        assert port.draft(0, toks, 3) == ref.draft(0, toks, 3)
    port.flush(0)
    ref.flush(0)
    assert 0 not in port._toks
    drafted = port.draft(0, [4, 4, 4, 4], 2)
    assert drafted == ref.draft(0, [4, 4, 4, 4], 2) and drafted
    assert port.draft(1, [], 3) == [] and port.draft(1, [1, 2], 0) == []
    assert calls > 50


@pytest.mark.parametrize("bounds", [(3, 0), (2, 3)])
def test_ngram_drafter_refuses_bad_bounds(bounds):
    """Both packages refuse ``ngram_min`` outside ``[1, ngram_max]``; the
    port raises ``ValueError`` where the JAX package asserts."""
    ngram_max, ngram_min = bounds
    with pytest.raises(ValueError, match="ngram_min <= ngram_max"):
        NGramDrafter(ngram_max, ngram_min)
    with pytest.raises(AssertionError):
        jax_spec.NGramDrafter(ngram_max, ngram_min)


@pytest.mark.parametrize("kw", [{"mode": "medusa"}, {"k": 0},
                                {"ngram_min": 0},
                                {"ngram_max": 2, "ngram_min": 3}])
def test_speculative_config_errors_match_jax(kw):
    """``SpeculativeConfig`` refuses what the JAX one refuses, with the
    same message."""
    with pytest.raises(ValueError) as ref:
        jax_spec.SpeculativeConfig(**kw)
    with pytest.raises(ValueError) as got:
        spec.SpeculativeConfig(**kw)
    assert str(got.value) == str(ref.value)
    assert spec.SPEC_MODES == jax_spec.SPEC_MODES


def test_make_drafter():
    """``make_drafter``: None when off, an n-gram drafter with the
    config's bounds (drafting as the JAX one does), a draft-model drafter
    over the engine handed in, and a refusal without one."""
    assert spec.make_drafter(spec.SpeculativeConfig()) is None
    cfg = dict(mode="ngram", k=3, ngram_max=4, ngram_min=2)
    got = spec.make_drafter(spec.SpeculativeConfig(**cfg))
    ref = jax_spec.make_drafter(jax_spec.SpeculativeConfig(**cfg))
    assert isinstance(got, NGramDrafter)
    assert (got.ngram_max, got.ngram_min) == (4, 2)
    stream = [1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3]
    assert got.draft(0, stream, 3) == ref.draft(0, stream, 3) == [7, 1, 2]
    with pytest.raises(ValueError, match="draft engine"):
        spec.make_drafter(spec.SpeculativeConfig(mode="draft_model"))
    eng = port_engine_for(tiny_weights(), max_seqs=1)
    d = spec.make_drafter(spec.SpeculativeConfig(mode="draft_model"),
                          draft_engine=eng)
    assert isinstance(d, DraftModelDrafter) and d.eng is eng


# --------------------------------------------------------------------- #
# The port's engine
# --------------------------------------------------------------------- #
def _spec_stream(eng, drafter, prompt, steps=STEPS, k=K):
    seed = int(host(eng.put([0], [prompt]))[0].argmax())
    out, stats = speculative_decode(eng, drafter, [0], [seed],
                                    [list(prompt) + [seed]], steps, k)
    return [seed] + out[0][:steps], stats


def test_same_model_draft_is_accepted_whole():
    eng = port_engine_for(tiny_weights())
    draft_eng = port_engine_for(tiny_weights(), max_seqs=1)
    stream, stats = _spec_stream(eng, DraftModelDrafter(draft_eng), MIXED)
    assert stream == _vanilla(tuple(MIXED), STEPS)
    assert stats["acceptance_rate"] == 1.0
    assert stats["windows"] < STEPS


def test_other_seed_draft_leaves_the_stream_unchanged():
    cfg = TransformerConfig.tiny()
    other = CausalLM(cfg, init_params(cfg, torch.Generator().manual_seed(7),
                                      torch.float32, "cpu"))
    draft_eng = deepspeed_tpu_torch.InferenceEngineV2(
        other, port_engine_for(tiny_weights()).config, device="cpu")
    drafter = DraftModelDrafter(draft_eng)
    stream, stats = _spec_stream(port_engine_for(tiny_weights()), drafter,
                                 MIXED, k=3)
    assert stream == _vanilla(tuple(MIXED), STEPS)
    assert stats["acceptance_rate"] < 1.0
    drafter.flush(0)
    assert draft_eng.state_manager.free_blocks == \
        draft_eng.state_manager.allocator.total_blocks


def test_rollback_kv_truncates_and_validates():
    eng = port_engine_for(tiny_weights())
    eng.put([0], [[3, 5, 7, 11, 13, 17, 19, 23, 29]])   # 2 blocks
    seq = eng.state_manager.get_sequence(0)
    free = eng.state_manager.free_blocks
    with pytest.raises(ValueError, match="only truncate"):
        eng.rollback_kv(0, 10)
    with pytest.raises(ValueError, match="unknown uid"):
        eng.rollback_kv(9, 0)
    eng.rollback_kv(0, 2)
    assert seq.seen_tokens == 2 and seq.cur_allocated_blocks == 2
    assert eng.state_manager.free_blocks == free


def test_verify_window_clears_the_decode_resume_state():
    eng = port_engine_for(tiny_weights())
    seed = int(host(eng.put([0], [MIXED]))[0].argmax())
    toks = eng.decode_batch([0], [seed], 2)
    assert eng._decode_state is not None
    eng.verify_decode([0], [int(toks[-1, 0])], [[1, 2]])
    assert eng._decode_state is None


@pytest.mark.parametrize("package", ["port", "jax"])
def test_over_budget_window_raises_before_allocating(package):
    eng = port_engine_for(tiny_weights()) if package == "port" \
        else jax_engine_for(tiny_weights())
    eng.put([0, 1], [MIXED, REPEAT])
    before = _seq_state(eng, [0, 1])
    budget = eng.config.max_tokens
    with pytest.raises(RuntimeError, match="max_tokens"):
        eng.verify_decode([0, 1], [1, 2], [[3] * (budget // 2)] * 2)
    assert _seq_state(eng, [0, 1]) == before


def test_draft_engine_from_checkpoint_serves_the_same_stream(tmp_path):
    cfg = TransformerConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         torch.float32, "cpu")
    trainer = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg, {k: v.clone() for k, v in params.items()}),
        config={"train_batch_size": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")[0]
    trainer.save_checkpoint(str(tmp_path))
    conf = port_engine_for(tiny_weights()).config
    served = draft_engine_from_checkpoint(str(tmp_path), CausalLM(cfg, params),
                                          engine_config=conf, device="cpu")
    direct = deepspeed_tpu_torch.InferenceEngineV2(CausalLM(cfg, params),
                                                   conf, device="cpu")
    for name, p in served.model.named_parameters():
        assert torch.equal(p, dict(direct.model.named_parameters())[name])
    prompts = [MIXED, REPEAT]
    assert served.generate(prompts, 6) == direct.generate(prompts, 6)
