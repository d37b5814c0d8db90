"""MoE serving in the port against the JAX engine, on the CPU in float32 at
``tiny_moe`` widths (2 layers, 4 experts, top-2), the geometry
``tests/unit/test_moe_sparse.py::TestMoEServing`` serves with
(``max_tokens=16, max_seqs=4, max_ctx=64, block_size=8``).

The weights come from the port's seeded initialiser and cross to the JAX
package by name. Two capacity factors: 8.0 drops nothing; 0.5 drops on
the mixed prefill + decode batch (12 real tokens in a 16-token bucket: C
= max(ceil(16·2/4·0.5), 4) = 4 slots an expert, 16 for 24 assignments),
which a recording of the port's gate confirms. The JAX engines run the
dense page-gather attention (the reference of its paged kernels), the
port's ``paged`` (the plain K6 and K7 on CPU tensors); one JAX engine per
capacity factor serves the module, and every test flushes its uids.

``put`` logits and a verify window's logits within 2e-5 (float32 logits
of order 1; the frameworks' summation orders differ by ~1e-6), greedy
``generate`` tokens and verify chains equal, the decode roofline's bytes
equal on the same windows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.inference.v2 import model_runner as jax_runner
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                 RaggedInferenceEngineConfig,
                                 TransformerConfig)
from deepspeed_tpu_torch.inference.v2 import model_runner as port_runner
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.moe import sharded_moe

from .torch_serving import host

pytestmark = pytest.mark.torch_port

GEOMETRY = dict(max_tokens=16, max_seqs=4, max_ctx=64, block_size=8)
TOL = dict(atol=2e-5, rtol=2e-5)
P0 = [3, 5, 7, 11, 13]
P1 = [int(t) for t in np.random.default_rng(2).integers(1, 256, 11)]
NEW = 8


@functools.lru_cache(maxsize=1)
def weights():
    cfg = TransformerConfig.tiny_moe()
    return params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0),
                                       torch.float32, "cpu"))


def _port_engine(cf):
    cfg = TransformerConfig.tiny_moe(moe_capacity_factor=cf)
    return InferenceEngineV2(
        CausalLM(cfg, params_from_numpy(weights(), cfg)),
        RaggedInferenceEngineConfig(dtype=torch.float32, **GEOMETRY),
        device="cpu")


@pytest.fixture(scope="module", params=[8.0, 0.5], ids=["cf8", "cf0.5"])
def engines(request):
    cf = request.param
    jeng = jax_engine.InferenceEngineV2(
        jax_tf.CausalLM(jax_tf.TransformerConfig.tiny_moe(
            moe_capacity_factor=cf)),
        jax.tree.map(jnp.asarray, weights()),
        jax_engine.RaggedInferenceEngineConfig(
            dtype=jnp.float32, attn_impl="gather", **GEOMETRY))
    return cf, jeng


@pytest.fixture
def drops(monkeypatch):
    """The port's sparse gate, recorded: the assignments of real tokens
    that went to the trash row, a list per call."""
    seen = []
    gate = sharded_moe.topkgating_sparse

    def recording(logits, *a, valid=None, **kw):
        out = gate(logits, *a, valid=valid, **kw)
        trash = out.slot == logits.shape[1] * out.capacity
        seen.append(int((trash & valid[:, None]).sum()))
        return out

    monkeypatch.setattr(sharded_moe, "topkgating_sparse", recording)
    return seen


def _puts(eng):
    """A prompt, then a mixed batch (sequence 0's decode token and
    sequence 1's 11-token prompt, 4 pad rows), then a decode step of
    both → their logits rows."""
    rows = [host(eng.put([0], [P0]))[0]]
    mixed = host(eng.put([0, 1], [[17], P1]))
    rows += list(mixed)
    rows += list(host(eng.put([0, 1], [[19], [23]])))
    eng.flush([0, 1])
    return np.stack(rows)


def test_put_logits_match_jax(engines, drops):
    cf, jeng = engines
    got = _puts(_port_engine(cf))
    np.testing.assert_allclose(got, _puts(jeng), **TOL)
    # cf 0.5 drops real tokens on the mixed batch, cf 8.0 never
    assert (sum(drops) > 0) == (cf == 0.5)


def test_generate_tokens_match_jax(engines):
    cf, jeng = engines
    prompts = [P0, P1, [2, 4, 6]]
    eng = _port_engine(cf)
    got = eng.generate(prompts, max_new_tokens=NEW)
    ref = jeng.generate(prompts, max_new_tokens=NEW)
    assert got == [list(map(int, r)) for r in ref]
    # the decode roofline of the last window: the same bytes
    g, r = eng.last_decode_roofline, jeng.last_decode_roofline
    assert (g["n_seqs"], g["steps"]) == (r["n_seqs"], r["steps"])
    assert g["bytes_total"] == r["bytes_total"]
    for name, k in r["kernels"].items():
        assert g["kernels"][name]["bytes"] == k["bytes"], name
    assert eng._param_bytes == jeng._param_bytes


def _verify_logits(eng, uids, chunks):
    """One ``verify_mode`` forward over each uid's chunk, in the engine's
    own batch (either package) → every position's logits."""
    sm = eng.state_manager
    n = sum(len(c) for c in chunks)
    bucket = eng.bucket_for(n, len(uids))
    wrapper = eng._wrapper_for(bucket)
    wrapper.clear()
    for uid, c in zip(uids, chunks):
        seq = sm.get_or_create_sequence(uid)
        assert sm.maybe_allocate_kv(seq, len(c))
        wrapper.insert_sequence(seq, list(c))
    batch = wrapper.finalize()
    kw = dict(max_q=bucket[0], num_blocks=eng._num_blocks,
              attn_impl=eng.config.attn_impl, max_seqs=bucket[1],
              max_blocks=wrapper.max_blocks, verify_mode=True)
    if isinstance(eng, InferenceEngineV2):
        with torch.inference_mode():
            logits = port_runner.build_ragged_step(eng.cfg, **kw)(
                eng.model, eng.kv.pages, eng._upload(batch.pack()))
    else:
        logits, pages = jax_runner.build_ragged_step(eng.cfg, **kw)(
            eng.params, eng.kv.pages, jnp.asarray(batch.pack()))
        eng.kv.update(pages)
    for uid in batch.uids:
        sm.get_sequence(uid).post_forward()
    return host(logits)[:n]


def _verify(eng):
    """Prefill two prompts, score a verify window of seed + 3 drafts a
    sequence, roll it back, then ``verify_decode`` the same window."""
    seeds = [int(np.argmax(host(eng.put([0], [P0]))[0])),
             int(np.argmax(host(eng.put([1], [P1]))[0]))]
    drafts = [[seeds[0], 9, 10], [seeds[1], 33, 12]]
    logits = _verify_logits(eng, [0, 1], [[seeds[0]] + drafts[0],
                                          [seeds[1]] + drafts[1]])
    eng.rollback_kv(0, len(P0))
    eng.rollback_kv(1, len(P1))
    res = eng.verify_decode([0, 1], seeds, drafts)
    eng.flush([0, 1])
    return logits, [list(map(int, a)) for a in res.accepted]


def test_verify_window_matches_jax(engines):
    cf, jeng = engines
    got, got_acc = _verify(_port_engine(cf))
    ref, ref_acc = _verify(jeng)
    np.testing.assert_allclose(got, ref, **TOL)
    assert got_acc == ref_acc
