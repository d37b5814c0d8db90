"""The port's InferenceEngineV2 against the JAX package's, end to end on
the CPU in float32, with the same converted weights.

A small token budget (max_tokens=16) forces SplitFuse: the longer prompts
are prefilled in chunks fused with other sequences' decode tokens, then the
batcher switches to fused decode windows. Greedy tokens must be IDENTICAL;
``put`` logits agree to 1e-4 (abs and rel), the float32 summation-order
slack of two frameworks' matmuls and softmaxes over two layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch import (
    CausalLM,
    InferenceEngineV2,
    RaggedInferenceEngineConfig,
    TransformerConfig,
)
from deepspeed_tpu_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.torch_port

ENGINE = dict(max_tokens=16, max_seqs=4, max_ctx=64, block_size=8)
PROMPT_LENS = (3, 21, 9, 30)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in PROMPT_LENS]


def _port_engine(tree, attn_impl="paged"):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(tree, cfg))
    return InferenceEngineV2(model, RaggedInferenceEngineConfig(
        dtype=torch.float32, attn_impl=attn_impl, **ENGINE), device="cpu")


def _jax_engine(weights):
    cfg, params, _ = weights
    return jax_engine.InferenceEngineV2(
        jax_tf.CausalLM(cfg), params, jax_engine.RaggedInferenceEngineConfig(
            dtype=jnp.float32, block_q=8, pages_per_chunk=2, **ENGINE))


def test_generate_greedy_tokens_identical_to_jax(weights):
    prompts = _prompts()
    ref = _jax_engine(weights).generate(prompts, max_new_tokens=8)
    eng = _port_engine(weights[2])
    out = eng.generate(prompts, max_new_tokens=8)
    assert out == ref
    stats = eng.last_generate_stats
    # the run took both branches of the batcher: SplitFuse forwards and
    # fused decode windows
    assert stats["put_calls"] > len(PROMPT_LENS)
    assert stats["window_calls"] >= 1


def test_put_logits_match_jax(weights):
    """Two fresh prompts in one forward, one of them longer than a page,
    through put() on both engines."""
    prompts = [_prompts(1)[i] for i in (0, 2)]
    ref_eng = _jax_engine(weights)
    ref = np.asarray(ref_eng.put([7, 9], prompts))
    eng = _port_engine(weights[2])
    logits = eng.put([7, 9], prompts)
    assert logits.shape == (2, 256) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)
    # a second forward reads the cache the first one wrote
    nxt = [[int(t)] for t in ref.argmax(-1)]
    np.testing.assert_allclose(eng.put([7, 9], nxt).numpy(),
                               np.asarray(ref_eng.put([7, 9], nxt)),
                               atol=1e-4, rtol=1e-4)


def test_paged_and_gather_generate_agree(weights):
    prompts = _prompts(2)
    assert _port_engine(weights[2], "paged").generate(prompts, 6) == \
        _port_engine(weights[2], "gather").generate(prompts, 6)


def _prefill(eng, uid, prompt):
    """put() a prompt in token-budget chunks → greedy next token."""
    budget = ENGINE["max_tokens"]
    for i in range(0, len(prompt), budget):
        logits = eng.put([uid], [prompt[i:i + budget]])
    return int(logits.argmax())


def test_fused_decode_equals_stepwise_put(weights):
    """decode_batch (one fused window, sampling on the device) gives the
    same greedy tokens as put + argmax one step at a time."""
    prompts = _prompts(3)[:3]
    uids = [0, 1, 2]
    fused, stepwise = _port_engine(weights[2]), _port_engine(weights[2])
    seeds = [_prefill(fused, u, p) for u, p in zip(uids, prompts)]
    assert seeds == [_prefill(stepwise, u, p) for u, p in zip(uids, prompts)]
    toks = fused.decode_batch(uids, seeds, steps=5)
    cur = seeds
    for i in range(5):
        cur = stepwise.put(uids, [[t] for t in cur]).argmax(-1).tolist()
        assert toks[i].tolist() == cur


def test_decode_windows_resume_on_device(weights):
    """A second window over the same uids reuses the advanced metadata
    (no repack), and its tokens continue the first window's stream. The
    contexts (3 and 9 tokens + 4) grow no new page, so the block tables
    stay as they were."""
    prompts = [_prompts(4)[i] for i in (0, 2)]
    eng, ref = _port_engine(weights[2]), _port_engine(weights[2])
    seeds = [_prefill(eng, u, p) for u, p in enumerate(prompts)]
    assert seeds == [_prefill(ref, u, p) for u, p in enumerate(prompts)]
    w1 = eng.decode_batch_async([0, 1], seeds, steps=2)
    w2 = eng.decode_batch_async([0, 1], [0, 0], steps=2)   # seeds advisory
    assert eng.decode_resume_hits == 1
    both = np.concatenate([w1.tokens(), w2.tokens()])
    np.testing.assert_array_equal(both, ref.decode_batch([0, 1], seeds, 4))


def test_sampling_is_reproducible_from_a_generator(weights):
    prompts = _prompts(5)[:2]
    outs = [_port_engine(weights[2]).generate(
        prompts, max_new_tokens=6, temperature=0.8,
        generator=torch.Generator().manual_seed(11)) for _ in range(2)]
    assert outs[0] == outs[1]
    assert all(0 <= t < 256 for seq in outs[0] for t in seq)


def test_decode_window_flags_only_the_poisoned_sequence(weights):
    """NaN in one sequence's cached pages makes its logits non-finite and
    flags it, while its batchmates decode exactly as without the poison."""
    prompts = [_prompts(6)[i] for i in (0, 2)]
    eng, ref = _port_engine(weights[2]), _port_engine(weights[2])
    seeds = [_prefill(eng, u, p) for u, p in enumerate(prompts)]
    assert seeds == [_prefill(ref, u, p) for u, p in enumerate(prompts)]
    nb = eng.kv.config.num_blocks
    blocks = eng.state_manager.get_sequence(1).blocks
    for layer in range(eng.cfg.num_layers):
        eng.kv.pages[[b + layer * nb for b in blocks]] = float("nan")
    window = eng.decode_batch_async([0, 1], seeds, steps=3)
    toks = window.tokens()
    assert window.nonfinite.tolist() == [False, True]
    np.testing.assert_array_equal(toks[:, 0],
                                  ref.decode_batch([0, 1], seeds, 3)[:, 0])
