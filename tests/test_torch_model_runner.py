"""The port's ragged forward against the JAX package's, on the same
converted weights, page pool and packed batches (float32, CPU).

Tolerance 1e-4 (abs and rel) on logits and the new page pool: the two
frameworks run the same float32 matmuls, norms and softmaxes with
different summation orders and kernels (XLA's vs ATen's), which moves
two-layer logits of order 1 by ~1e-6; 1e-4 leaves room while any real
divergence (a wrong mask, page, position or head mapping) is >1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import model_runner as jax_runner
from deepspeed_tpu.inference.v2.ragged.ragged_wrapper import (
    RaggedBatchWrapper as JaxWrapper,
)
from deepspeed_tpu.inference.v2.ragged.sequence_descriptor import (
    DSStateManager as JaxStateManager,
)
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch.inference.v2 import model_runner as port_runner
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (
    RaggedBatchWrapper,
)
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (
    DSStateManager,
)
from deepspeed_tpu_torch.models import transformer as port_tf
from deepspeed_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
)

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-4, rtol=1e-4)
BS, MAX_CTX, NUM_BLOCKS = 8, 32, 8


@pytest.fixture(scope="module")
def models():
    cfg = jax_tf.TransformerConfig.tiny()
    tree = jax.tree.map(np.asarray,
                        jax_tf.init_params(cfg, jax.random.PRNGKey(0)))
    pcfg = port_tf.TransformerConfig.tiny()
    port = port_tf.CausalLM(pcfg, params_from_numpy(tree, pcfg))
    return cfg, tree, pcfg, port


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.num_layers * NUM_BLOCKS + 1, BS,
                            2 * cfg.num_kv_heads, cfg.head_dim)
                      ).astype(np.float32)


def _packed(batches, max_q, max_seqs):
    """Pack the same batch with both packages' wrappers; each list entry is
    (uid, seen_tokens, new tokens)."""
    packs = []
    for wrapper_cls, manager_cls in ((JaxWrapper, JaxStateManager),
                                     (RaggedBatchWrapper, DSStateManager)):
        mgr = manager_cls(num_blocks=NUM_BLOCKS, block_size=BS)
        w = wrapper_cls(max_q, max_seqs, MAX_CTX, BS, pad_page=NUM_BLOCKS)
        for uid, seen, toks in batches:
            seq = mgr.get_or_create_sequence(uid)
            seq.seen_tokens = seen
            assert mgr.maybe_allocate_kv(seq, len(toks))
            w.insert_sequence(seq, toks)
        packs.append(w.finalize().pack())
    np.testing.assert_array_equal(packs[0], packs[1])
    return packs[1], w.max_blocks


def _run_both(models, packed, max_q, max_seqs, max_blocks, attn_impl,
              decode_mode, seed):
    cfg, tree, pcfg, port = models
    pool = _pool(cfg, seed)
    kw = dict(max_q=max_q, num_blocks=NUM_BLOCKS, attn_impl=attn_impl,
              max_seqs=max_seqs, max_blocks=max_blocks,
              decode_mode=decode_mode)
    ref_logits, ref_pool = jax_runner.ragged_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(pool),
        jnp.asarray(packed), cfg, block_q=8, pages_per_chunk=2, **kw)
    port_pool = torch.from_numpy(pool.copy())
    logits = port_runner.ragged_forward(port, port_pool,
                                        torch.from_numpy(packed), pcfg, **kw)
    real = slice(0, cfg.num_layers * NUM_BLOCKS)     # all but the trash page
    return (logits.numpy(), np.asarray(ref_logits),
            port_pool.numpy()[real], np.asarray(ref_pool)[real])


@pytest.mark.parametrize("attn_impl", ["paged", "gather"])
def test_prefill_batch_matches_jax(models, attn_impl):
    """Three prompts of different lengths (crossing pages) plus a resumed
    chunk and a padded sequence row, in one ragged forward."""
    rng = np.random.default_rng(1)
    batch = [(0, 0, list(rng.integers(0, 256, 5))),
             (1, 0, list(rng.integers(0, 256, 11))),
             (2, 9, list(rng.integers(0, 256, 3)))]
    packed, nb = _packed(batch, max_q=32, max_seqs=4)
    logits, ref, pool, ref_pool = _run_both(models, packed, 32, 4, nb,
                                            attn_impl, False, seed=2)
    np.testing.assert_allclose(logits, ref, **TOL)
    np.testing.assert_allclose(pool, ref_pool, **TOL)


@pytest.mark.parametrize("attn_impl", ["paged", "gather"])
def test_decode_batch_matches_jax(models, attn_impl):
    """One token per sequence in the row-major decode layout, through the
    decode dispatch (decode_mode) the fused window uses."""
    batch = [(0, 5, [17]), (1, 16, [200]), (2, 12, [3])]
    packed, nb = _packed(batch, max_q=4, max_seqs=4)
    logits, ref, pool, ref_pool = _run_both(models, packed, 4, 4, nb,
                                            attn_impl, True, seed=3)
    np.testing.assert_allclose(logits, ref, **TOL)
    np.testing.assert_allclose(pool, ref_pool, **TOL)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        port_tf.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         1e-5).numpy(),
        np.asarray(jax_tf.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=1e-6, rtol=1e-6)
    pos = np.array([0, 1, 7, 64, 300, 2047], np.int32)
    cos, sin = port_runner._rope_at(torch.from_numpy(pos), 16, 500000.0)
    jcos, jsin = jax_runner._rope_at(jnp.asarray(pos), 16, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    np.testing.assert_allclose(
        port_runner._apply_rope_flat(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jax_runner._apply_rope_flat(jnp.asarray(x), jcos, jsin)),
        atol=1e-5, rtol=1e-5)


class TestConvert:
    def test_round_trip_is_exact(self, models):
        _, tree, pcfg, port = models
        back = params_to_numpy(params_from_numpy(tree, pcfg))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node, leaf)
        # the model holds the same tensors under the same names
        for name, arr in params_to_numpy(port)["layers"]["q_proj"].items():
            np.testing.assert_array_equal(arr, tree["layers"]["q_proj"][name])

    def test_missing_extra_and_misshaped_leaves_raise(self, models):
        _, tree, pcfg, _ = models
        missing = {k: v for k, v in tree.items() if k != "norm_f"}
        with pytest.raises(ValueError, match="missing"):
            params_from_numpy(missing, pcfg)
        extra = dict(tree, pos_embed={"embedding": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="extra"):
            params_from_numpy(extra, pcfg)
        bad = dict(tree, norm_f={"scale": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="shape"):
            params_from_numpy(bad, pcfg)


def test_fused_decode_loop_advances_on_device(models):
    """Two fused steps equal two single-token forwards with the metadata
    advanced by hand (greedy), and the advanced metadata matches a fresh
    pack of the next step."""
    _, _, pcfg, port = models
    batch = [(0, 5, [17]), (1, 16, [200])]
    mgr = DSStateManager(num_blocks=NUM_BLOCKS, block_size=BS)
    w = RaggedBatchWrapper(2, 2, MAX_CTX, BS, pad_page=NUM_BLOCKS)
    seqs = []
    for uid, seen, toks in batch:
        seq = mgr.get_or_create_sequence(uid)
        seq.seen_tokens = seen
        assert mgr.maybe_allocate_kv(seq, 2)
        w.insert_sequence(seq, toks)
        seqs.append(seq)
    packed = torch.from_numpy(w.finalize().pack())
    pool = torch.from_numpy(_pool(pcfg, 5))
    pool_ref = pool.clone()
    loop = port_runner.build_decode_loop(
        pcfg, max_q=2, max_seqs=2, max_blocks=w.max_blocks, block_size=BS,
        num_blocks=NUM_BLOCKS, attn_impl="paged", steps=2)
    toks, meta, bad = loop(port, pool, packed.clone())
    assert not bad.any()

    step = port_runner.build_ragged_step(
        pcfg, max_q=2, num_blocks=NUM_BLOCKS, attn_impl="paged", max_seqs=2,
        max_blocks=w.max_blocks, decode_mode=True)
    first = step(port, pool_ref, packed).argmax(-1)
    for seq in seqs:
        seq.post_forward()
    w.clear()
    for seq, tok in zip(seqs, first.tolist()):
        w.insert_sequence(seq, [tok])
    packed2 = torch.from_numpy(w.finalize().pack())
    second = step(port, pool_ref, packed2).argmax(-1)
    np.testing.assert_array_equal(toks.numpy(),
                                  torch.stack([first, second]).numpy())
    for seq in seqs:
        seq.post_forward()
    w.clear()
    for seq, tok in zip(seqs, second.tolist()):
        w.insert_sequence(seq, [tok])
    np.testing.assert_array_equal(meta.numpy(), w.finalize().pack())
    torch.testing.assert_close(pool, pool_ref, rtol=0, atol=0)
