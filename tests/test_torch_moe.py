"""The port's MoE module (``deepspeed_tpu_torch/moe/``) against the JAX
package's ``deepspeed_tpu/moe/``, on the CPU in float32 at ``tiny_moe``
widths (D 64, F 128, 4 experts).

Routing is discrete: the gates must make the SAME decisions, so slots,
dispatch masks, capacities and counts are held equal, and the gate
values, combine weights and load-balance losses within 1e-6 (the two
frameworks' softmaxes differ by an ulp or two). The seeded logits cover
padding (``valid``), padded experts (``num_experts_logical``), drops
(capacity factors 0.25 and 0.5) and planted ties, where ``jax.lax.top_k``
takes the lower index first. Dispatch and combine within 1e-6, the
routed blocks and layers within 1e-5 (float32 products of width 64-128
summed in a different order). Then the model side: the ``tiny_moe``
parameter tree across packages bit for bit, the router kept float32 by a
bf16 engine and by ``build_engine_from_ds_checkpoint``, and the refusals
of MoE training and expert parallelism.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jm
import deepspeed_tpu_torch
from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                 RaggedInferenceEngineConfig,
                                 TransformerConfig)
from deepspeed_tpu_torch.inference.v2.engine_factory import \
    build_engine_from_ds_checkpoint
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import init_params, lm_loss
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.moe import sharded_moe as pm

pytestmark = pytest.mark.torch_port

S, E, D, FF = 24, 4, 64, 128
GATE_TOL = dict(atol=1e-6, rtol=1e-6)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)


def _logits(seed, tie=False, n=S, e=E):
    x = np.random.default_rng(seed).normal(size=(n, e)).astype(np.float32)
    if tie:
        # planted ties: two equal maxima, an equal 2nd/3rd, all equal
        x[0, 1] = x[0, 2] = 3.0
        x[1, 0] = 2.5
        x[1, 2] = x[1, 3] = 1.5
        x[2, :] = 0.25
    return x


def _valid(seed, n=S):
    v = np.random.default_rng(seed).random(n) > 0.3
    v[-3:] = False                        # trailing pad rows
    return v


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_dense(got, ref):
    np.testing.assert_array_equal(_np(got.dispatch), _np(ref.dispatch))
    np.testing.assert_array_equal(_np(got.exp_counts), _np(ref.exp_counts))
    np.testing.assert_allclose(_np(got.combine), _np(ref.combine),
                               **GATE_TOL)
    np.testing.assert_allclose(_np(got.l_aux), _np(ref.l_aux), **GATE_TOL)


def _same_sparse(got, ref):
    assert got.capacity == ref.capacity
    np.testing.assert_array_equal(_np(got.slot), _np(ref.slot))
    np.testing.assert_array_equal(_np(got.exp_counts), _np(ref.exp_counts))
    np.testing.assert_allclose(_np(got.gate_val), _np(ref.gate_val),
                               **GATE_TOL)
    np.testing.assert_allclose(_np(got.l_aux), _np(ref.l_aux), **GATE_TOL)


GATE_CASES = [  # (capacity factor, drop_tokens, logical experts, tie)
    (2.0, True, None, False), (0.25, True, None, False),
    (0.25, False, None, False), (0.5, True, 3, False),
    (1.0, True, None, True), (0.5, True, 2, True),
]


@pytest.mark.parametrize("cf,drop,n_log,tie", GATE_CASES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_gates_match_jax(k, cf, drop, n_log, tie):
    x = _logits(k * 10 + int(cf * 4), tie)
    if k == 1:
        got = pm.top1gating(_t(x), cf, 4, None, None, drop,
                            num_experts_logical=n_log)
        ref = jm.top1gating(_j(x), cf, 4, None, None, drop,
                            num_experts_logical=n_log)
    else:
        got = pm.topkgating(_t(x), k, cf, 4, drop, num_experts_logical=n_log)
        ref = jm.topkgating(_j(x), k, cf, 4, drop, num_experts_logical=n_log)
    _same_dense(got, ref)


@pytest.mark.parametrize("cf,drop,n_log,tie", GATE_CASES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sparse_gates_match_jax(k, cf, drop, n_log, tie):
    x = _logits(k * 10 + int(cf * 4) + 1, tie)
    if k == 1:
        got = pm.top1gating_sparse(_t(x), cf, 4, None, None, drop,
                                   num_experts_logical=n_log)
        ref = jm.top1gating_sparse(_j(x), cf, 4, None, None, drop,
                                   num_experts_logical=n_log)
    else:
        got = pm.topkgating_sparse(_t(x), k, cf, 4, drop,
                                   num_experts_logical=n_log)
        ref = jm.topkgating_sparse(_j(x), k, cf, 4, drop,
                                   num_experts_logical=n_log)
    _same_sparse(got, ref)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("tie", [False, True])
def test_sparse_gate_with_valid_matches_jax(cf, tie):
    x, v = _logits(7, tie), _valid(8)
    got = pm.topkgating_sparse(_t(x), 2, cf, valid=_t(v))
    ref = jm.topkgating_sparse(_j(x), 2, cf, valid=_j(v))
    _same_sparse(got, ref)
    # padding takes no capacity: its slots are the trash row
    assert (_np(got.slot)[~v] == E * got.capacity).all()


def test_planted_tie_takes_the_lower_index_first():
    x = _logits(3, tie=True)
    gates = torch.softmax(_t(x), 1)
    _, idx = pm._top_k(gates, 3)
    assert idx[0, :2].tolist() == [1, 2]
    assert idx[1].tolist() == [0, 2, 3]
    assert idx[2].tolist() == [0, 1, 2]
    # k above the logical count: the -inf padded experts in index order
    masked, _ = pm._mask_padded_experts(_t(x), 2)
    _, idx = pm._top_k(torch.softmax(masked, 1), 4)
    assert (idx[:, 2:] == torch.tensor([2, 3])).all()
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(
            jax.nn.softmax(jm._mask_padded_experts(_j(x), 2)[0], 1), 4)[1]))


def test_past_capacity_goes_to_the_trash_row():
    """Every token picks expert 0: past capacity C the slot is E*C, never
    0*C + pos, which would be expert 1's row."""
    x = np.full((S, E), -5.0, np.float32)
    x[:, 0] = 5.0
    got = pm.top1gating_sparse(_t(x), capacity_factor=1.0)
    C = got.capacity
    slots = _np(got.slot)[:, 0]
    assert (slots[:C] == np.arange(C)).all()
    assert (slots[C:] == E * C).all()
    assert (_np(got.gate_val)[C:, 0] == 0).all()


def test_rsample_noise_comes_from_the_generator():
    x = _t(_logits(5))
    a = pm.top1gating_sparse(x, 1.0, 4, "RSample",
                             torch.Generator().manual_seed(3))
    b = pm.top1gating_sparse(x, 1.0, 4, "RSample",
                             torch.Generator().manual_seed(3))
    plain = pm.top1gating_sparse(x, 1.0, 4)
    assert torch.equal(a.slot, b.slot)
    assert not torch.equal(a.slot, plain.slot)
    # no generator: no noise, as the JAX gate without an rng
    _same_sparse(pm.top1gating_sparse(x, 1.0, 4, "RSample", None),
                 jm.top1gating_sparse(_j(x.numpy()), 1.0, 4, "RSample", None))


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_dispatch_and_combine_match_jax(cf):
    rng = np.random.default_rng(11)
    x, v = _logits(12), _valid(13)
    tok = rng.normal(size=(S, D)).astype(np.float32)
    g = jm.topkgating_sparse(_j(x), 2, cf, valid=_j(v))
    slot, val = np.asarray(g.slot), np.asarray(g.gate_val)
    got = pm.dispatch_sparse(_t(slot), _t(tok), E, g.capacity, torch.float32)
    ref = jm.dispatch_sparse(_j(slot), _j(tok), E, g.capacity, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GATE_TOL)
    eo = rng.normal(size=(E, g.capacity, D)).astype(np.float32)
    np.testing.assert_allclose(
        pm.combine_sparse(_t(slot), _t(val), _t(eo), torch.float32).numpy(),
        np.asarray(jm.combine_sparse(_j(slot), _j(val), _j(eo),
                                     jnp.float32)), **GATE_TOL)
    gd = jm.topkgating(_j(x), 2, cf)
    disp, comb = np.asarray(gd.dispatch), np.asarray(gd.combine)
    np.testing.assert_allclose(
        pm.dispatch_to_experts(_t(disp), _t(tok), torch.float32).numpy(),
        np.asarray(jm.dispatch_to_experts(_j(disp), _j(tok), jnp.float32)),
        **GATE_TOL)
    eo = rng.normal(size=(E,) + disp.shape[2:] + (D,)).astype(np.float32)
    np.testing.assert_allclose(
        pm.combine_from_experts(_t(comb), _t(eo), torch.float32).numpy(),
        np.asarray(jm.combine_from_experts(_j(comb), _j(eo), jnp.float32)),
        **GATE_TOL)


def _block_params(seed, e=E):
    rng = np.random.default_rng(seed)
    return {"router": {"kernel": rng.normal(size=(D, e)).astype(np.float32)
                       / np.sqrt(D)},
            "gate_proj": {"kernel": (rng.normal(size=(e, D, FF))
                                     / np.sqrt(D)).astype(np.float32)},
            "up_proj": {"kernel": (rng.normal(size=(e, D, FF))
                                   / np.sqrt(D)).astype(np.float32)},
            "down_proj": {"kernel": (rng.normal(size=(e, FF, D))
                                     / np.sqrt(FF)).astype(np.float32)}}


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("impl,cf,with_valid", [
    ("sparse", 2.0, False), ("sparse", 0.5, False), ("sparse", 8.0, True),
    ("sparse", 0.5, True), ("dense", 2.0, False), ("dense", 0.5, False)])
def test_moe_mlp_block_matches_jax(impl, cf, with_valid):
    lp = _block_params(21)
    tok = np.random.default_rng(22).normal(size=(S, D)).astype(np.float32)
    v = _valid(23) if with_valid else None
    got, got_aux = pm.moe_mlp_block(
        _tree(lp, _t), _t(tok), k=2, capacity_factor=cf, dispatch_impl=impl,
        valid=None if v is None else _t(v))
    ref, ref_aux = jm.moe_mlp_block(
        _tree(lp, _j), _j(tok), k=2, capacity_factor=cf, dispatch_impl=impl,
        valid=None if v is None else _j(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BLOCK_TOL)
    np.testing.assert_allclose(float(got_aux), float(ref_aux), **GATE_TOL)
    if v is not None:
        assert (got.numpy()[~v] == 0).all()


def test_moe_mlp_block_refuses_bad_arguments():
    lp = _tree(_block_params(1), _t)
    tok = torch.zeros(S, D)
    with pytest.raises(ValueError, match="dispatch_impl"):
        pm.moe_mlp_block(lp, tok, dispatch_impl="gather")
    with pytest.raises(ValueError, match="sparse"):
        pm.moe_mlp_block(lp, tok, dispatch_impl="dense",
                         valid=torch.ones(S, dtype=torch.bool))


def _layer_params(seed, e=E):
    rng = np.random.default_rng(seed)
    return {"gate": {"kernel": (rng.normal(size=(D, e)) / np.sqrt(D)
                                ).astype(np.float32)},
            "experts": {
                "w1": (rng.normal(size=(e, D, FF)) / np.sqrt(D)
                       ).astype(np.float32),
                "b1": (rng.normal(size=(e, FF)) * 0.1).astype(np.float32),
                "w2": (rng.normal(size=(e, FF, D)) / np.sqrt(FF)
                       ).astype(np.float32),
                "b2": (rng.normal(size=(e, D)) * 0.1).astype(np.float32)}}


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("k,drop,cf", [(1, True, 1.0), (1, False, 0.5),
                                       (2, True, 0.5), (2, False, 1.0)])
def test_moe_layer_matches_jax(k, drop, cf, impl):
    p = _layer_params(31)
    x = np.random.default_rng(32).normal(size=(3, 8, D)).astype(np.float32)
    got = pm.moe_layer(_tree(p, _t), _t(x), k=k, capacity_factor=cf,
                       drop_tokens=drop, dispatch_impl=impl)
    ref = jm.moe_layer(_tree(p, _j), _j(x), k=k, capacity_factor=cf,
                       drop_tokens=drop, dispatch_impl=impl)
    assert got[0].shape == x.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               **BLOCK_TOL)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), **GATE_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("k,residual,training", [(1, False, True),
                                                 (2, True, False)])
def test_moe_wrapper_matches_jax(k, residual, training):
    kw = dict(num_experts=E, k=k, capacity_factor=0.5,
              eval_capacity_factor=2.0, use_residual=residual,
              ffn_hidden_size=FF)
    got_m, ref_m = MoE(D, **kw), jax_layer.MoE(D, **kw)
    tree = params_to_numpy_tree(got_m.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray,
                     ref_m.init_params(jax.random.PRNGKey(0))))
    x = np.random.default_rng(41).normal(size=(2, 12, D)).astype(np.float32)
    got = got_m(_tree(tree, _t), _t(x), training=training)
    ref = ref_m(_tree(tree, _j), _j(x), training=training)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               **BLOCK_TOL)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), **GATE_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def params_to_numpy_tree(tree):
    return _tree(tree, lambda t: t.numpy())


@pytest.mark.parametrize("E_,ep", [(8, 1), (8, 4), (6, 4), (5, 3), (3, 4)])
def test_expert_ranges_and_padding_match_jax(E_, ep):
    assert pm.expert_shard_ranges(E_, ep) == jm.expert_shard_ranges(E_, ep)
    assert pm.placed_expert_ranges(E_, ep) == jm.placed_expert_ranges(E_, ep)
    assert pm.padded_expert_count(E_, ep) == jm.padded_expert_count(E_, ep)
    for tree in (_block_params(51, E_), _layer_params(52, E_)):
        got, n_got = pm.pad_experts_for_ep(_tree(tree, _t), ep)
        ref, n_ref = jm.pad_experts_for_ep(_tree(tree, _j), ep)
        assert n_got == n_ref == E_
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            _np(a), np.asarray(b)), got, ref)


def test_padded_experts_route_as_the_unpadded_block():
    lp = _block_params(61, 3)
    tok = _t(np.random.default_rng(62).normal(size=(S, D)).astype(np.float32))
    plain, _ = pm.moe_mlp_block(_tree(lp, _t), tok, capacity_factor=0.5)
    padded, n_log = pm.pad_experts_for_ep(_tree(lp, _t), 4)
    got, _ = pm.moe_mlp_block(padded, tok, capacity_factor=0.5,
                              num_experts_logical=n_log)
    assert torch.equal(got, plain)


def test_moe_init_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.init_moe_params(torch.Generator(), D, FF, E)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MoE(D, num_experts=E).init_params(torch.Generator())


def test_expert_parallelism_is_refused():
    with pytest.raises(NotImplementedError, match="M9"):
        pm.reshard_expert_params({"router": {"kernel": torch.zeros(D, E)}})
    with pytest.raises(NotImplementedError, match="M9"):
        MoE(D, num_experts=E, ep_size=2)
    with pytest.raises(ValueError, match="divide"):
        MoE(D, num_experts=E, ep_size=3)


# --------------------------------------------------------------------- #
# The model side
# --------------------------------------------------------------------- #
def test_configs_match_jax():
    import dataclasses

    for name in ("tiny_moe", "mixtral_8x7b"):
        got = dataclasses.asdict(getattr(TransformerConfig, name)())
        ref = dataclasses.asdict(getattr(jax_tf.TransformerConfig, name)())
        assert {k: ref[k] for k in got} == got, name


def test_jax_param_tree_round_trips_bit_for_bit():
    cfg = TransformerConfig.tiny_moe()
    tree = jax.tree.map(np.asarray, jax_tf.init_params(
        jax_tf.TransformerConfig.tiny_moe(), jax.random.PRNGKey(0)))
    model = CausalLM(cfg, params_from_numpy(tree, cfg))
    assert model.layers.router.kernel.dtype == torch.float32
    assert tuple(model.layers.gate_proj.kernel.shape) == (2, 4, 64, 128)
    back = params_to_numpy(model)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # the port's own initialiser: the same names, shapes and dtypes
    own = params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0),
                                      torch.float32, "cpu"))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), tree)


def test_bf16_jax_tree_keeps_its_float32_router():
    cfg = TransformerConfig.tiny_moe()
    tree = jax.tree.map(np.asarray, jax_tf.init_params(
        jax_tf.TransformerConfig.tiny_moe(), jax.random.PRNGKey(1),
        jnp.bfloat16))
    state = params_from_numpy(tree, cfg)
    assert state["layers.router.kernel"].dtype == torch.float32
    assert state["layers.up_proj.kernel"].dtype == torch.bfloat16


def _tiny_model(dtype=torch.float32):
    cfg = TransformerConfig.tiny_moe()
    return CausalLM(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                     dtype, "cpu"))


def test_bf16_engine_and_checkpoint_keep_the_router_float32(tmp_path):
    model = _tiny_model()
    router = model.layers.router.kernel.detach().clone()
    geom = dict(max_tokens=16, max_seqs=4, max_ctx=64, block_size=8)
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        dtype=torch.bfloat16, **geom), device="cpu")
    assert model.layers.router.kernel.dtype == torch.float32
    assert torch.equal(model.layers.router.kernel, router)
    assert model.layers.gate_proj.kernel.dtype == torch.bfloat16
    n_router = router.numel()
    assert eng._param_bytes == 2 * (model.num_params() - n_router) \
        + 4 * n_router
    ref = jax_tf.CausalLM(jax_tf.TransformerConfig.tiny_moe())
    from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine

    jeng = jax_engine.InferenceEngineV2(
        ref, jax.tree.map(jnp.asarray, params_to_numpy(_tiny_model())),
        jax_engine.RaggedInferenceEngineConfig(dtype=jnp.bfloat16, **geom))
    assert eng._param_bytes == jeng._param_bytes
    eng.serialize(str(tmp_path))
    served = build_engine_from_ds_checkpoint(
        str(tmp_path), _tiny_model(), tag="model", dtype=torch.bfloat16,
        device="cpu")
    assert served.model.layers.router.kernel.dtype == torch.float32
    assert torch.equal(served.model.layers.router.kernel, router)
    assert served.model.layers.down_proj.kernel.dtype == torch.bfloat16
    logits = served.put([0], [[3, 5, 7]])
    assert bool(torch.isfinite(logits).all())


def test_moe_training_is_refused():
    model = _tiny_model()
    tokens = torch.tensor([[3, 5, 7, 11]])
    with pytest.raises(NotImplementedError, match="MoE training.*M9"):
        lm_loss(dict(model.named_parameters()), tokens, model.config)
    with pytest.raises(NotImplementedError, match="MoE training.*M9"):
        deepspeed_tpu_torch.initialize(
            model=model, config={"train_batch_size": 1}, device="cpu")
