"""The port's optimizer family on the CPU against the JAX package, on the
same numpy inputs:

  * each fused kernel's wrapper on CPU tensors (its plain version) against
    the Pallas kernel run as the JAX tests run it (interpret mode off the
    TPU): K5 ``fused_adam_update`` (``adam_w_mode`` on and off, weight
    decay 0 and 0.1), K13 ``fused_lamb_update``, K14 ``fused_lion_update``
    and K15 ``fused_adagrad_update``, over 3 steps;
  * ``build_optimizer`` for the seven names the port now offers against
    the JAX ``build_optimizer`` (optax, or the Pallas kernels for the
    ``Fused*`` names) over 3 updates of a small tree, with config defaults
    and with explicit params;
  * five ``train_batch`` losses of the port's engine against the JAX
    engine's with each ``Fused*`` name.

Tolerances. Per leaf: 4 float32 ulps of the array's largest magnitude,
per element (XLA on the CPU contracts ``a·b + c`` into fused
multiply-adds inside the Pallas body; the plain versions round each
operation once, as the CUDA kernels do). Optimizer trees: 2e-6 relative,
1e-7 absolute (optax's order, 3 updates, float32; the trust ratio's norms
are summed in another order). Engine: 1e-5 relative on each loss, the
bound the AdamW engine test holds.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.optimizer import build_optimizer as jax_opt
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.adam import fused_adam as port_adam
from deepspeed_tpu_torch.ops.lamb import fused_lamb as port_lamb
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer as port_opt

jax_adam = importlib.import_module("deepspeed_tpu.ops.adam.fused_adam")
jax_lamb = importlib.import_module("deepspeed_tpu.ops.lamb.fused_lamb")

pytestmark = pytest.mark.torch_port

SHAPES = [(7,), (64, 33), (3, 5, 129)]
STEPS = 3


def _assert_ulps(actual, expected, name, ulps=4):
    """|a − b| ≤ ``ulps`` float32 ulps of the array's largest magnitude,
    per element (an update ``p − lr·u`` that cancels leaves a small
    result whose own ulp is far below the operands' rounding)."""
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, name
    limit = ulps * np.spacing(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=0, atol=limit,
                               err_msg=name)


def _inputs(shape, n_state, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    state = [np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-2
             for _ in range(n_state)]
    grads = [rng.normal(size=shape).astype(np.float32) for _ in range(STEPS)]
    return p, state, grads


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# --------------------------------------------------------------------- #
# Per-leaf parity with the Pallas kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.0), (True, 0.1),
                                             (False, 0.0), (False, 0.1)])
def test_fused_adam_matches_pallas(shape, adam_w_mode, wd):
    p, (m, v), grads = _inputs(shape, 2, 1)
    pj, mj, vj = map(jnp.asarray, (p, m, v))
    pt, mt, vt = map(_t, (p, m, v))
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        pj, mj, vj = jax_adam.fused_adam_update(
            pj, jnp.asarray(g), mj, vj, jnp.int32(step), lr=lr,
            weight_decay=wd, adam_w_mode=adam_w_mode)
        port_adam.fused_adam_update(pt, _t(g), mt, vt, step, lr=lr,
                                    weight_decay=wd, adam_w_mode=adam_w_mode)
    for name, a, b in (("p", pt, pj), ("m", mt, mj), ("v", vt, vj)):
        _assert_ulps(a.numpy(), b, name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_lamb_matches_pallas(shape, wd):
    p, (m, v), grads = _inputs(shape, 2, 2)
    pj, mj, vj = map(jnp.asarray, (p, m, v))
    pt, mt, vt = map(_t, (p, m, v))
    for step, g in enumerate(grads):
        pj, mj, vj = jax_lamb.fused_lamb_update(
            pj, jnp.asarray(g), mj, vj, jnp.int32(step), lr=1e-2,
            weight_decay=wd)
        port_lamb.fused_lamb_update(pt, _t(g), mt, vt, step, lr=1e-2,
                                    weight_decay=wd)
    for name, a, b in (("p", pt, pj), ("m", mt, mj), ("v", vt, vj)):
        _assert_ulps(a.numpy(), b, name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_lion_matches_pallas(shape, wd):
    p, (m,), grads = _inputs(shape, 1, 3)
    pj, mj = map(jnp.asarray, (p, m))
    pt, mt = map(_t, (p, m))
    for g in grads:
        pj, mj = jax_adam.fused_lion_update(pj, jnp.asarray(g), mj, lr=1e-2,
                                            weight_decay=wd)
        port_adam.fused_lion_update(pt, _t(g), mt, lr=1e-2, weight_decay=wd)
    _assert_ulps(pt.numpy(), pj, "p")
    _assert_ulps(mt.numpy(), mj, "m")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_adagrad_matches_pallas(shape, wd):
    p, (a,), grads = _inputs(shape, 1, 4)
    pj, aj = map(jnp.asarray, (p, a))
    pt, at = map(_t, (p, a))
    for g in grads:
        pj, aj = jax_adam.fused_adagrad_update(pj, jnp.asarray(g), aj,
                                               lr=1e-2, weight_decay=wd)
        port_adam.fused_adagrad_update(pt, _t(g), at, lr=1e-2,
                                       weight_decay=wd)
    _assert_ulps(pt.numpy(), pj, "p")
    _assert_ulps(at.numpy(), aj, "a")


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees when
    it is handed a CUDA tensor, without a card to make one."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()


@pytest.mark.parametrize("update,n", [
    (port_adam.fused_adam_update, 4), (port_lamb.fused_lamb_update, 4),
    (port_adam.fused_lion_update, 3), (port_adam.fused_adagrad_update, 3)])
def test_wrappers_on_cuda_tensors_launch_or_raise(update, n):
    """A CUDA tensor goes to the kernel or to an error, never to the plain
    version: without a card the call raises and nothing is updated."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the kernel would launch")
    arrays = [torch.full((8,), 0.5) for _ in range(n)]
    args = [_OnCuda(t) for t in arrays] + ([0] if n == 4 else [])
    before = update.launches
    with pytest.raises((RuntimeError, AssertionError)):
        update(*args)
    assert update.launches == before
    assert all(torch.equal(t, torch.full((8,), 0.5)) for t in arrays)


def test_multi_tensor_apply_updates_every_leaf():
    rng = np.random.default_rng(6)
    params = {n: _t(rng.normal(size=s).astype(np.float32))
              for n, s in (("a", (5,)), ("b", (4, 3)))}
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p))
             for n, p in params.items()}
    want = {n: p.clone() for n, p in params.items()}
    for n in want:
        port_adam.fused_adam_update_reference(
            want[n], grads[n], torch.zeros_like(want[n]),
            torch.zeros_like(want[n]), 0, lr=0.1)
    port_adam.multi_tensor_apply(port_adam.fused_adam_update, params, grads,
                                 state, step=0, lr=0.1)
    for n in params:
        assert torch.equal(params[n], want[n])


# --------------------------------------------------------------------- #
# The factory against the JAX factory
# --------------------------------------------------------------------- #
NAMES = ["FusedAdam", "FusedLamb", "FusedLion", "FusedAdagrad", "Lamb",
         "Lion", "Adagrad"]
EXPLICIT = {"lr": 2e-2, "betas": (0.8, 0.95), "eps": 1e-6,
            "weight_decay": 0.05}


@pytest.mark.parametrize("params", [{}, EXPLICIT],
                         ids=["defaults", "explicit"])
@pytest.mark.parametrize("name", NAMES)
def test_build_optimizer_matches_jax_factory(name, params):
    """Defaults by name (FusedLamb's eps 1e-8, FusedAdagrad's 1e-10,
    Lion's b2 0.99), Adagrad's accumulator from 0.1 without weight decay
    and FusedAdagrad's from 0 with it, Lamb's unclipped trust ratio and
    FusedLamb's clipped one: all as the JAX factory builds them."""
    rng = np.random.default_rng(7)
    tree = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32) * 1e-3}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    base = params.get("lr", 1e-3)
    tx = jax_opt(name, params, learning_rate=lambda c: base * (1.0 + c))
    pj = {k: jnp.asarray(v) for k, v in tree.items()}
    state = tx.init(pj)
    opt = port_opt(name, params, learning_rate=lambda c: base * (1.0 + c))
    pt = {k: _t(v) for k, v in tree.items()}
    opt.init(pt)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step(pt, {k: _t(v) for k, v in g.items()})
    assert opt.count == 3
    for k in tree:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["OneBitAdam", "OneBitLamb",
                                  "ZeroOneAdam"])
def test_names_still_not_offered_raise_naming_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP .*M8"):
        port_opt(name, {}, learning_rate=lambda c: 1e-3)


def test_state_names_follow_the_universal_layout():
    lr = lambda c: 1e-3                                    # noqa: E731
    assert port_opt("FusedAdam", {}, lr).state_names == ("exp_avg",
                                                         "exp_avg_sq")
    assert port_opt("Lion", {}, lr).state_names == ("exp_avg",)
    assert port_opt("FusedAdagrad", {}, lr).state_names == ("sum_of_squares",)
    opt = port_opt("Lamb", {}, lr)
    opt.init({"w": torch.ones(3)})
    assert set(opt.named_state("w")) == {"exp_avg", "exp_avg_sq"}


# --------------------------------------------------------------------- #
# Engine parity
# --------------------------------------------------------------------- #
SEQ = 128


def _engine_config(name):
    return {"train_batch_size": 2,
            "optimizer": {"type": name,
                          "params": {"lr": 3e-3, "weight_decay": 0.1}},
            "gradient_clipping": 1.0}


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["FusedAdam", "FusedLamb", "FusedLion",
                                  "FusedAdagrad"])
def test_engine_five_steps_match_jax(tiny_params, name):
    params, tree = tiny_params
    tokens = np.random.default_rng(8).integers(
        0, 256, size=(2, SEQ)).astype(np.int32)
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        j_engine, _, _, _ = deepspeed_tpu.initialize(
            model=jax_tf.CausalLM(jax_tf.TransformerConfig.tiny()),
            model_parameters=params, config=_engine_config(name),
            topology=topo)
        j_losses = [float(j_engine.train_batch(
            {"input_ids": jnp.asarray(tokens)})) for _ in range(5)]
    finally:
        reset_topology()

    cfg = TransformerConfig.tiny()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg, params_from_numpy(tree, cfg)),
        config=_engine_config(name), device="cpu")
    batch = {"input_ids": torch.from_numpy(tokens).long()}
    losses = [float(engine.train_batch(batch)) for _ in range(5)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert losses[4] < losses[0]
    assert engine.optimizer.count == engine.global_steps == 5
