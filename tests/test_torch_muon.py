"""The port's Muon (``runtime/optimizer.py``) against ``optax.contrib.muon``
as the JAX factory builds it (``muon(lr)``, optax 0.2.6's defaults):

  * five updates of a tree with 1-D, tall 2-D, wide 2-D and 3-D leaves,
    fed the same gradients (the label rule: 2-D leaves to Newton–Schulz,
    the rest to Nesterov Adam);
  * five ``train_batch`` losses of ``TransformerConfig.tiny`` with
    ``"Muon"`` against the JAX engine's, and the masters after them;
  * a Muon tag crossing both ways: the JAX engine's checkpoint after 2
    steps, exported by the JAX ``convert`` (Muon's ``mu`` and the Adam
    branch's ``mu``/``nu`` under ``exp_avg``/``exp_avg_sq``), resumes in
    the port for 3 more steps; the JAX ``load_universal`` reads a port
    Muon tag bit for bit.

Tolerances: the Newton–Schulz iteration's five quintic steps in float32
amplify the roundings of XLA's and PyTorch's matmuls (different sum
orders), so five updates agree within 2e-6 absolute on parameters of
magnitude ~1 with an lr of 1e-2 (the updates' own size is ~1e-2). Losses
within 1e-5 relative, as the other engine tests; masters within a
twentieth of one step (0.05 · lr): the Adam branch divides by √v + 1e-8,
and an element whose gradients are ~0 has v near eps², where float32
noise in the gradient moves that element's step by a few percent (1 of
4,096 elements of ``k_proj`` did, by 9.0e-5 at lr 3e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import ds_to_universal as jax_universal
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, TransformerConfig
from deepspeed_tpu_torch.checkpoint.universal.layout import universal_name
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.optimizer import (
    Muon,
    build_optimizer,
    orthogonalize_via_newton_schulz,
)

pytestmark = pytest.mark.torch_port

SEQ = 128
CONFIG = {"train_batch_size": 2,
          "optimizer": {"type": "Muon", "params": {"lr": 3e-3}},
          "gradient_clipping": 1.0}
TREE_SHAPES = {"bias": (7,), "tall": (12, 5), "wide": (4, 9),
               "stack": (3, 6, 5)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's many small ops on one thread: with the suite's
    workers sharing the machine's cores, PyTorch's thread pool makes them
    ~30x slower, and the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(2, SEQ)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.mark.parametrize("lr", [1e-2, 3e-3])
def test_muon_matches_optax_over_five_updates(lr):
    rng = np.random.default_rng(11)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in TREE_SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in TREE_SHAPES.items()} for _ in range(5)]
    tx = optax.contrib.muon(lr)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    update = jax.jit(tx.update)
    opt = build_optimizer("Muon", {}, learning_rate=lambda c: lr)
    assert isinstance(opt, Muon)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt.init(pt)
    assert opt.leaf_state_names("tall") == ("exp_avg",)
    assert opt.leaf_state_names("stack") == ("exp_avg", "exp_avg_sq")
    assert not opt.elementwise("wide") and opt.elementwise("bias")
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()},
                            state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step(pt, {k: torch.from_numpy(v) for k, v in g.items()})
    for k in TREE_SHAPES:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0,
                                   atol=2e-6, err_msg=k)
    # the momenta: Muon's mu and the Adam branch's mu, nu
    muon_mu = state.inner_states["muon"].inner_state[0].mu
    adam = state.inner_states["adam"].inner_state[0]
    np.testing.assert_allclose(opt.named_state("tall")["exp_avg"].numpy(),
                               np.asarray(muon_mu["tall"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(opt.named_state("stack")["exp_avg_sq"].numpy(),
                               np.asarray(adam.nu["stack"]), rtol=1e-6,
                               atol=1e-9)


def test_newton_schulz_matches_optax():
    from optax.contrib._muon import orthogonalize_via_newton_schulz as ns

    rng = np.random.default_rng(3)
    for shape in ((16, 5), (5, 16), (8, 8)):
        x = rng.normal(size=shape).astype(np.float32)
        want = ns(jnp.asarray(x), jnp.asarray((3.4445, -4.7750, 2.0315)))
        got = orthogonalize_via_newton_schulz(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6, err_msg=str(shape))


@pytest.fixture(scope="module")
def jax_muon_run(tmp_path_factory):
    """The JAX engine with ``"Muon"``: 2 steps, ``save_checkpoint`` and
    ``convert``, then 3 more steps."""
    root = tmp_path_factory.mktemp("jax_muon")
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        engine, _, _, _ = deepspeed_tpu.initialize(
            model=jax_tf.CausalLM(cfg), model_parameters=params,
            config=CONFIG, topology=topo)
        losses = [float(engine.train_batch(
            {"input_ids": jnp.asarray(_tokens(s))})) for s in (1, 2)]
        engine.save_checkpoint(str(root / "ck"))
        jax_universal.convert(str(root / "ck"), str(root / "u"))
        losses += [float(engine.train_batch(
            {"input_ids": jnp.asarray(_tokens(s))})) for s in (3, 4, 5)]
        masters = _flat(jax.tree.map(np.asarray, engine.state.params))
    finally:
        reset_topology()
    return {"tree": tree, "losses": losses, "masters": masters,
            "universal": str(root / "u")}


def _port_engine(tree, config=CONFIG):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(tree, cfg), trainable=True)
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          device="cpu")[0]


def _train(engine, seeds):
    return [float(engine.train_batch(
        {"input_ids": torch.from_numpy(_tokens(s)).long()})) for s in seeds]


def test_five_muon_losses_match_the_jax_engine(jax_muon_run):
    ref = jax_muon_run
    engine = _port_engine(ref["tree"])
    assert isinstance(engine.optimizer, Muon)
    losses = _train(engine, [1, 2, 3, 4, 5])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    lr = CONFIG["optimizer"]["params"]["lr"]
    for name, p in engine.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref["masters"][name],
                                   rtol=0, atol=0.05 * lr, err_msg=name)


def test_jax_muon_tag_resumes_in_the_port(jax_muon_run):
    ref = jax_muon_run
    engine = _port_engine(ref["tree"])
    engine.load_checkpoint(ref["universal"])
    assert engine.global_steps == engine.optimizer.count == 2
    # every leaf's state came from the export: 2-D leaves one moment
    for name in engine.params:
        names = engine.optimizer.leaf_state_names(name)
        assert names == (("exp_avg",) if engine.params[name].ndim == 2
                         else ("exp_avg", "exp_avg_sq"))
        assert all(bool(t.abs().sum() > 0) for t in
                   engine.optimizer.named_state(name).values()), name
    np.testing.assert_allclose(_train(engine, [3, 4, 5]), ref["losses"][2:],
                               rtol=1e-5)


def test_port_muon_tag_reads_in_the_jax_package(jax_muon_run, tmp_path):
    engine = _port_engine(jax_muon_run["tree"])
    _train(engine, [1, 2])
    engine.save_checkpoint(str(tmp_path))
    flat = jax_universal.load_universal(str(tmp_path / "global_step2"),
                                        include_moments=True)
    for name, p in engine.params.items():
        leaves = flat[universal_name(name)]
        assert set(leaves) == {"param",
                               *engine.optimizer.leaf_state_names(name)}
        np.testing.assert_array_equal(leaves["param"], p.detach().numpy())
        for s, buf in engine.optimizer.named_state(name).items():
            np.testing.assert_array_equal(leaves[s], buf.numpy())
    resumed = _port_engine(jax_muon_run["tree"])
    resumed.load_checkpoint(str(tmp_path))
    assert _train(resumed, [3, 4]) == _train(engine, [3, 4])
