"""Checkpoints of the port on the CPU, and their exchange with the JAX
package through the universal layout:

  * resume: save after 2 steps, load into a fresh engine, 3 more steps —
    losses and masters bitwise equal to an uninterrupted run, for each
    optimizer family;
  * the load options (``load_module_only``, ``load_optimizer_states``),
    ``latest`` and ``tag=None``, damaged files (``CheckpointCorruptError``
    for an explicit tag, fallback to the newest valid tag for ``None``);
  * JAX → port: the JAX engine's checkpoint, exported by the JAX
    ``ds_to_universal.convert``, resumes in the port (losses of 3 more
    steps within 1e-5, the engine-test bound);
  * port → JAX: the JAX ``load_universal`` reads a port tag directory
    bitwise, and the JAX ``lm_loss`` on it equals the port's
    ``eval_batch`` within 1e-5;
  * ``zero_to_fp32``, the port's ``convert``, bfloat16 leaves both ways
    without ``ml_dtypes`` on the port's side, and the ``checkpoint``
    config block.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import ds_to_universal as jax_universal
from deepspeed_tpu.checkpoint.universal.layout import \
    flat_values as jax_flat_values
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, DeepSpeedConfig, TransformerConfig
from deepspeed_tpu_torch.checkpoint import ds_to_universal, zero_to_fp32
from deepspeed_tpu_torch.checkpoint.universal.layout import universal_name
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.runtime.checkpoint_engine import \
    NumpyCheckpointEngine
from deepspeed_tpu_torch.runtime.fault.manifest import (
    CheckpointCorruptError,
    verify_checkpoint,
)

pytestmark = pytest.mark.torch_port

SEQ = 128


def _config(opt="AdamW", params=None, **extra):
    cfg = {"train_batch_size": 2,
           "optimizer": {"type": opt,
                         "params": params or {"lr": 3e-3,
                                              "weight_decay": 0.1}},
           "gradient_clipping": 1.0}
    cfg.update(extra)
    return cfg


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(2, SEQ)).astype(np.int32)


def _batch(seed):
    return {"input_ids": torch.from_numpy(_tokens(seed)).long()}


def _engine(config, seed=0):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                                      device="cpu"))
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          device="cpu")[0]


def _train(engine, seeds):
    return [float(engine.train_batch(_batch(s))) for s in seeds]


@pytest.fixture
def quiet_warnings(monkeypatch):
    seen = []
    monkeypatch.setattr(engine_module.logger, "warning", seen.append)
    return seen


# --------------------------------------------------------------------- #
# Port resume
# --------------------------------------------------------------------- #
RESUME_CASES = {
    "AdamW": _config(scheduler={"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
        "warmup_num_steps": 4}}),
    "FusedAdam": _config("FusedAdam"),
    "FusedLamb": _config("FusedLamb"),
    "Lion": _config("Lion", {"lr": 1e-4, "weight_decay": 0.1}),
    "FusedAdagrad": _config("FusedAdagrad", {"lr": 1e-2}),
    "SGD": _config("SGD", {"lr": 1e-2, "momentum": 0.9}),
}


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_resume_is_bitwise(tmp_path, name):
    config = RESUME_CASES[name]
    seeds = [1, 2, 3, 4, 5]
    straight = _engine(config)
    want = _train(straight, seeds)

    first = _engine(config)
    assert _train(first, seeds[:2]) == want[:2]
    assert first.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    del first
    resumed = _engine(config, seed=9)         # other weights: all overwritten
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "global_step2")
    assert client == {"epoch": 3}
    assert resumed.global_steps == resumed.optimizer.count == 2
    assert resumed.micro_steps == 2 and resumed.skipped_steps == 0
    assert _train(resumed, seeds[2:]) == want[2:]
    for n, p in straight.params.items():
        assert torch.equal(resumed.params[n], p), n
        for s, buf in straight.optimizer.named_state(n).items():
            assert torch.equal(resumed.optimizer.named_state(n)[s], buf), s


def test_load_options_follow_the_jax_engine(tmp_path):
    """``load_module_only`` and ``load_optimizer_states=False`` restore the
    masters only: the counters, the optimizer state and the count stay the
    loading engine's (the JAX engine replaces ``params`` alone)."""
    src = _engine(_config())
    _train(src, [1, 2])
    src.save_checkpoint(str(tmp_path))
    for kwargs in ({"load_module_only": True},
                   {"load_optimizer_states": False}):
        dst = _engine(_config(), seed=5)
        path, _ = dst.load_checkpoint(str(tmp_path), **kwargs)
        assert path.endswith("global_step2")
        for n, p in src.params.items():
            assert torch.equal(dst.params[n], p)
            assert all(not buf.any() for buf in
                       dst.optimizer.named_state(n).values())
        assert dst.global_steps == dst.optimizer.count == 0


def test_latest_and_tag_none(tmp_path):
    engine = _engine(_config())
    _train(engine, [1])
    engine.save_checkpoint(str(tmp_path))                    # global_step1
    _train(engine, [2])
    engine.save_checkpoint(str(tmp_path))                    # global_step2
    _train(engine, [3])
    engine.save_checkpoint(str(tmp_path), save_latest=False)  # unpublished
    with open(tmp_path / "latest") as f:
        assert f.read().strip() == "global_step2"
    fresh = _engine(_config())
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and fresh.global_steps == 2
    path, _ = fresh.load_checkpoint(str(tmp_path), tag="global_step3")
    assert fresh.global_steps == 3
    assert NumpyCheckpointEngine(str(tmp_path)).valid_tags() == [
        "global_step3", "global_step2", "global_step1"]


def test_nothing_to_load_returns_none(tmp_path, quiet_warnings):
    assert _engine(_config()).load_checkpoint(str(tmp_path)) == (None, {})
    assert quiet_warnings


def test_damaged_checkpoints(tmp_path, quiet_warnings):
    """A flipped byte fails an explicit tag; with ``tag=None`` the load
    falls back to the newest valid committed tag."""
    engine = _engine(_config())
    _train(engine, [1])
    engine.save_checkpoint(str(tmp_path))
    _train(engine, [2])
    engine.save_checkpoint(str(tmp_path))
    leaf = tmp_path / "global_step2" / "zero" / "embed.embedding" / "fp32.npy"
    data = bytearray(leaf.read_bytes())
    data[-5] ^= 0x40
    leaf.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="hash mismatch"):
        verify_checkpoint(str(tmp_path / "global_step2"))
    fresh = _engine(_config())
    with pytest.raises(CheckpointCorruptError):
        fresh.load_checkpoint(str(tmp_path), tag="global_step2")
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and fresh.global_steps == 1
    # a truncated file and a missing one fail too
    (tmp_path / "global_step1" / "meta.json").write_text("{")
    with pytest.raises(CheckpointCorruptError):
        fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    os.remove(tmp_path / "global_step1" / "index.json")
    with pytest.raises(CheckpointCorruptError, match="missing"):
        verify_checkpoint(str(tmp_path / "global_step1"))
    assert fresh.load_checkpoint(str(tmp_path)) == (None, {})


def test_gc_keeps_the_newest_tags(tmp_path):
    engine = _engine(_config())
    store = NumpyCheckpointEngine(str(tmp_path))
    for seed in (1, 2, 3):
        _train(engine, [seed])
        engine.save_checkpoint(str(tmp_path))
    assert store.gc_tags(2) == ["global_step1"]
    assert store.committed_tags() == ["global_step2", "global_step3"]
    assert store.latest_tag() == "global_step3"


# --------------------------------------------------------------------- #
# Exchange with the JAX package
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine: 2 AdamW steps, ``save_checkpoint``, the JAX
    ``convert`` to a universal directory, then 3 more steps."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        engine, _, _, _ = deepspeed_tpu.initialize(
            model=jax_tf.CausalLM(cfg), model_parameters=params,
            config=_config(), topology=topo)
        for s in (1, 2):
            engine.train_batch({"input_ids": jnp.asarray(_tokens(s))})
        engine.save_checkpoint(str(root / "ck"))
        tag = jax_universal.convert(str(root / "ck"), str(root / "u"))
        losses = [float(engine.train_batch(
            {"input_ids": jnp.asarray(_tokens(s))})) for s in (3, 4, 5)]
    finally:
        reset_topology()
    return {"universal": str(root / "u"), "tag": tag, "losses": losses,
            "names": sorted(jax_flat_values(params))}


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    engine = _engine(_config(), seed=3)
    path, client = engine.load_checkpoint(jax_run["universal"])
    assert path == jax_run["universal"] and client == {}
    assert engine.global_steps == engine.optimizer.count == 2
    np.testing.assert_allclose(_train(engine, [3, 4, 5]), jax_run["losses"],
                               rtol=1e-5)


def test_universal_names_are_the_jax_flat_names(jax_run):
    assert sorted(universal_name(n) for n in
                  _engine(_config()).params) == jax_run["names"]


def test_jax_export_without_an_accumulator_warns(jax_run, quiet_warnings):
    """The JAX ``convert`` carries Adam's moments only: a FusedAdagrad
    engine loading it says that its accumulator starts afresh."""
    engine = _engine(_config("FusedAdagrad", {"lr": 1e-2}))
    engine.load_checkpoint(jax_run["universal"])
    assert any("sum_of_squares" in w for w in quiet_warnings)
    assert all(torch.equal(a, torch.zeros_like(a)) for (a,) in
               engine.optimizer.state.values())


def test_port_checkpoint_reads_in_the_jax_package(tmp_path):
    engine = _engine(_config())
    _train(engine, [1, 2])
    engine.save_checkpoint(str(tmp_path))
    flat = jax_universal.load_universal(str(tmp_path / "global_step2"),
                                        include_moments=True)
    assert len(flat) == len(engine.params)
    for name, p in engine.params.items():
        leaves = flat[universal_name(name)]
        np.testing.assert_array_equal(leaves["param"], p.detach().numpy())
        for s, buf in engine.optimizer.named_state(name).items():
            np.testing.assert_array_equal(leaves[s], buf.numpy())
    tree = jax_universal.unflatten({k: v["param"] for k, v in flat.items()})
    loss_j = jax_tf.lm_loss(tree, {"input_ids": jnp.asarray(_tokens(7))},
                            jax_tf.TransformerConfig.tiny())
    np.testing.assert_allclose(float(engine.eval_batch(_batch(7))),
                               float(loss_j), rtol=1e-5)


def test_port_convert_and_zero_to_fp32(tmp_path):
    engine = _engine(_config("FusedLion", {"lr": 1e-4}))
    _train(engine, [1])
    engine.save_checkpoint(str(tmp_path / "ck"))
    tag = ds_to_universal.convert(str(tmp_path / "ck"), str(tmp_path / "u"))
    assert tag == "global_step1"
    with open(tmp_path / "u" / "index.json") as f:
        assert json.load(f)["source_tag"] == "global_step1"
    back = ds_to_universal.load_universal(str(tmp_path / "u"),
                                          include_moments=True)
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "ck"))
    assert set(sd) == set(engine.params)
    for name, p in engine.params.items():
        assert torch.equal(sd[name], p.detach())
        assert torch.equal(back[universal_name(name)]["exp_avg"],
                           engine.optimizer.named_state(name)["exp_avg"])
    out = str(tmp_path / "fp32.pt")
    zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp_path / "ck"), out)
    loaded = torch.load(out)
    assert all(torch.equal(loaded[n], sd[n]) for n in sd)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bfloat16 in ``.npy`` as raw words, the dtype in the index: the JAX
    ``_save_leaf`` → the port's ``_load_leaf`` and back, bitwise, the
    port's side without ``ml_dtypes``."""
    import ml_dtypes

    src = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    rec = jax_universal._save_leaf(str(tmp_path), "w",
                                   src.astype(ml_dtypes.bfloat16))
    got = ds_to_universal._load_leaf(str(tmp_path), rec)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(src).to(torch.bfloat16))

    arr, dtype = ds_to_universal.host_array(got * 2)
    rec = ds_to_universal._save_leaf(str(tmp_path), "w2", arr, dtype)
    back = jax_universal._load_leaf(str(tmp_path), rec)
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.astype(np.float32),
                                  (got * 2).float().numpy())


def test_checkpoint_block_is_accepted():
    block = {"tag_validation": "Fail", "load_universal": True,
             "use_node_local_storage": True, "parallel_write":
             {"pipeline_stage": True}, "async_save": False}
    port = DeepSpeedConfig({"checkpoint": block}).checkpoint_config
    ref = JaxConfig({"checkpoint": block}).checkpoint_config
    for key in block:
        assert getattr(port, key) == getattr(ref, key)
    assert DeepSpeedConfig({}).checkpoint_config.async_save \
        == JaxConfig({}).checkpoint_config.async_save


def test_unflatten_matches_jax():
    flat = {"a/b": 1, "a/c": 2, "d": 3, "a/e/f": 4}
    assert ds_to_universal.unflatten(flat) == jax_universal.unflatten(flat)
