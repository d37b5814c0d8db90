"""The reference entry points the port gained (ROADMAP Queue 3.2), each
against the JAX package on the CPU in float32 (the engine's introspection
and ``zero_grad`` ride on ``test_torch_train.py``'s five JAX steps):

  * ``initialize(args, ...)`` reading ``args.deepspeed_config`` and
    ``initialize(config_params=)``, resolving the batch as the JAX config
    does, and refusing a config given twice with the JAX package's error;
    a client ``optimizer`` and ``training_data`` refused with
    ``NotImplementedError``;
  * the stateful ``WarmupLR``, ``WarmupDecayLR``, ``WarmupCosineLR``,
    ``LRRangeTest`` and ``OneCycle`` and ``build_scheduler`` (lr within
    1e-6 relative or 1e-9 absolute, as ``test_torch_train.py`` holds the
    schedule functions: float64 here, float32 in JAX);
  * ``InferenceEngineV2.serialize``, read back by ``load_universal``,
    equal to the JAX engine's serving parameters.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, TransformerConfig
from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr

from .torch_serving import port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

CONFIG = {
    "train_batch_size": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
}


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _port_model():
    cfg = TransformerConfig.tiny()
    return CausalLM(cfg, params_from_numpy(tiny_weights()[2], cfg))


def test_initialize_reads_args_and_config_params(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(CONFIG))
    ref = JaxConfig(str(path))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(4, 32))).long()
    losses = []
    for kw in ({"args": argparse.Namespace(deepspeed_config=str(path))},
               {"config_params": CONFIG}, {"config": str(path)}):
        eng, opt, loader, _ = deepspeed_tpu_torch.initialize(
            model=_port_model(), device="cpu", **kw)
        assert loader is None and opt is eng.optimizer
        assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
                eng.gradient_accumulation_steps()) == \
            (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
             ref.gradient_accumulation_steps) == (4, 2, 2)
        losses.append(float(eng.train_batch({"input_ids": tokens})))
    assert losses[0] == losses[1] == losses[2]


def test_a_config_given_twice_is_refused_alike(tmp_path):
    args = argparse.Namespace(deepspeed_config=str(tmp_path / "x.json"))
    msgs = []
    for init in (deepspeed_tpu.initialize, deepspeed_tpu_torch.initialize):
        with pytest.raises(ValueError, match="Not sure how to proceed") as e:
            init(args, model=_port_model(), config=CONFIG)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_client_optimizer_and_data_are_refused():
    """A client optimizer is a factory over the engine's masters (an
    optimizer instance is refused: it would update copies); a factory's
    torch.optim optimizer trains. The engine's data loader is M10."""
    with pytest.raises(TypeError, match="factory"):
        deepspeed_tpu_torch.initialize(
            model=_port_model(), optimizer=torch.optim.SGD(
                [torch.zeros(1, requires_grad=True)], lr=0.1),
            config=CONFIG, device="cpu")
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=_port_model(), config=CONFIG, device="cpu",
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    assert isinstance(opt.optimizer, torch.optim.SGD)
    assert opt.optimizer.param_groups[0]["params"] == \
        list(engine.params.values())
    before = {k: v.detach().clone() for k, v in engine.params.items()}
    tokens = torch.zeros(4, 16, dtype=torch.long)
    engine.train_batch({"input_ids": tokens})
    assert opt.count == engine.global_steps == 1
    assert any(not torch.equal(before[k], v)
               for k, v in engine.params.items())
    with pytest.raises(NotImplementedError, match="M10"):
        deepspeed_tpu_torch.initialize(model=_port_model(), config=CONFIG,
                                       training_data=[1, 2], device="cpu")


SCHEDULERS = [
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_num_steps": 6}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 5,
                        "peak_lr": 3e-3}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_first_step_size": 4, "decay_lr_rate": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULERS)
def test_stateful_schedulers_match_jax(name, params):
    js = jax_lr.build_scheduler(name, params)
    ps = port_lr.build_scheduler(name, params)
    assert type(ps).__name__ == type(js).__name__ == name
    j_lrs, p_lrs = [], []
    for _ in range(24):
        js.step()
        ps.step()
        j_lrs.append(js.get_last_lr()[0])
        p_lrs.append(ps.get_last_lr()[0])
    np.testing.assert_allclose(p_lrs, j_lrs, rtol=1e-6, atol=1e-9)
    assert ps.state_dict() == js.state_dict() == {"last_batch_iteration": 23}
    fresh = port_lr.build_scheduler(name, params)
    fresh.load_state_dict(js.state_dict())
    assert fresh.get_last_lr() == ps.get_last_lr()
    ps.step(3)
    js.step(3)
    np.testing.assert_allclose(ps.get_lr(), js.get_lr(), rtol=1e-6)
    with pytest.raises(ValueError):
        port_lr.build_scheduler("Constant", {})


def test_serialize_writes_the_serving_parameters(tmp_path):
    cfg, params, _ = tiny_weights()
    ref = _flat(jax.tree.map(np.asarray, jax_engine.InferenceEngineV2(
        jax_tf.CausalLM(cfg), params, jax_engine.RaggedInferenceEngineConfig(
            dtype=np.float32)).params))
    eng = port_engine_for(tiny_weights())
    eng.serialize(str(tmp_path))
    got = load_universal(str(tmp_path / "model"))
    assert {k.replace("/", ".") for k in got} == set(ref)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), ref[name.replace("/", ".")],
                                      err_msg=name)
