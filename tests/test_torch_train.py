"""The port's training slice on the CPU against the JAX package, with the
same converted weights and the same numpy inputs, in float32:

  * ``forward`` logits, ``lm_loss`` and its gradients against the JAX
    ``forward``/``lm_loss``/``jax.grad`` on ``TransformerConfig.tiny()`` at
    S 128, where the port's ``"auto"`` knobs select flash attention and
    the fused RMSNorm+matmul (their plain versions on CPU tensors) and the
    JAX package's select its XLA composition;
  * five ``train_batch`` steps (AdamW, WarmupLR, clipping 1.0, gas 2)
    against the JAX engine's on a one-device mesh, with the engine's
    introspection (``get_fp32_state_dict``, ``global_samples``, the batch
    and ZeRO stage getters) and five imperative steps that drop a stray
    micro-batch by ``zero_grad``;
  * the optimizers against optax, the schedules and the dynamic loss
    scaler against the JAX functions, the config errors against the JAX
    config's.

Tolerances, float32 summation order through two layers: logits and loss
1e-5 relative (1e-4 abs on logits); gradients 2e-5 of the largest
gradient of each tensor; five steps' losses 1e-5 relative (the JAX
engine's updates and the port's agree to float32 rounding, and the lr is
computed in float64 on the port's side, float32 on the JAX side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls
from deepspeed_tpu.runtime.optimizer import build_optimizer as jax_opt
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, DeepSpeedConfig, TransformerConfig
from deepspeed_tpu_torch.models import transformer as port_tf
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as port_ls
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer as port_opt

pytestmark = pytest.mark.torch_port

SEQ = 128


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _tokens(seed, batch):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(batch, SEQ)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# --------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("remat,knobs", [
    (False, {}), (True, {}),
    (False, dict(attn_impl="xla", fused_rmsnorm="off"))])
def test_forward_loss_and_grads_match_jax(jax_params, remat, knobs):
    params, tree = jax_params
    tokens = _tokens(1, 2)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], axis=1)
    labels[0, :10] = -100                    # some ignored positions
    jcfg = jax_tf.TransformerConfig.tiny(remat=remat)
    batch_j = {"input_ids": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits_j = jax_tf.forward(params, jnp.asarray(tokens), jcfg)
    loss_j, grads_j = jax.value_and_grad(jax_tf.lm_loss)(params, batch_j, jcfg)

    pcfg = TransformerConfig.tiny(remat=remat, **knobs)
    state = {k: v.requires_grad_() for k, v in
             params_from_numpy(tree, pcfg).items()}
    batch_p = {"input_ids": torch.from_numpy(tokens).long(),
               "labels": torch.from_numpy(labels).long()}
    logits = port_tf.forward(state, batch_p["input_ids"], pcfg)
    loss = port_tf.lm_loss(state, batch_p, pcfg)
    names = sorted(state)
    grads = torch.autograd.grad(loss, [state[n] for n in names])

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    flat_j = _flat(grads_j)
    for name, g in zip(names, grads):
        ref = flat_j[name]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_labels_default_to_shifted_tokens(jax_params):
    _, tree = jax_params
    cfg = TransformerConfig.tiny()
    state = params_from_numpy(tree, cfg)
    tokens = torch.from_numpy(_tokens(2, 2)).long()
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1), value=-100)
    a = port_tf.lm_loss(state, {"input_ids": tokens}, cfg)
    b = port_tf.lm_loss(state, {"input_ids": tokens, "labels": labels}, cfg)
    assert float(a) == float(b)


def test_other_remat_policies_are_refused(jax_params):
    _, tree = jax_params
    cfg = TransformerConfig.tiny(remat=True,
                                 remat_policy="dots_saveable")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        port_tf.forward(params_from_numpy(tree, cfg),
                        torch.zeros(1, 8, dtype=torch.long), cfg)


def test_flops_per_token_matches_jax():
    jcfg = jax_tf.TransformerConfig.llama3_8b()
    pcfg = TransformerConfig.llama3_8b()
    model = CausalLM(TransformerConfig.tiny(), port_tf.init_params(
        TransformerConfig.tiny(), torch.Generator(), device="cpu"))
    model.config = pcfg
    assert model.flops_per_token() == jax_tf.CausalLM(jcfg).flops_per_token()


# --------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------- #
ENGINE_CONFIG = {
    "train_batch_size": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 3}},
    "gradient_clipping": 1.0,
}


@pytest.fixture(scope="module")
def jax_five_steps(jax_params):
    """Five ``train_batch`` steps of the JAX engine on a one-device mesh,
    and what its entry points report after them."""
    params, _ = jax_params
    tokens = _tokens(3, 4)
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        j_engine, _, _, _ = deepspeed_tpu.initialize(
            model=jax_tf.CausalLM(jax_tf.TransformerConfig.tiny()),
            model_parameters=params, config=ENGINE_CONFIG, topology=topo)
        losses = [float(j_engine.train_batch(
            {"input_ids": jnp.asarray(tokens)})) for _ in range(5)]
        return {"tokens": tokens, "losses": losses,
                "global_steps": j_engine.global_steps,
                "micro_steps": j_engine.micro_steps,
                "lr": j_engine.get_lr(),
                "params": _flat(jax.tree.map(np.asarray,
                                             j_engine.state.params)),
                "fp32": _flat(j_engine.get_fp32_state_dict()),
                "global_samples": j_engine.global_samples,
                "micro": j_engine.train_micro_batch_size_per_gpu(),
                "stage": j_engine.zero_optimization_stage(),
                "no_sync": type(j_engine.no_sync())}
    finally:
        reset_topology()


def test_engine_five_steps_match_jax(jax_params, jax_five_steps):
    _, tree = jax_params
    ref = jax_five_steps
    pcfg = TransformerConfig.tiny()
    model = CausalLM(pcfg, params_from_numpy(tree, pcfg), trainable=True)
    engine, optimizer, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=ENGINE_CONFIG, device="cpu")
    assert loader is None and optimizer is engine.optimizer
    batch = {"input_ids": torch.from_numpy(ref["tokens"]).long()}
    losses = [float(engine.train_batch(batch)) for _ in range(5)]

    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert losses[0] == losses[1]          # WarmupLR: lr(0) = 0
    assert losses[4] < losses[0]
    assert engine.global_steps == ref["global_steps"] == 5
    assert engine.micro_steps == ref["micro_steps"] == 10
    assert engine.skipped_steps == 0
    np.testing.assert_allclose(engine.get_lr(), ref["lr"], rtol=1e-6)
    # the masters share the model's storage: the model holds the result
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref["params"][name],
                                   rtol=0, atol=1e-5, err_msg=name)
    # the reference's introspection (ROADMAP Queue 3.2): the float32
    # masters on the host by name, the sample and batch counters
    fp32 = engine.get_fp32_state_dict()
    assert set(fp32) == set(ref["fp32"])
    for name, t in fp32.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), ref["fp32"][name], rtol=0,
                                   atol=1e-5, err_msg=name)
    assert engine.global_samples == ref["global_samples"] == 20
    assert engine.train_micro_batch_size_per_gpu() == ref["micro"] == 2
    assert engine.zero_optimization_stage() == ref["stage"] == 0


def test_zero_grad_and_no_sync_match_jax(jax_params, jax_five_steps):
    """A stray micro-batch's gradients, dropped by ``zero_grad``, leave
    five imperative steps (their micro-batches under ``no_sync``, a no-op
    context in both packages) at the JAX engine's train_batch masters."""
    _, tree = jax_params
    ref = jax_five_steps
    cfg = TransformerConfig.tiny()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg, params_from_numpy(tree, cfg)),
        config=ENGINE_CONFIG, device="cpu")
    assert type(engine.no_sync()) is ref["no_sync"]
    tokens = torch.from_numpy(ref["tokens"]).long()
    stray = {"input_ids": torch.flip(tokens[:2], dims=[1])}
    for _ in range(5):
        engine.backward(stray)
        engine.zero_grad()
        engine.micro_steps -= 1               # the stray was not a step
        assert all(p.grad is None for p in engine.params.values())
        with engine.no_sync():
            for mb in tokens.reshape(2, 2, SEQ):
                engine.backward({"input_ids": mb})
        engine.step()
    assert engine.global_steps == 5 and engine.micro_steps == 10
    for name, t in engine.get_fp32_state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref["fp32"][name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_imperative_path_matches_train_batch(jax_params):
    _, tree = jax_params
    cfg = TransformerConfig.tiny()
    tokens = torch.from_numpy(_tokens(4, 4)).long()
    engines = [deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg, params_from_numpy(tree, cfg)),
        config=ENGINE_CONFIG, device="cpu")[0] for _ in range(2)]
    fused, loop = engines
    for _ in range(2):
        fused.train_batch({"input_ids": tokens})
        for mb in tokens.reshape(2, 2, SEQ):
            loop.backward({"input_ids": mb})
            loop.step()
    assert loop.global_steps == fused.global_steps == 2
    for name in fused.params:
        torch.testing.assert_close(loop.params[name], fused.params[name],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loop.eval_batch({"input_ids": tokens})),
                               float(fused.eval_batch({"input_ids": tokens})),
                               rtol=1e-6)


def test_initialize_needs_cuda_unless_told_otherwise(jax_params):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    _, tree = jax_params
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(tree, cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.initialize(model=model, config=ENGINE_CONFIG)


def test_fp16_overflow_skips_the_update():
    """Dynamic loss scaling: a step whose gradients overflow keeps the
    parameters and the optimizer count, halves the scale once the
    hysteresis is spent, and counts a skipped step."""
    w = torch.ones(4)

    def loss_fn(params, batch, rng):
        return (params["w"].float() * batch).square().sum()

    config = {"train_batch_size": 1,
              "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
              "fp16": {"enabled": True, "initial_scale_power": 4,
                       "hysteresis": 1}}
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters={"w": w}, config=config, device="cpu")
    engine.train_batch(torch.tensor([float("inf"), 1.0, 1.0, 1.0]))
    assert engine.skipped_steps == 1 and engine.global_steps == 0
    assert opt.count == 0 and engine.get_loss_scale() == 8.0
    torch.testing.assert_close(engine.params["w"], torch.ones(4))
    engine.train_batch(torch.tensor([0.5, 0.5, 0.5, 0.5]))
    assert engine.global_steps == 1 and opt.count == 1
    torch.testing.assert_close(engine.params["w"], torch.full((4,), 0.95),
                               rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------- #
# Config, optimizers, schedules, loss scaling
# --------------------------------------------------------------------- #
BAD_CONFIGS = {
    "fp16_and_bf16": {"fp16": {"enabled": True}, "bf16": {"enabled": True}},
    "batch_mismatch": {"train_batch_size": 5,
                       "train_micro_batch_size_per_gpu": 2,
                       "gradient_accumulation_steps": 2},
    "zero_stage_4": {"zero_optimization": {"stage": 4}},
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_config_errors_raise_value_error_in_both(name):
    with pytest.raises(ValueError):
        JaxConfig(BAD_CONFIGS[name])
    with pytest.raises(ValueError):
        DeepSpeedConfig(BAD_CONFIGS[name])


def test_batch_solve_matches_jax():
    for raw in ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
                {"train_batch_size": 8, "gradient_accumulation_steps": 4},
                {"train_micro_batch_size_per_gpu": 3,
                 "gradient_accumulation_steps": 2},
                {"train_batch_size": 6}, {"train_micro_batch_size_per_gpu": 5},
                {}):
        j, p = JaxConfig(raw), DeepSpeedConfig(raw)
        assert (p.train_batch_size, p.train_micro_batch_size_per_gpu,
                p.gradient_accumulation_steps) == (
            j.train_batch_size, j.train_micro_batch_size_per_gpu,
            j.gradient_accumulation_steps)


@pytest.mark.parametrize("raw,item", [
    ({"zero_optimization": {"stage": 2, "overlap_comm": True}}, "M6"),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}}, "M6"),
    ({"telemetry": {"enabled": True}}, "M11"),
    ({"comms_logger": {"enabled": True}}, "M11"),
    ({"overlap": {"enabled": True}}, "M6"),
])
def test_blocks_not_ported_are_refused(raw, item):
    with pytest.raises(NotImplementedError, match=item):
        DeepSpeedConfig(raw)
    DeepSpeedConfig({"telemetry": {"enabled": False}, "overlap": {}})


@pytest.mark.parametrize("name,params", [
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}),
    ("Adam", {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "nesterov": True,
             "weight_decay": 0.01}),
])
def test_optimizers_match_optax(name, params):
    import optax

    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3)]
    lr = lambda count: params["lr"] * (1.0 + count)        # noqa: E731
    tx = jax_opt(name, params, learning_rate=lambda c: params["lr"] * (1.0 + c))
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    opt = port_opt(name, params, learning_rate=lr)
    pt = {"p": torch.from_numpy(p0.copy())}
    opt.init(pt)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step(pt, {"p": torch.from_numpy(g)})
    np.testing.assert_allclose(pt["p"].numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["OneBitAdam", "OneBitLamb",
                                  "ZeroOneAdam"])
def test_optimizer_names_not_offered_are_refused(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_opt(name, {}, learning_rate=lambda c: 1e-3)


@pytest.mark.parametrize("sched,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
                  "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 10,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"warmup_num_steps": 5, "total_num_steps": 20}),
    ("WarmupCosineLR", {"warmup_num_steps": 5, "total_num_steps": 20}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_first_step_size": 4, "cycle_second_step_size": 6,
                  "decay_lr_rate": 0.1}),
])
def test_schedules_match_jax(sched, params):
    fj = jax_lr.get_schedule_fn(sched, params, base_lr=3e-3)
    fp = port_lr.get_schedule_fn(sched, params, base_lr=3e-3)
    steps = range(25)
    np.testing.assert_allclose([fp(s) for s in steps],
                               [float(fj(s)) for s in steps], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("consecutive", [False, True])
def test_dynamic_loss_scaler_state_matches_jax(consecutive):
    kw = dict(init_scale=2.0 ** 10, scale_window=3, min_scale=4.0,
              delayed_shift=2, consecutive_hysteresis=consecutive)
    js, ps = jax_ls.DynamicLossScaler(**kw), port_ls.DynamicLossScaler(**kw)
    sj, sp = js.init(), ps.init()
    overflows = [False, True, True, True, False, False, False, True, False,
                 True, True, True, True, True, True, True, False, False]
    for ov in overflows:
        sj, sp = js.update(sj, jnp.asarray(ov)), ps.update(sp, ov)
        assert (sp.scale, sp.good_steps, sp.hysteresis) == (
            float(sj.scale), int(sj.good_steps), int(sj.hysteresis))
    bf16 = port_ls.create_loss_scaler(DeepSpeedConfig(
        {"fp16": {"enabled": False}, "bf16": {"enabled": True}}).fp16,
        torch.bfloat16)
    assert not bf16.dynamic and bf16.init().scale == 1.0
