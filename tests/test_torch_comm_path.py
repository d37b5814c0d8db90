"""The port's data-parallel training (``runtime/comm_path.py`` and the
engine's world path) against the JAX engine on the CPU.

A gloo world of 2 ranks trains the tiny CausalLM (``TransformerConfig.
tiny``, the same converted weights on both sides) for five
``train_batch`` steps of the same global batch, AdamW, WarmupLR,
clipping 1.0, on four configs: the plain wire, qgZ
(``zero_quantized_gradients``), qgZ + LoCo (``zeropp_loco``) and qgZ at
gas 2 (one exchange at the boundary). The JAX engine runs the same
configs on a 2-device mesh of the simulated CPU devices.

Tolerances, float32:
  * plain wire: the JAX engine differentiates the global batch's mean
    loss under GSPMD, the port each rank's rows and then the mean over
    ranks; the same sums in another order: losses 1e-5 relative, final
    parameters 1e-5 absolute (as the single-device engine test);
  * qgZ: each rank's gradient differs from the JAX one by float32
    summation order (~1e-7 relative), and an element near a half
    quantization step then lands one int4 step (max|g|/7 of its group)
    away; AdamW turns such an element's update into at most ~lr (1e-3)
    of change a step. Measured on these inputs the losses agree within
    4.6e-6 relative and the parameters within 1.3e-3 (the plain wire's
    within 1.7e-7 and 1.5e-7); the test allows 1e-4 relative on the losses
    and 5 steps · lr = 5e-3 on the parameters.
  * the parameters' change over the five steps (final - initial), per
    leaf, against the JAX engine's change, in the 2-norm relative to that
    change: measured 2.1e-5 on the plain wire, and 5.6e-2 (qgZ, on the
    small ``attn_norm.scale`` leaf, where one flipped int4 step weighs
    most), 1.3e-2 (qgZ + LoCo) and 1.3e-2 (gas 2) on the quantized wire;
    the test allows 1e-4 and 0.15. A port that applied no update reads
    1.0, and one that skipped the last update about 0.28 (the warmup
    gives the last of the five steps lr 1e-3 of about 3.6e-3 in all,
    the largest change of a leaf measured), so the change check holds
    the updates that the absolute one cannot.
    The exchange itself is held bit for bit against the JAX wire on
    identical inputs in ``test_torch_fused_wire.py``.

Also: ``eval_batch`` returns the data-mean loss of the global batch on
every rank, as the JAX engine's does; both ranks end with bit-identical
parameters; qgZ's collectives
carry int8 and the plain wire's none (the counterpart of the JAX
``test_wire_is_int8``); LoCo's residuals are kept per leaf and move; the
imperative path refuses at world 2 (M8); a save writes once and loads on
every rank; the config refusals name their ROADMAP items.
"""
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
from deepspeed_tpu_torch import DeepSpeedConfig
from deepspeed_tpu_torch.launcher import run_local_world
from deepspeed_tpu_torch.runtime import comm_path as tcp
from deepspeed_tpu.runtime import comm_path as jcp
from tests.test_torch_world import train_runs

pytestmark = pytest.mark.torch_port

SEQ = 128
STEPS = 5
BASE = {
    "train_batch_size": 4,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                             "warmup_num_steps": 3}},
    "gradient_clipping": 1.0,
}
QGZ = {"stage": 0, "zero_quantized_gradients": True}
CONFIGS = {
    "plain": dict(BASE),
    "qgz": dict(BASE, zero_optimization=QGZ),
    "qgz_loco": dict(BASE, zero_optimization=dict(QGZ, zeropp_loco=True)),
    "qgz_gas2": dict(BASE, gradient_accumulation_steps=2,
                     zero_optimization=QGZ),
}
TOL = {"plain": (1e-5, 1e-5, 1e-4), "qgz": (1e-4, 5e-3, 0.15),
       "qgz_loco": (1e-4, 5e-3, 0.15), "qgz_gas2": (1e-4, 5e-3, 0.15)}


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world of 2 on every config, and the JAX engine's losses
    and final parameters on a 2-device mesh."""
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, size=(4, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    names = list(CONFIGS)
    # the port's world runs in its own processes while JAX compiles here
    pool = ThreadPoolExecutor(1)
    port = pool.submit(
        run_local_world, train_runs, 2,
        (tree, [CONFIGS[k] for k in names], batches,
         str(tmp_path_factory.mktemp("ckpt"))),
        store_dir=str(tmp_path_factory.mktemp("world")))
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:2],
                           force=True)
    ref = {}
    try:
        for name in names:
            engine, _, _, _ = deepspeed_tpu.initialize(
                model=jax_tf.CausalLM(cfg), model_parameters=params,
                config=CONFIGS[name], topology=topo)
            losses = [float(engine.train_batch(
                {"input_ids": jnp.asarray(b)})) for b in batches]
            ref[name] = (losses,
                         _flat(jax.tree.map(np.asarray, engine.state.params)),
                         engine.micro_steps,
                         float(engine.eval_batch(
                             {"input_ids": jnp.asarray(batches[0])})))
    finally:
        reset_topology()
        pool.shutdown(wait=True)
    port = port.result()
    return ({name: ([port[r][i] for r in range(2)], ref[name])
             for i, name in enumerate(names)}, [port[r][-1] for r in range(2)],
            _flat(tree))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_batch_at_world_2_matches_jax(runs, name):
    ranks, (j_losses, j_params, j_micro, j_eval) = runs[0][name]
    loss_rtol, param_atol, step_rtol = TOL[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], j_losses, rtol=loss_rtol,
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(res["eval"], j_eval, rtol=loss_rtol,
                                   err_msg=f"{name} rank {r} eval")
        gas = CONFIGS[name].get("gradient_accumulation_steps", 1)
        assert res["steps"] == (STEPS, STEPS * gas, 2, r) and \
            j_micro == STEPS * gas
        for leaf, p in res["params"].items():
            np.testing.assert_allclose(p, j_params[leaf], rtol=0,
                                       atol=param_atol,
                                       err_msg=f"{name} {leaf}")
            # what the five updates moved, against what JAX's moved
            init = runs[2][leaf].astype(np.float64)
            dj, dp = j_params[leaf] - init, p - init
            assert np.linalg.norm(dp - dj) <= step_rtol * np.linalg.norm(dj), \
                (name, r, leaf, np.linalg.norm(dp - dj) / np.linalg.norm(dj))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ranks_end_bit_identical(runs, name):
    """Every rank applies the same exchanged gradient: the same losses and
    the same parameter bytes."""
    a, b = runs[0][name][0]
    assert a["losses"] == b["losses"] and a["eval"] == b["eval"]
    for leaf in a["params"]:
        assert a["params"][leaf].tobytes() == b["params"][leaf].tobytes(), \
            (name, leaf)


def test_qgz_puts_int8_on_the_wire_and_the_plain_wire_does_not(runs):
    """The counterpart of the JAX ``test_wire_is_int8``: qgZ's step
    all-to-alls and all-gathers int8; the plain wire exchanges float32
    only."""
    for name in ("qgz", "qgz_loco", "qgz_gas2"):
        for record in runs[0][name][0][0]["records"]:
            ops = {(e["op"], e["dtype"]) for e in record}
            assert ("all_to_all_single", "int8") in ops
            assert ("all_gather_into_tensor", "int8") in ops
            payload = sum(e["bytes"] for e in record if e["dtype"] == "int8")
            sidecar = sum(e["bytes"] for e in record if e["dtype"] != "int8")
            assert sidecar * 8 < payload * 2 + 4096
    for record in runs[0]["plain"][0][0]["records"]:
        assert {e["dtype"] for e in record} == {"float32"}
        assert not any(e["op"] == "all_to_all_single" for e in record)


def test_gas_2_exchanges_once_a_step(runs):
    one = len(runs[0]["qgz"][0][0]["records"][0])
    assert len(runs[0]["qgz_gas2"][0][0]["records"][0]) == one


def test_loco_residuals_are_kept_per_leaf_and_move(runs):
    ranks = runs[0]["qgz_loco"][0]
    for res in ranks:
        assert set(res["loco"]) == set(res["params"])
        assert sum(res["loco"].values()) > 0.0
    assert ranks[0]["loco"] != ranks[1]["loco"]      # each rank its own
    assert runs[0]["qgz"][0][0]["loco"] == {}


def test_imperative_path_refuses_at_world_2(runs):
    for name in CONFIGS:
        for res in runs[0][name][0]:
            assert "ROADMAP M8" in res["refused"]


def test_save_writes_once_and_every_rank_loads(runs):
    assert all(r["loaded"] for r in runs[1])


def test_batch_solve_takes_the_data_extent():
    topo2 = types.SimpleNamespace(get_data_parallel_world_size=lambda: 2)
    mesh = initialize_mesh(TopologyConfig(), devices=jax.devices()[:2],
                           force=True)
    try:
        for raw in ({"train_batch_size": 8,
                     "train_micro_batch_size_per_gpu": 2},
                    {"train_batch_size": 8, "gradient_accumulation_steps": 2},
                    {"train_micro_batch_size_per_gpu": 3}, {}):
            j = JaxConfig(raw, topology=mesh)
            p = DeepSpeedConfig(raw, topology=topo2)
            assert (p.train_batch_size, p.train_micro_batch_size_per_gpu,
                    p.gradient_accumulation_steps) == (
                j.train_batch_size, j.train_micro_batch_size_per_gpu,
                j.gradient_accumulation_steps)
        with pytest.raises(ValueError, match="dp"):
            DeepSpeedConfig({"train_batch_size": 5,
                             "train_micro_batch_size_per_gpu": 2,
                             "gradient_accumulation_steps": 1},
                            topology=topo2)
    finally:
        reset_topology()


@pytest.mark.parametrize("raw,item", [
    ({"sparse_gradients": True}, "M8"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
     "M6"),
    ({"overlap": {"enabled": True}}, "M6"),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}}, "M6"),
])
def test_wires_not_ported_are_refused(raw, item):
    with pytest.raises(NotImplementedError, match=item):
        DeepSpeedConfig(raw)


def test_zero_config_reads_the_zeropp_keys():
    c = DeepSpeedConfig({"zero_optimization": dict(QGZ, zeropp_loco=True,
                                                   zero_quantized_weights=True)})
    assert c.zero_config.zero_quantized_gradients and c.zero_config.zeropp_loco
    assert c.zero_stage == 0


def test_dp_axes_and_loco_sizes_match_jax():
    for n, numel in ((2, 1000), (3, 1000), (4, 37 * 29), (3, 100)):
        assert tcp.loco_partition_size(numel, n) == \
            jcp.loco_partition_size(numel, n)
    one = types.SimpleNamespace(dims={"data": 1})
    assert tcp.dp_axes_info(one) == ((), 1, None)
    mesh = initialize_mesh(TopologyConfig(), devices=jax.devices()[:2],
                           force=True)
    try:
        two = types.SimpleNamespace(dims={"data": 2})
        assert tcp.dp_axes_info(two) == jcp.dp_axes_info(mesh)
    finally:
        reset_topology()
