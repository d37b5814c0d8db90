"""ZeRO on one device, optimizer offload, Twin-Flow, ``offload_states`` and
the client optimizer of the port, on the CPU at ``TransformerConfig.tiny``:

  * the ``zero_optimization`` block read as the JAX config reads it
    (stages, ``offload_optimizer``/``offload_param``, ``cpu_offload``, the
    ``stage3_*`` aliases);
  * every stage 1-3 and offload variant (host state at ratio 1, Twin-Flow
    at 0.3/0.5/0.7, ``pipeline_read``, one ring buffer, pieces cut small
    so that leaves stream in several) bit for bit against the resident
    stage 0, losses, masters and the optimizer state, for the optimizer
    families (elementwise ones stream pieces in place, Lamb/FusedLamb and
    Muon join whole leaves);
  * stage 2 with ``offload_optimizer: cpu`` and stage 3 with ratio 0.5 and
    ``pipeline_read`` against the JAX engine: five losses within 1e-5
    relative (the engine tests' bound);
  * Twin-Flow's split per leaf and ``byte_split`` against the JAX
    ``_plan_leaf`` and ``build_twin_flow``;
  * the prefetcher's counters and an injected ``offload_prefetch``
    failure (the losses unchanged, bit for bit);
  * ``offload_states``/``reload_states`` to host memory and to files;
  * checkpoints of an offloaded engine loading into other placements;
    a JAX Twin-Flow tag, whose export does not convert;
  * the client optimizer (``torch.optim.AdamW(foreach=False)`` as a
    factory) against the JAX engine with an optax ``adamw`` client:
    five losses within 1e-5; a save/load round trip continuing bit for
    bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import ds_to_universal as jax_universal
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    initialize_mesh,
    reset_topology,
)
from deepspeed_tpu.runtime.zero import twin_flow as jax_twin_flow
from deepspeed_tpu.runtime.zero.sharding import ZeroShardingPlan
import deepspeed_tpu_torch
from deepspeed_tpu_torch import CausalLM, DeepSpeedConfig, TransformerConfig
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.fault import injection as port_injection
from deepspeed_tpu_torch.runtime.optimizer import ClientOptimizer
from deepspeed_tpu_torch.runtime.swap_tensor import streamed_update
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    AsyncPartitionedParameterSwapper,
    AsyncTensorSwapper,
    PartitionedOptimizerSwapper,
)
from deepspeed_tpu_torch.runtime.zero import twin_flow

pytestmark = pytest.mark.torch_port

SEQ = 128
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
CPU_OFFLOAD = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
TWIN_FLOW = {"stage": 3, "offload_optimizer": {
    "device": "cpu", "ratio": 0.5, "pipeline_read": True}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's many small ops on one thread: with the suite's
    workers sharing the machine's cores, PyTorch's thread pool makes them
    ~30x slower, and the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed, batch=4):
    return np.random.default_rng(seed).integers(
        0, 256, size=(batch, SEQ)).astype(np.int32)


def _with(base, zero=None, **extra):
    cfg = dict(base, **extra)
    if zero is not None:
        cfg["zero_optimization"] = zero
    return cfg


@pytest.fixture(scope="module")
def tree():
    cfg = jax_tf.TransformerConfig.tiny()
    return jax.tree.map(np.asarray,
                        jax_tf.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_losses(tree, config, optimizer=None, steps=5, save_dir=None):
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        engine, _, _, _ = deepspeed_tpu.initialize(
            model=jax_tf.CausalLM(jax_tf.TransformerConfig.tiny()),
            model_parameters=jax.tree.map(jnp.asarray, tree), config=config,
            topology=topo, optimizer=optimizer)
        losses = [float(engine.train_batch(
            {"input_ids": jnp.asarray(_tokens(3))})) for _ in range(steps)]
        stats = None if engine._offload_prefetcher is None else \
            engine._offload_prefetcher.stats()
        if save_dir is not None:
            engine.save_checkpoint(save_dir)
        return losses, stats
    finally:
        reset_topology()


@pytest.fixture(scope="module")
def jax_offload_runs(tree, tmp_path_factory):
    """The JAX engine's five losses with host offload (stage 2) and with
    Twin-Flow 0.5 + pipeline_read (stage 3, saved and exported)."""
    root = tmp_path_factory.mktemp("jax_twin")
    cpu, _ = _jax_losses(tree, _with(ENGINE_CONFIG, CPU_OFFLOAD))
    twin, stats = _jax_losses(tree, _with(ENGINE_CONFIG, TWIN_FLOW),
                              save_dir=str(root / "ck"))
    jax_universal.convert(str(root / "ck"), str(root / "u"))
    return {"cpu": cpu, "twin": twin, "twin_stats": stats,
            "twin_universal": str(root / "u")}


def _engine(tree, config, optimizer=None):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(tree, cfg), trainable=True)
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          optimizer=optimizer,
                                          device="cpu")[0]


def _train(engine, seeds):
    return [float(engine.train_batch(
        {"input_ids": torch.from_numpy(_tokens(s)).long()})) for s in seeds]


def _same_run(a, b):
    """Masters and every optimizer state leaf bit for bit."""
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        sa = a._state_owner.named_state(name)
        sb = b._state_owner.named_state(name)
        assert sa.keys() == sb.keys(), name
        for s in sa:
            assert torch.equal(sa[s], sb[s]), (name, s)


# --------------------------------------------------------------------- #
# The config block
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("zero", [
    {"stage": 1}, {"stage": 2}, {"stage": 3},
    CPU_OFFLOAD, TWIN_FLOW,
    {"stage": 2, "cpu_offload": True},
    {"stage": 3, "offload_optimizer": {"device": "nvme",
                                       "nvme_path": "/nonexistent"},
     "offload_param": {"device": "cpu", "pin_memory": True}},
    {"stage": 3, "stage3_max_live_parameters": 7,
     "stage3_param_persistence_threshold": 5,
     "offload_optimizer": {"device": "cpu", "buffer_count": 2,
                           "pin_memory": True, "fast_init": True}},
])
def test_zero_block_reads_as_the_jax_config(zero):
    raw = {"train_batch_size": 2, "zero_optimization": zero}
    j, p = JaxConfig(raw).zero_config, DeepSpeedConfig(raw).zero_config
    assert p.stage == j.stage
    assert p.offload_optimizer_device() == j.offload_optimizer_device()
    assert p.offload_param_device() == j.offload_param_device()
    for name in ("max_live_parameters", "param_persistence_threshold",
                 "cpu_offload"):
        assert getattr(p, name) == getattr(j, name), name
    if j.offload_optimizer is not None:
        for name in ("buffer_count", "pin_memory", "pipeline_read",
                     "pipeline_write", "fast_init", "ratio", "nvme_path"):
            assert getattr(p.offload_optimizer, name) == \
                getattr(j.offload_optimizer, name), name


def test_zero_block_errors_match_the_jax_config():
    for zero in ({"stage": 4}, {"offload_optimizer": {"device": "gpu"}},
                 {"reduce_bucket_size": -1}):
        raw = {"train_batch_size": 2, "zero_optimization": zero}
        with pytest.raises(ValueError):
            JaxConfig(raw)
        with pytest.raises(ValueError):
            DeepSpeedConfig(raw)


# --------------------------------------------------------------------- #
# Bit for bit against the resident stage 0
# --------------------------------------------------------------------- #
VARIANTS = {
    "stage1": {"stage": 1},
    "stage2": {"stage": 2},
    "stage3": {"stage": 3},
    "cpu": CPU_OFFLOAD,
    "cpu_pipeline": {"stage": 3, "offload_optimizer": {
        "device": "cpu", "pipeline_read": True}},
    "cpu_offload_alias": {"stage": 1, "cpu_offload": True},
    "twin0.3_one_buffer": {"stage": 2, "offload_optimizer": {
        "device": "cpu", "ratio": 0.3, "buffer_count": 1}},
    "twin0.5_pipeline": TWIN_FLOW,
    "twin0.7": {"stage": 1, "offload_optimizer": {"device": "cpu",
                                                  "ratio": 0.7}},
    "nvme_and_param_offload": {"stage": 3, "offload_optimizer": {
        "device": "nvme"}, "offload_param": {"device": "cpu"}},
}


@pytest.fixture(scope="module")
def resident_adamw(tree):
    engine = _engine(tree, ENGINE_CONFIG)
    return engine, _train(engine, [1, 2, 3, 4, 5])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variants_equal_the_resident_engine(tree, resident_adamw, variant,
                                            monkeypatch):
    monkeypatch.setattr(streamed_update, "DEFAULT_CHUNK_ELEMS", 1024)
    ref, want = resident_adamw
    engine = _engine(tree, _with(ENGINE_CONFIG, VARIANTS[variant]))
    assert engine.zero_optimization_stage() == VARIANTS[variant]["stage"]
    assert _train(engine, [1, 2, 3, 4, 5]) == want
    _same_run(engine, ref)
    offloaded = variant.startswith(("cpu", "twin"))
    assert (engine._offload is not None) == offloaded
    if offloaded:
        assert len(engine._offload.pieces) > len(engine.params)
        assert engine._offload.pinned_bytes() > 0


FAMILY = {
    "FusedAdam": {"lr": 3e-3, "weight_decay": 0.1},
    "FusedLamb": {"lr": 3e-3, "weight_decay": 0.1},
    "Lamb": {"lr": 3e-3, "weight_decay": 0.1},
    "Lion": {"lr": 1e-4, "weight_decay": 0.1},
    "FusedLion": {"lr": 1e-4},
    "Adagrad": {"lr": 1e-2},
    "FusedAdagrad": {"lr": 1e-2, "weight_decay": 0.1},
    "SGD": {"lr": 1e-2, "momentum": 0.9},
    "Muon": {"lr": 3e-3},
}


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_every_optimizer_streams_bit_for_bit(tree, name, monkeypatch):
    monkeypatch.setattr(streamed_update, "DEFAULT_CHUNK_ELEMS", 2048)
    config = {"train_batch_size": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": name, "params": FAMILY[name]}}
    ref = _engine(tree, config)
    want = _train(ref, [1, 2, 3])
    for zero in (CPU_OFFLOAD, TWIN_FLOW):
        engine = _engine(tree, _with(config, zero))
        assert _train(engine, [1, 2, 3]) == want, zero
        _same_run(engine, ref)
        modes = {p.leaf.elementwise for p in engine._offload.pieces}
        if name in ("Lamb", "FusedLamb"):
            assert modes == {False}       # a norm over the whole leaf


# --------------------------------------------------------------------- #
# Against the JAX engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("which,zero", [("cpu", CPU_OFFLOAD),
                                        ("twin", TWIN_FLOW)])
def test_offload_matches_the_jax_engine(tree, jax_offload_runs, which, zero):
    engine = _engine(tree, _with(ENGINE_CONFIG, zero))
    batch = {"input_ids": torch.from_numpy(_tokens(3)).long()}
    losses = [float(engine.train_batch(batch)) for _ in range(5)]
    np.testing.assert_allclose(losses, jax_offload_runs[which], rtol=1e-5)
    if which == "twin":
        ours = engine._offload_prefetcher.stats()
        assert ours["arms"] == jax_offload_runs["twin_stats"]["arms"] == 5
        assert ours["failures"] == 0 and ours["bytes_staged"] > 0


@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.7])
def test_twin_flow_split_matches_jax(tree, ratio):
    shapes = {k: tuple(v.shape) for k, v in _flat(tree).items()}
    for name, shape in shapes.items():
        want = jax_twin_flow._plan_leaf(shape, ratio, None)
        got = twin_flow.plan_leaf(shape, ratio)
        assert (got.axis, got.n_dev, got.n_host, got.scalar) == \
            (want.axis, want.n_dev, want.n_host, want.scalar), name
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:1],
                           force=True)
    try:
        params = jax.tree.map(jnp.asarray, tree)
        inner = optax.adamw(1e-3, weight_decay=0.1)
        _, _, jax_split = jax_twin_flow.build_twin_flow(
            inner, ratio, params, ZeroShardingPlan(topo, 3), topo.mesh)
        scalars = sum(x.dtype.itemsize for x in jax.tree.leaves(
            jax.eval_shape(inner.init, params)) if x.ndim == 0)
    finally:
        reset_topology()
    jax_dev, jax_host = jax_split()
    engine = _engine(tree, _with(ENGINE_CONFIG, {
        "stage": 2, "offload_optimizer": {"device": "cpu", "ratio": ratio}}))
    # the JAX state holds its int32 step counts on the device; the port
    # keeps the update count as a Python int
    assert engine._offload.pinned_bytes() == jax_host
    assert twin_flow.byte_split(
        [(s, 4) for s in shapes.values() for _ in range(2)], ratio) == \
        (jax_dev - scalars, jax_host)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# --------------------------------------------------------------------- #
# The prefetcher
# --------------------------------------------------------------------- #
def test_prefetch_failure_reads_the_host_state_unstaged(tree, monkeypatch,
                                                        resident_adamw):
    _, want = resident_adamw
    monkeypatch.setenv(port_injection.ENV_VAR,
                       "site=offload_prefetch,kind=offload,times=1")
    port_injection.clear()
    try:
        engine = _engine(tree, _with(ENGINE_CONFIG, TWIN_FLOW))
        assert _train(engine, [1, 2, 3, 4, 5]) == want
        stats = engine._offload_prefetcher.stats()
        assert stats["failures"] == 1 and stats["arms"] == 4
        assert stats["bytes_staged"] > 0
    finally:
        port_injection.clear()


# --------------------------------------------------------------------- #
# offload_states / reload_states
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("device,zero", [("cpu", None), ("nvme", None),
                                         ("cpu", TWIN_FLOW),
                                         ("nvme", CPU_OFFLOAD)])
def test_offload_states_round_trip(tree, resident_adamw, tmp_path, device,
                                   zero):
    _, want = resident_adamw
    engine = _engine(tree, _with(ENGINE_CONFIG, zero))
    assert _train(engine, [1, 2, 3]) == want[:3]
    first = next(iter(engine.params.values()))
    engine.offload_states(include=("optimizer", "params"), device=device,
                          nvme_path=str(tmp_path))
    assert first.numel() == 0 or first.untyped_storage().nbytes() == 0
    if device == "nvme":
        assert any(f.endswith(".swp") for _, _, files in os.walk(tmp_path)
                   for f in files)
    with pytest.raises(RuntimeError, match="reload_states"):
        _train(engine, [4])
    with pytest.raises(RuntimeError, match="reload_states"):
        engine.save_checkpoint(str(tmp_path / "ck"))
    engine.reload_states()
    assert not any(os.scandir(tmp_path))   # the swap folder is gone
    assert _train(engine, [4, 5]) == want[3:]


def test_offload_states_refuses_unknown_groups(tree):
    engine = _engine(tree, ENGINE_CONFIG)
    with pytest.raises(ValueError, match="cannot offload"):
        engine.offload_states(include=("activations",))
    with pytest.raises(ValueError, match="'cpu' or 'nvme'"):
        engine.offload_states(device="disk")


def test_pinned_empty_takes_exactly_its_bytes(monkeypatch):
    """``pinned_empty`` asks ``cudaHostAlloc`` for the tensor's own bytes
    (no power-of-two rounding) and frees them, after the device is done,
    when the last tensor on them goes (a view keeps them); a failed
    allocation raises."""
    import ctypes
    import gc

    from deepspeed_tpu_torch.runtime.swap_tensor import pinned

    calls, blocks = [], {}

    class FakeCudart:
        def cudaHostAlloc(self, pptr, nbytes, flags):
            if nbytes.value == 12:
                return 2
            buf = ctypes.create_string_buffer(nbytes.value)
            blocks[ctypes.addressof(buf)] = buf
            pptr._obj.value = ctypes.addressof(buf)
            calls.append(("alloc", nbytes.value))
            return 0

        def cudaFreeHost(self, ptr):
            calls.append(("free", ptr.value))
            return 0

    monkeypatch.setattr(pinned, "_cudart", lambda: FakeCudart())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(("sync",)))
    a = pinned.pinned_empty((3, 1000))
    b = pinned.pinned_empty((5,), torch.bfloat16)
    assert calls == [("alloc", 12000), ("alloc", 10)]
    assert a.shape == (3, 1000) and a.dtype == torch.float32
    assert b.shape == (5,) and b.dtype == torch.bfloat16
    a.fill_(2.5)
    ptr = a.data_ptr()
    assert ptr in blocks and float(a.sum()) == 7500.0
    view = a[1:]
    del a
    gc.collect()
    assert calls[2:] == []                 # the view keeps the memory
    del view
    gc.collect()
    assert calls[2:] == [("sync",), ("free", ptr)]
    with pytest.raises(RuntimeError, match="cudaHostAlloc"):
        pinned.pinned_empty((3,))          # 12 bytes: the fake fails
    assert pinned.pinned_empty((0, 4)).numel() == 0
    ptr = b.data_ptr()
    del b
    gc.collect()
    assert calls[-1] == ("free", ptr)


def test_swapper_keeps_bytes_and_dtypes(tmp_path):
    assert AsyncPartitionedParameterSwapper is AsyncTensorSwapper
    assert PartitionedOptimizerSwapper is AsyncTensorSwapper
    sw = AsyncTensorSwapper(str(tmp_path / "swap"))
    group = {"a": torch.randn(3, 5), "b/c": torch.randn(7).bfloat16(),
             "d": torch.arange(6, dtype=torch.int32).view(2, 3)}
    sw.swap_out("g", group)
    back = sw.swap_in("g")
    for k, t in group.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    into = {k: torch.zeros_like(t) for k, t in group.items()}
    sw.swap_in("g", into=into)
    assert all(torch.equal(into[k], group[k]) for k in group)
    assert sum(os.path.getsize(os.path.join(tmp_path / "swap", f))
               for f in os.listdir(tmp_path / "swap")) == 3 * 5 * 4 + 14 + 24
    sw.cleanup()
    assert not os.path.exists(tmp_path / "swap")


# --------------------------------------------------------------------- #
# Checkpoints across placements
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("save_zero,load_zero", [
    (TWIN_FLOW, None), (None, CPU_OFFLOAD), (CPU_OFFLOAD, TWIN_FLOW)])
def test_checkpoints_cross_placements(tree, resident_adamw, tmp_path,
                                      save_zero, load_zero):
    _, want = resident_adamw
    first = _engine(tree, _with(ENGINE_CONFIG, save_zero))
    _train(first, [1, 2])
    first.save_checkpoint(str(tmp_path))
    with open(tmp_path / "global_step2" / "index.json") as f:
        index = json.load(f)
    for name, p in first.params.items():
        leaves = index["params"][name.replace(".", "/")]["leaves"]
        assert leaves["exp_avg"]["shape"] == list(p.shape), name
    resumed = _engine(tree, _with(ENGINE_CONFIG, load_zero))
    resumed.load_checkpoint(str(tmp_path))
    assert _train(resumed, [3, 4, 5]) == want[2:]


def test_jax_twin_flow_tag_does_not_convert(tree, jax_offload_runs):
    """The JAX ``convert`` keys moments on ``mu/``/``nu/``: a Twin-Flow
    tag's ``TwinFlowState`` has both halves under those names, so each
    moment is exported as one half-leaf (the host half, written last),
    not the joined leaf. The port refuses to load it."""
    with open(os.path.join(jax_offload_runs["twin_universal"],
                           "index.json")) as f:
        index = json.load(f)
    halves = 0
    for name, rec in index["params"].items():
        shape = rec["leaves"]["param"]["shape"]
        lp = twin_flow.plan_leaf(tuple(shape), 0.5)
        if lp.n_host:
            want = list(shape)
            want[lp.axis] = lp.n_host
            assert rec["leaves"]["exp_avg"]["shape"] == want, name
            halves += 1
    assert halves == len(index["params"])
    engine = _engine(tree, ENGINE_CONFIG)
    with pytest.raises(ValueError, match="has shape"):
        engine.load_checkpoint(jax_offload_runs["twin_universal"])


# --------------------------------------------------------------------- #
# The client optimizer
# --------------------------------------------------------------------- #
CLIENT_CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
                 "gradient_clipping": 1.0}


def _adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, weight_decay=0.1,
                             foreach=False)


@pytest.fixture(scope="module")
def jax_client_losses(tree):
    losses, _ = _jax_losses(tree, CLIENT_CONFIG,
                            optimizer=optax.adamw(1e-3, weight_decay=0.1))
    return losses


def test_client_optimizer_matches_the_jax_engine(tree, jax_client_losses):
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=CausalLM(TransformerConfig.tiny(), params_from_numpy(
            tree, TransformerConfig.tiny()), trainable=True),
        config=CLIENT_CONFIG, optimizer=_adamw, device="cpu")
    assert isinstance(opt, ClientOptimizer)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    batch = {"input_ids": torch.from_numpy(_tokens(3)).long()}
    losses = [float(engine.train_batch(batch)) for _ in range(5)]
    np.testing.assert_allclose(losses, jax_client_losses, rtol=1e-5)
    assert opt.count == engine.global_steps == 5
    assert opt.current_lr() == 1e-3          # no config scheduler: its own


def test_client_optimizer_checkpoint_continues_bit_for_bit(tree, tmp_path):
    straight = _engine(tree, CLIENT_CONFIG, optimizer=_adamw)
    want = _train(straight, [1, 2, 3, 4])
    first = _engine(tree, CLIENT_CONFIG, optimizer=_adamw)
    _train(first, [1, 2])
    first.save_checkpoint(str(tmp_path))
    with open(tmp_path / "global_step2" / "index.json") as f:
        leaves = json.load(f)["params"]["embed/embedding"]["leaves"]
    assert {"param", "exp_avg", "exp_avg_sq", "step"} <= set(leaves)
    resumed = _engine(tree, CLIENT_CONFIG, optimizer=_adamw)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.optimizer.count == 2
    assert _train(resumed, [3, 4]) == want[2:]
    for name, p in straight.params.items():
        assert torch.equal(resumed.params[name], p), name


def test_client_optimizer_takes_the_config_schedule(tree):
    seen = []

    def factory(params):
        opt = torch.optim.SGD(params, lr=5.0)
        step = opt.step
        opt.step = lambda: (seen.append(opt.param_groups[0]["lr"]), step())
        return opt

    engine = _engine(tree, dict(CLIENT_CONFIG, scheduler=ENGINE_CONFIG[
        "scheduler"]), optimizer=factory)
    _train(engine, [1, 2, 3])
    assert seen == [engine._schedule_fn(i) for i in range(3)]
    assert seen[0] == 0.0 and seen[1] > 0


def test_client_optimizer_refusals(tree):
    with pytest.raises(TypeError, match="factory"):
        _engine(tree, CLIENT_CONFIG, optimizer=torch.optim.SGD(
            [torch.zeros(1, requires_grad=True)], lr=0.1))
    with pytest.raises(ValueError, match="client optimizer"):
        _engine(tree, _with(CLIENT_CONFIG, CPU_OFFLOAD), optimizer=_adamw)
