"""The port's collectives facade, topology and local-world launcher on gloo
worlds of CPU processes; and the rank-side functions that the port's
multi-process parity tests hand to those worlds.

A world is spawned with ``launcher.run_local_world`` (the ``spawn`` start
method, a file store under the test's tmp dir, one thread a rank). Its
ranks import only ``torch``, ``numpy`` and the port: this module imports
nothing of JAX, so the JAX-side tests import their rank functions from
here.
"""
import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.launcher import run_local_world
from deepspeed_tpu_torch.runtime import topology as topo

pytestmark = pytest.mark.torch_port


# --------------------------------------------------------------------- #
# Rank-side functions (module level: the spawned ranks import them)
# --------------------------------------------------------------------- #
def _to_numpy(out):
    """Tensors → numpy (bfloat16, which numpy lacks, exactly as float32)."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(o) for o in out)
    return out


def run_calls(rank, calls):
    """Each call is ``(fn, rank_args, kwargs, rank_kwargs)``: ``fn`` names
    a function of the port (``"module.path:name"`` under
    ``deepspeed_tpu_torch``); each array of ``rank_args`` (positional) and
    ``rank_kwargs`` (by name) holds one row per rank, of which this rank
    passes its own. → ``[(output as numpy, the facade's record)]``."""
    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(a[rank]))

    out = []
    for fn, rank_args, kwargs, rank_kwargs in calls:
        mod, name = fn.split(":")
        f = getattr(importlib.import_module(f"deepspeed_tpu_torch.{mod}"),
                    name)
        args = [mine(a) for a in rank_args]
        kw = dict(kwargs, **{k: mine(a) for k, a in rank_kwargs.items()})
        comm.reset_comm_record()
        res = f(*args, **kw)
        out.append((_to_numpy(res), comm.comm_record()))
    return out


def train_runs(rank, tree, configs, batches, ckpt_dir):
    """For each config, ``train_batch`` on every batch with the port's
    tiny CausalLM from the numpy weights ``tree``, on this data-parallel
    world. → per config: losses, final masters, each step's record, the
    LoCo residuals' total magnitude per leaf, the counters, the data-mean
    ``eval_batch`` loss of the first batch, and what ``backward()``
    raised; then a save (rank 0 writes) and a load on every
    rank of the last engine."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import CausalLM, TransformerConfig
    from deepspeed_tpu_torch.models.convert import params_from_numpy

    cfg = TransformerConfig.tiny()
    out = []
    for config in configs:
        model = CausalLM(cfg, params_from_numpy(tree, cfg), trainable=True)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu")
        losses, records = [], []
        for b in batches:
            comm.reset_comm_record()
            losses.append(float(engine.train_batch(
                {"input_ids": torch.from_numpy(b).long()})))
            records.append(comm.comm_record())
        evaluated = float(engine.eval_batch(
            {"input_ids": torch.from_numpy(batches[0]).long()}))
        try:
            engine.backward({"input_ids": torch.from_numpy(batches[0][:1])})
            refused = None
        except NotImplementedError as e:
            refused = str(e)
        loco = {k: float(e["worker"].abs().sum() + e["server"].abs().sum())
                for k, e in (engine.comm_error or {}).items()}
        out.append({"losses": losses, "records": records, "loco": loco,
                    "params": {k: v.detach().numpy().copy()
                               for k, v in engine.params.items()},
                    "steps": (engine.global_steps, engine.micro_steps,
                              engine.dp_world_size, engine.dp_rank),
                    "eval": evaluated, "refused": refused})
    before = {k: v.detach().clone() for k, v in engine.params.items()}
    engine.save_checkpoint(ckpt_dir, tag="world")
    with torch.no_grad():
        for p in engine.params.values():
            p.zero_()
    path, _ = engine.load_checkpoint(ckpt_dir, tag="world")
    out.append({"loaded": path is not None and all(
        torch.equal(before[k], engine.params[k]) for k in before)})
    return out


def _facade_checks(rank):
    n = comm.get_world_size()
    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    res = {"rank": comm.get_rank(), "n": n,
           "local_rank": comm.get_local_rank(),
           "backend": comm.comm.cdb.name}
    comm.reset_comm_record()
    res["sum"] = comm.all_reduce(x.clone()).numpy()
    res["avg"] = comm.all_reduce(x.clone(), comm.ReduceOp.AVG).numpy()
    res["max"] = comm.all_reduce(x.clone(), comm.ReduceOp.MAX).numpy()
    res["gather"] = comm.all_gather_into_tensor(x.view(2, 3)).numpy()
    res["rs"] = comm.reduce_scatter_tensor(
        torch.arange(3 * n, dtype=torch.float32) * (rank + 1)).numpy()
    res["a2a"] = comm.all_to_all_single(
        (torch.arange(2 * n, dtype=torch.int8) + 20 * rank).view(n, 2)
    ).numpy()
    res["bcast"] = comm.broadcast(x.clone(), src=n - 1).numpy()
    comm.barrier()
    res["record"] = comm.comm_record()
    t = topo.initialize_mesh(force=True)
    res["dims"] = dict(t.dims)
    res["data_index"] = t.data_index
    with pytest.raises(ValueError, match="divide"):
        comm.all_to_all_single(torch.ones(n + 1))
    return res


def _fail_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("planted failure")
    comm.barrier()                   # rank 0 waits here until it is killed
    return rank


# --------------------------------------------------------------------- #
# Tests
# --------------------------------------------------------------------- #
def test_facade_collectives_on_a_gloo_world(tmp_path):
    """Every collective of the facade on a world of 3, against its
    definition; the record holds op, dtype and operand bytes."""
    n = 3
    res = run_local_world(_facade_checks, n, store_dir=str(tmp_path))
    xs = [np.arange(6, dtype=np.float32) + 10 * r for r in range(n)]
    for r, got in enumerate(res):
        assert (got["rank"], got["n"], got["local_rank"],
                got["backend"]) == (r, n, r, "gloo")
        np.testing.assert_array_equal(got["sum"], sum(xs))
        np.testing.assert_array_equal(got["avg"], sum(xs) / n)
        np.testing.assert_array_equal(got["max"], xs[-1])
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([x.reshape(2, 3) for x in xs]))
        full = sum(np.arange(3 * n, dtype=np.float32) * (q + 1)
                   for q in range(n))
        np.testing.assert_array_equal(got["rs"], full[3 * r:3 * r + 3])
        sent = [(np.arange(2 * n) + 20 * q).astype(np.int8).reshape(n, 2)
                for q in range(n)]
        np.testing.assert_array_equal(got["a2a"],
                                      np.stack([s[r] for s in sent]))
        np.testing.assert_array_equal(got["bcast"], xs[-1])
        assert [(e["op"], e["dtype"], e["bytes"]) for e in got["record"]] \
            == [("all_reduce", "float32", 24)] * 3 + [
                ("all_gather_into_tensor", "float32", 24),
                ("reduce_scatter_tensor", "float32", 12 * n),
                ("all_to_all_single", "int8", 2 * n),
                ("broadcast", "float32", 24)]
        assert got["dims"]["data"] == n and got["data_index"] == r
        assert all(got["dims"][a] == 1 for a in topo.AXIS_ORDER
                   if a != "data")


def test_a_world_of_one_is_the_identity():
    """Without a process group the world is this process: every
    collective returns its input and nothing is recorded."""
    assert not comm.is_initialized()
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    comm.reset_comm_record()
    x = torch.arange(4.0)
    for out in (comm.all_reduce(x), comm.all_gather_into_tensor(x),
                comm.reduce_scatter_tensor(x), comm.all_to_all_single(x),
                comm.broadcast(x)):
        assert out is x
    comm.barrier()
    assert comm.comm_record() == []
    t = topo.MeshTopology()
    assert t.dims["data"] == 1 and t.data_index == 0


def test_backend_is_explicit():
    with pytest.raises(ValueError, match="nccl"):
        comm.init_distributed("mpi", init_method="file:///nonexistent")
    assert not comm.is_initialized()


def test_topology_refuses_what_is_not_ported():
    for axis in ("pipe", "tensor", "seq", "expert"):
        with pytest.raises(NotImplementedError, match="M9"):
            topo.TopologyConfig(**{axis: 2}).resolve(2)
    with pytest.raises(NotImplementedError, match="M6"):
        topo.TopologyConfig(zero_shard_size=2).resolve(4)
    with pytest.raises(ValueError, match="world"):
        topo.TopologyConfig(data=4).resolve(2)
    assert topo.TopologyConfig().resolve(4)["data"] == 4
    topo.reset_topology()
    assert topo.get_topology().dims["data"] == 1
    topo.reset_topology()


def test_a_failing_rank_fails_the_world(tmp_path):
    """One rank raising ends the world: its traceback is raised in the
    caller and the rank blocked in a collective is killed, not left to its
    timeout."""
    with pytest.raises(RuntimeError, match="planted failure"):
        run_local_world(_fail_on_rank_one, 2, store_dir=str(tmp_path),
                        timeout_s=120)
