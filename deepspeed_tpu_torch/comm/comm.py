"""``deepspeed_tpu_torch.comm`` — the collectives facade over
``torch.distributed`` (counterpart of ``deepspeed_tpu/comm/comm.py``).

The JAX facade's collectives are ``jax.lax`` primitives over named mesh
axes inside ``shard_map``; here each is one ``torch.distributed`` call over
the process group of :func:`init_distributed`, which is the port's data
axis (tensor, pipeline, sequence and expert groups are M9). Without an
initialised group the world is one process and every collective is the
identity, as the JAX facade returns its input over an axis of size 1.

The collectives are functional, as the JAX ones are, except
:func:`all_reduce` and :func:`broadcast`, which work in place (the
gradients they carry are the largest tensors of a step) and return their
tensor. Splits and gathers are along dim 0, in rank order:

  * :func:`all_gather_into_tensor` — ``lax.all_gather(tiled=True)``;
  * :func:`reduce_scatter_tensor` — ``lax.psum_scatter(tiled=True)``;
  * :func:`all_to_all_single` — ``lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``: chunk i goes to rank i.

Every collective that runs on a world larger than one appends its op,
dtype and operand bytes to the process's record (:func:`comm_record`),
the port's counterpart of the JAX ``fused_wire.wire_ops`` jaxpr walk.

A gloo group takes CUDA tensors for every collective here (torch 2.11,
two ranks on one H100: ``chip_smoke.py``'s world runs them on ``cuda:0``),
so nothing is staged through the host by the facade; gloo itself moves
the bytes through host memory.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .backend import TorchBackend


class ReduceOp(enum.Enum):
    SUM = 0
    AVG = 1
    MIN = 3
    MAX = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}

cdb: Optional[TorchBackend] = None   # "communication data backend"
_record: List[Dict] = []


# --------------------------------------------------------------------- #
# Process-level API
# --------------------------------------------------------------------- #
def init_distributed(dist_backend: str, init_method: str = "env://",
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (a no-op when already joined).

    ``dist_backend`` is ``"nccl"`` when each rank has its own GPU and
    ``"gloo"`` otherwise; it is never chosen for the caller. Give
    ``init_method`` (``tcp://localhost:<port>``, ``file://<path>``) with
    ``world_size`` and ``rank``, or ``"env://"`` with ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set."""
    global cdb
    if cdb is not None and cdb.is_initialized():
        return
    backend = TorchBackend(dist_backend)
    backend.init_process_group(init_method=init_method, world_size=world_size,
                               rank=rank, timeout_s=timeout_s)
    cdb = backend
    logger.info(f"comm: rank {get_rank()} of {get_world_size()} joined "
                f"({dist_backend})")


def is_initialized() -> bool:
    return cdb is not None and cdb.is_initialized()


def get_rank() -> int:
    return cdb.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return cdb.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    """This process's rank on its host. The port's worlds are one host, so
    it is the rank."""
    return get_rank()


def destroy_process_group() -> None:
    global cdb
    if cdb is not None:
        cdb.destroy_process_group()
        cdb = None


# --------------------------------------------------------------------- #
# The record (the wire_ops counterpart)
# --------------------------------------------------------------------- #
def comm_record() -> List[Dict]:
    """This process's collectives since the last reset, in call order:
    ``{"op", "dtype", "bytes"}`` each (``bytes``: the operand's,
    as ``wire_ops`` counts them)."""
    return list(_record)


def reset_comm_record() -> None:
    _record.clear()


def _note(op: str, tensor: torch.Tensor) -> None:
    _record.append({"op": op, "dtype": str(tensor.dtype).split(".")[-1],
                    "bytes": tensor.numel() * tensor.element_size()})


# --------------------------------------------------------------------- #
# Collectives over the world
# --------------------------------------------------------------------- #
def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM
               ) -> torch.Tensor:
    """Reduce over the world in place; AVG is the SUM divided by the world
    size (gloo has no AVG). → ``tensor``."""
    n = get_world_size()
    if n == 1:
        return tensor
    _note("all_reduce", tensor)
    dist.all_reduce(tensor, op=_TORCH_OPS[op])
    if op == ReduceOp.AVG:
        tensor.div_(n)
    return tensor


def all_gather_into_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 in rank order."""
    n = get_world_size()
    if n == 1:
        return tensor
    tensor = tensor.contiguous()
    _note("all_gather_into_tensor", tensor)
    out = tensor.new_empty((n * tensor.shape[0],) + tuple(tensor.shape[1:]))
    dist.all_gather_into_tensor(out, tensor)
    return out


def _check_split(op: str, tensor: torch.Tensor, n: int) -> torch.Tensor:
    if tensor.shape[0] % n:
        raise ValueError(f"{op}: dim 0 ({tensor.shape[0]}) does not divide "
                         f"by the world size {n}")
    return tensor.contiguous()


def reduce_scatter_tensor(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM
                          ) -> torch.Tensor:
    """Reduce over the world and keep this rank's chunk of dim 0 (which
    must divide by the world size)."""
    n = get_world_size()
    if n == 1:
        return tensor
    tensor = _check_split("reduce_scatter_tensor", tensor, n)
    _note("reduce_scatter_tensor", tensor)
    out = tensor.new_empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]))
    dist.reduce_scatter_tensor(out, tensor, op=_TORCH_OPS[op])
    if op == ReduceOp.AVG:
        out.div_(n)
    return out


def all_to_all_single(tensor: torch.Tensor) -> torch.Tensor:
    """Split dim 0 into world-size chunks, send chunk i to rank i, and
    concatenate what arrives in rank order (dim 0 must divide by the world
    size)."""
    n = get_world_size()
    if n == 1:
        return tensor
    tensor = _check_split("all_to_all_single", tensor, n)
    _note("all_to_all_single", tensor)
    out = torch.empty_like(tensor)
    dist.all_to_all_single(out, tensor)
    return out


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place. → ``tensor``."""
    if get_world_size() == 1:
        return tensor
    _note("broadcast", tensor)
    dist.broadcast(tensor, src)
    return tensor


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()
