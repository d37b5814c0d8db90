"""Communication backend for the PyTorch port (counterpart of
``deepspeed_tpu/comm/backend.py``).

The JAX package has one real backend, XLA collectives over named mesh
axes. The port's is ``torch.distributed`` with an explicit process-group
backend: ``"nccl"`` when each rank has its own GPU, ``"gloo"`` otherwise
(several ranks sharing one GPU, or CPU tensors). Nothing switches from
one to the other on failure.
"""
from __future__ import annotations

import abc
import datetime
from typing import Optional

import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class Backend(abc.ABC):
    def __init__(self, name: str):
        self.name = name
        self.initialized = False

    def is_initialized(self) -> bool:
        return self.initialized

    @abc.abstractmethod
    def init_process_group(self, **kwargs) -> None:
        ...

    @abc.abstractmethod
    def get_rank(self) -> int:
        ...

    @abc.abstractmethod
    def get_world_size(self) -> int:
        ...

    @abc.abstractmethod
    def destroy_process_group(self) -> None:
        ...


class TorchBackend(Backend):
    """One ``torch.distributed`` world: the port's data-parallel group.

    ``init_method`` is any URL ``torch.distributed`` takes
    (``tcp://localhost:<port>``, ``file://<path>``, ``env://``);
    ``world_size`` and ``rank`` are given by the caller."""

    def __init__(self, name: str):
        if name not in BACKENDS:
            raise ValueError(f"dist_backend must be one of {BACKENDS} "
                             f"('nccl': one GPU per rank; 'gloo': ranks "
                             f"sharing a GPU, or the CPU), got {name!r}")
        super().__init__(name)

    def init_process_group(self, init_method: str = "env://",
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = 600.0) -> None:
        kwargs = {}
        if world_size is not None:
            kwargs["world_size"] = int(world_size)
        if rank is not None:
            kwargs["rank"] = int(rank)
        dist.init_process_group(
            self.name, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        self.initialized = True

    def get_rank(self) -> int:
        return dist.get_rank()

    def get_world_size(self) -> int:
        return dist.get_world_size()

    def destroy_process_group(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        self.initialized = False
