"""The data-parallel topology of the PyTorch port (counterpart of the part of
``deepspeed_tpu/runtime/topology.py`` a data-parallel world needs).

The JAX package builds one ``jax.sharding.Mesh`` whose named axes are the
DeepSpeed groups. The port's world is one ``torch.distributed`` group
(``deepspeed_tpu_torch.comm``), and its only axis with more than one
member is ``data``: its extent is the world size, and a rank's data index
is its rank, as the JAX mesh puts device r at data index r. Pipeline,
tensor, sequence and expert parallelism (M9) and the MiCS/hpZ shard
groups of ``zero_shard_size`` (M6) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .. import comm

PIPE = "pipe"
DATA_OUTER = "data_outer"
DATA = "data"
EXPERT = "expert"
SEQ = "seq"
TENSOR = "tensor"

#: Canonical outer→inner axis order (the JAX package's).
AXIS_ORDER: Tuple[str, ...] = (PIPE, DATA_OUTER, DATA, EXPERT, SEQ, TENSOR)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Parallelism degrees; ``data=-1`` takes the whole world."""

    pipe: int = 1
    data: int = -1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    zero_shard_size: int = -1

    def resolve(self, world_size: int) -> Dict[str, int]:
        for axis in (PIPE, EXPERT, SEQ, TENSOR):
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"{axis}={getattr(self, axis)}: the port's topology is "
                    f"data-parallel only; {axis} parallelism is not ported "
                    f"yet (ROADMAP M9)")
        if self.zero_shard_size > 0:
            raise NotImplementedError(
                "zero_shard_size (MiCS/hpZ shard groups) is not ported yet "
                "(ROADMAP M6)")
        data = world_size if self.data == -1 else self.data
        if data != world_size:
            raise ValueError(f"data={self.data} but the world has "
                             f"{world_size} processes")
        return {PIPE: 1, DATA_OUTER: 1, DATA: data, EXPERT: 1, SEQ: 1,
                TENSOR: 1}


class MeshTopology:
    """The world as the JAX ``MeshTopology`` names it: ``dims`` by axis,
    and this rank's index on the data axis."""

    def __init__(self, config: Optional[TopologyConfig] = None):
        self.config = config or TopologyConfig()
        self.dims = self.config.resolve(comm.get_world_size())
        self.data_index = comm.get_rank()

    def get_data_parallel_world_size(self) -> int:
        return self.dims[DATA]

    def __repr__(self) -> str:  # pragma: no cover
        return f"MeshTopology({self.dims}, data_index={self.data_index})"


_TOPOLOGY: Optional[MeshTopology] = None


def initialize_mesh(config: Optional[TopologyConfig] = None,
                    force: bool = False) -> MeshTopology:
    """Create (or return) the process's topology over the current world."""
    global _TOPOLOGY
    if _TOPOLOGY is None or force:
        _TOPOLOGY = MeshTopology(config)
    return _TOPOLOGY


def get_topology() -> MeshTopology:
    return _TOPOLOGY if _TOPOLOGY is not None else initialize_mesh()


def reset_topology() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None
