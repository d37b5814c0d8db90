"""Collectives facade over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm``)."""
from .backend import Backend, TorchBackend
from .comm import (
    ReduceOp,
    all_gather_into_tensor,
    all_reduce,
    all_to_all_single,
    barrier,
    broadcast,
    comm_record,
    destroy_process_group,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    reduce_scatter_tensor,
    reset_comm_record,
)

__all__ = [n for n in dir() if not n.startswith("_")]
