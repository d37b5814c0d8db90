"""Mixture of experts on one device (counterpart of
``deepspeed_tpu/moe/``)."""
from .layer import MoE
from .sharded_moe import (
    init_moe_params,
    moe_layer,
    moe_mlp_block,
    top1gating,
    top2gating,
    topkgating,
)

__all__ = ["MoE", "moe_layer", "moe_mlp_block", "init_moe_params",
           "top1gating", "top2gating", "topkgating"]
