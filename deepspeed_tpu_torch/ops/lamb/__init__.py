"""Fused LAMB (K13) for the port (counterpart of
``deepspeed_tpu/ops/lamb``)."""
from .fused_lamb import (
    fused_lamb_update,
    fused_lamb_update_reference,
    lamb_raw_reference,
)

__all__ = ["fused_lamb_update", "fused_lamb_update_reference",
           "lamb_raw_reference"]
