"""Fused Adam/AdamW (K5), Lion (K14) and Adagrad (K15) for the port
(counterpart of ``deepspeed_tpu/ops/adam``)."""
from .fused_adam import (
    fused_adagrad_update,
    fused_adagrad_update_reference,
    fused_adam_update,
    fused_adam_update_reference,
    fused_lion_update,
    fused_lion_update_reference,
    multi_tensor_apply,
)

__all__ = ["fused_adam_update", "fused_adam_update_reference",
           "fused_lion_update", "fused_lion_update_reference",
           "fused_adagrad_update", "fused_adagrad_update_reference",
           "multi_tensor_apply"]
