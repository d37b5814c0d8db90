"""The universal checkpoint layout's naming (counterpart of
``deepspeed_tpu/checkpoint/universal``). The layout manifest, the
resharding planner and loader wait for ZeRO on more than one device
(ROADMAP M6): on one device there is nothing to reshard."""
from .layout import SEP, param_name, universal_name

__all__ = ["SEP", "param_name", "universal_name"]
