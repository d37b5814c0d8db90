"""Launching the port's processes (counterpart of part of
``deepspeed_tpu/launcher``)."""
from .local import run_local_world

__all__ = ["run_local_world"]
