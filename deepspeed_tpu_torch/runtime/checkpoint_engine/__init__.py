"""Checkpoint persistence for the port (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine``)."""
from .checkpoint_engine import CheckpointEngine
from .numpy_checkpoint_engine import NumpyCheckpointEngine

__all__ = ["CheckpointEngine", "NumpyCheckpointEngine"]
