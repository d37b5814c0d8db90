"""Checkpoint engine ABC (the port's copy of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``):
the persistence backend behind the engine's save and load. The port's one
implementation is :class:`~.numpy_checkpoint_engine.NumpyCheckpointEngine`.
"""
from __future__ import annotations

import abc
from typing import Any, Optional


class CheckpointEngine(abc.ABC):
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir

    @abc.abstractmethod
    def save(self, payload: Any, tag: str) -> None:
        ...

    @abc.abstractmethod
    def load(self, template: Any, tag: str) -> Any:
        ...

    @abc.abstractmethod
    def commit(self, tag: str) -> None:
        """Mark ``tag`` durable and update the ``latest`` pointer."""

    @abc.abstractmethod
    def latest_tag(self) -> Optional[str]:
        ...
