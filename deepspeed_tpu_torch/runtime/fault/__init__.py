"""Checkpoint integrity and fault injection for the port (counterpart of
the ``manifest``/``atomic``/``injection`` part of
``deepspeed_tpu/runtime/fault``); retry and the watchdog are ROADMAP
M11."""
from .atomic import atomic_write_text, fsync_dir
from .manifest import (CheckpointCorruptError, is_valid_checkpoint,
                       read_manifest, verify_checkpoint, write_manifest)

__all__ = ["atomic_write_text", "fsync_dir", "CheckpointCorruptError",
           "is_valid_checkpoint", "read_manifest", "verify_checkpoint",
           "write_manifest"]
