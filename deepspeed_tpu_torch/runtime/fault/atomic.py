"""Crash-safe file writes (the port's copy of
``deepspeed_tpu/runtime/fault/atomic.py``).

Everything durable the checkpoints write besides the arrays (the
``latest`` pointer, the commit history, ``index.json``, ``meta.json``, the
manifest) goes through :func:`atomic_write_text`: a tmp file in the target
directory, flush + ``os.fsync``, ``os.replace`` (atomic on POSIX), then a
best-effort fsync of the directory so the rename itself survives power
loss. A reader sees either the old content or the new, never half.
"""
from __future__ import annotations

import os
import uuid


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (persists a rename within it)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp + fsync + ``os.replace``).

    The tmp file is created with mode 0o666 minus the umask and a uuid
    suffix, so writers sharing a store never truncate each other's tmp."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{uuid.uuid4().hex}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path))
