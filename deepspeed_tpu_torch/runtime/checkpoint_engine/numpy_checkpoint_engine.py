"""The port's checkpoint engine: a tag directory in the universal layout
(counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/
orbax_checkpoint_engine.py``, with the same surface and commit rules).

A tag directory ``<ckpt_dir>/<tag>/`` holds

  * ``index.json`` (version 2) and ``zero/<param>/<leaf>.npy`` — the
    universal layout of ``checkpoint/ds_to_universal.py``, so a tag
    directory is itself a universal directory that either package's
    ``load_universal`` reads;
  * ``meta.json`` — the engine's counters, loss scaler, lr scheduler and
    ``client_state`` (JSON);
  * ``manifest.json`` — written last: file sizes and SHA-256s
    (``runtime/fault/manifest.py``).

Leaves are copied to the host one at a time and written and hashed by a
pool of threads. ``commit`` verifies the tag and points ``latest`` at it
atomically (tmp + fsync + ``os.replace``), and appends it to
``commit_history``. ``latest_tag`` verifies before trusting: a dangling
or damaged ``latest`` falls back to the newest valid *committed* tag. The
JAX engine's retry with backoff and fault injection are ROADMAP M11; its
saves are asynchronous (``async_save``), these are synchronous; its
``verify_checkpoints: false`` and ``checkpoint_keep_last`` (fault config,
M11) are not offered: every tag is verified, and ``gc_tags`` is called
by hand.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...checkpoint.ds_to_universal import (INDEX_FILE, INDEX_VERSION,
                                           PARAM_FILE, UNIVERSAL_SUBDIR,
                                           _save_leaf, host_array,
                                           load_universal)
from ...utils.logging import logger
from ..fault.atomic import atomic_write_text
from ..fault.manifest import (META_FILE, CheckpointCorruptError,
                              is_valid_checkpoint, read_manifest, sha256_file,
                              verify_checkpoint, write_manifest)
from .checkpoint_engine import CheckpointEngine

LATEST_FILE = "latest"  # the reference's pointer-file convention
HISTORY_FILE = "commit_history"  # committed tags, oldest first
HISTORY_LIMIT = 100
WRITE_WORKERS = 8


def _jsonable(x: Any) -> Any:
    """``json.dumps`` default for ``meta.json``: tensors and numpy values
    as lists or numbers."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    raise TypeError(f"{type(x).__name__} is not JSON serialisable")


def _write_leaf(root: str, rel_dir: str, fname: str, arr: np.ndarray,
                dtype: str):
    """Write one leaf and hash what landed on disk. → (relative path,
    sha256)."""
    _save_leaf(os.path.join(root, rel_dir), fname, arr, dtype)
    rel = os.path.join(rel_dir, fname + ".npy")
    return rel, sha256_file(os.path.join(root, rel))


class NumpyCheckpointEngine(CheckpointEngine):
    def __init__(self, ckpt_dir: str):
        super().__init__(os.path.abspath(ckpt_dir))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._verified_tags: set = set()   # tags this instance verified

    def _path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, str(tag))

    # -------------------------------------------------------------- #
    def save(self, payload: Dict[str, Any], tag: str) -> None:
        """Write ``payload`` as tag ``tag`` (a tag saved again is replaced):
        ``{"leaves": {universal name: {leaf name: tensor}}, "meta": dict,
        "step": int}``; the leaf ``"param"`` is the master (``fp32.npy``)."""
        path = self._path(tag)
        if os.path.isdir(path):
            shutil.rmtree(path)
        index: Dict[str, Any] = {"version": INDEX_VERSION,
                                 "source_tag": str(tag),
                                 "step": int(payload.get("step", 0)),
                                 "params": {}}
        with ThreadPoolExecutor(WRITE_WORKERS) as pool:
            jobs = []
            for name, leaves in payload["leaves"].items():
                rel_dir = os.path.join(UNIVERSAL_SUBDIR,
                                       name.replace("/", "."))
                os.makedirs(os.path.join(path, rel_dir))
                recs = {}
                for lname, t in leaves.items():
                    arr, dtype = host_array(t)    # the device → host copy
                    fname = PARAM_FILE if lname == "param" else lname
                    recs[lname] = {"file": fname + ".npy", "dtype": dtype,
                                   "shape": list(arr.shape)}
                    jobs.append(pool.submit(_write_leaf, path, rel_dir, fname,
                                            arr, dtype))
                index["params"][name] = {"leaves": recs}
            digests = dict(job.result() for job in jobs)
        atomic_write_text(os.path.join(path, INDEX_FILE),
                          json.dumps(index, indent=1, sort_keys=True))
        atomic_write_text(os.path.join(path, META_FILE),
                          json.dumps(payload.get("meta", {}),
                                     default=_jsonable))
        # written last: its presence certifies a complete checkpoint
        write_manifest(path, extra={"tag": str(tag), "step": _tag_step(tag)},
                       sha256=digests)
        self._verified_tags.add(str(tag))

    def load(self, template: Any, tag: str) -> Dict[str, Any]:
        """Read tag ``tag``, verified first (once per instance). The index
        describes every leaf, so ``template`` is not needed (the ABC's
        argument is kept). → ``{"leaves": {universal name: {leaf name:
        CPU tensor}}, "meta": dict or None, "step": int, "path": str}``;
        ``meta`` is None for a directory the JAX package's ``convert``
        wrote."""
        path = self._path(tag)
        if str(tag) not in self._verified_tags:
            verify_checkpoint(path)  # raises CheckpointCorruptError
            self._verified_tags.add(str(tag))
        index_path = os.path.join(path, INDEX_FILE)
        if not os.path.exists(index_path):
            raise CheckpointCorruptError(f"{path}: no {INDEX_FILE}")
        with open(index_path) as f:
            step = int(json.load(f).get("step", 0))
        meta = None
        if os.path.exists(os.path.join(path, META_FILE)):
            with open(os.path.join(path, META_FILE)) as f:
                meta = json.load(f)
        return {"leaves": load_universal(path, include_moments=True),
                "meta": meta, "step": step, "path": path}

    def commit(self, tag: str) -> None:
        """Point ``latest`` at ``tag`` — only after verifying it, and
        atomically, so a crashed committer never leaves a torn pointer."""
        if str(tag) not in self._verified_tags:
            verify_checkpoint(self._path(tag))
            self._verified_tags.add(str(tag))
        atomic_write_text(os.path.join(self.ckpt_dir, LATEST_FILE), str(tag))
        history = self.committed_tags()
        if not history or history[-1] != str(tag):
            history.append(str(tag))
            atomic_write_text(os.path.join(self.ckpt_dir, HISTORY_FILE),
                              "\n".join(history[-HISTORY_LIMIT:]) + "\n")

    def gc_tags(self, keep_last: int) -> List[str]:
        """Delete all but the newest ``keep_last`` valid tags. The tag
        ``latest`` points at and the newest valid tag are always kept;
        invalid directories are left alone (an in-flight save looks like
        one). → the deleted tags."""
        keep_last = int(keep_last)
        if keep_last <= 0:
            return []
        valid = self.valid_tags()          # newest first
        protected = set(valid[:keep_last])
        if valid:
            protected.add(valid[0])
        pointer = os.path.join(self.ckpt_dir, LATEST_FILE)
        if os.path.exists(pointer):
            with open(pointer) as f:
                pointed = f.read().strip()
            if pointed:
                protected.add(pointed)
        deleted: List[str] = []
        for tag in valid[keep_last:]:
            if tag in protected:
                continue
            try:
                shutil.rmtree(self._path(tag))
                deleted.append(tag)
                self._verified_tags.discard(str(tag))
            except OSError as e:
                logger.warning(f"checkpoint gc: could not delete "
                               f"{self._path(tag)}: {e}")
        if deleted:
            history = [t for t in self.committed_tags() if t not in deleted]
            atomic_write_text(os.path.join(self.ckpt_dir, HISTORY_FILE),
                              "\n".join(history[-HISTORY_LIMIT:]) + "\n")
            logger.info(f"checkpoint gc: deleted {len(deleted)} old tag(s) "
                        f"({deleted}), keeping newest {keep_last}")
        return deleted

    def committed_tags(self) -> List[str]:
        """Tags ever published by :meth:`commit`, oldest first (a save with
        ``save_latest=False`` is unpublished and never resumed from)."""
        p = os.path.join(self.ckpt_dir, HISTORY_FILE)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [line.strip() for line in f if line.strip()]

    # -------------------------------------------------------------- #
    def all_tags(self) -> List[str]:
        """Tag directories, newest first (by manifest step, then the
        directory's mtime)."""
        tags = [t for t in os.listdir(self.ckpt_dir)
                if os.path.isdir(self._path(t))]

        def key(t):
            m = None
            try:
                m = read_manifest(self._path(t))
            except CheckpointCorruptError:
                pass
            step = (m or {}).get("step")
            if step is None:
                step = _tag_step(t)
            return (step if step is not None else -1,
                    os.path.getmtime(self._path(t)))

        return sorted(tags, key=key, reverse=True)

    def valid_tags(self) -> List[str]:
        return [t for t in self.all_tags()
                if is_valid_checkpoint(self._path(t))]

    def _tag_ok(self, tag: str, require_manifest: bool = False) -> bool:
        """Is ``tag`` safe to hand out (verified)? ``require_manifest`` (the
        fallback scan) also rejects directories without a manifest: a save
        torn before its manifest looks like one."""
        try:
            verify_checkpoint(self._path(tag),
                              require_manifest=require_manifest)
        except CheckpointCorruptError:
            return False
        self._verified_tags.add(str(tag))
        return True

    def latest_tag(self) -> Optional[str]:
        """The committed tag — or, when the pointer dangles or its
        checkpoint is incomplete or damaged, the newest valid older
        committed tag (never an unpublished save)."""
        p = os.path.join(self.ckpt_dir, LATEST_FILE)
        pointed = None
        if os.path.exists(p):
            with open(p) as f:
                pointed = f.read().strip() or None
        if pointed is not None:
            if self._tag_ok(pointed):
                return pointed
            logger.warning(
                f"checkpoint {self.ckpt_dir}/{pointed} (the committed "
                f"'latest') is missing, incomplete, or damaged; scanning "
                f"for the newest valid older tag")
        for tag in reversed(self.committed_tags()):
            if tag == pointed:
                continue
            if self._tag_ok(tag, require_manifest=True):
                logger.warning(f"falling back to valid checkpoint "
                               f"{self.ckpt_dir}/{tag}")
                return tag
        return None


def _tag_step(tag) -> Optional[int]:
    """The step of a ``global_step{N}``-style tag: its trailing integer."""
    m = re.search(r"(\d+)\s*$", str(tag))
    return int(m.group(1)) if m else None
