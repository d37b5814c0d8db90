"""Checkpoint manifests: write-time integrity records, load-time
verification (the port's copy of ``deepspeed_tpu/runtime/fault/manifest.py``).

``manifest.json``, written last and atomically, records what a complete
checkpoint looks like, with the JAX package's fields:

  * the size of every file in the checkpoint directory,
  * the SHA-256 of ``meta.json`` (``meta_sha256``),
  * the sorted listing of the array files (here under ``zero/``, the
    universal layout's directory; the JAX package's tensorstore shards
    live under ``state/``) and its SHA-256,

and one more: the SHA-256 of every file (``sha256``), so a flipped byte in
an array file fails verification like a truncated one. Files are hashed
by a pool of threads (``hashlib`` releases the interpreter lock).

:func:`verify_checkpoint` replays the record and raises
:class:`CheckpointCorruptError` naming what diverged. A directory with no
manifest is accepted if it is not empty (a universal directory written by
the JAX package's ``convert`` carries none).
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional

from .atomic import atomic_write_text

MANIFEST_FILE = "manifest.json"
META_FILE = "meta.json"
STATE_DIR = "zero"
MANIFEST_VERSION = 1
HASH_WORKERS = 8


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (incomplete write,
    truncated or altered file, missing file, or a dangling ``latest``)."""


def sha256_file(path: str, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def sha256_files(root: str, rels: Iterable[str]) -> Dict[str, str]:
    """``{rel: sha256}`` of files under ``root``, hashed in parallel."""
    rels = list(rels)
    with ThreadPoolExecutor(HASH_WORKERS) as pool:
        digests = pool.map(lambda rel: sha256_file(os.path.join(root, rel)),
                           rels)
        return dict(zip(rels, digests))


def _walk_files(ckpt_path: str) -> List[str]:
    """Sorted relative paths of every file under ``ckpt_path`` except the
    manifest itself."""
    out = []
    for root, _dirs, files in os.walk(ckpt_path):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), ckpt_path)
            if rel != MANIFEST_FILE:
                out.append(rel)
    return sorted(out)


def _listing(files: List[str]) -> List[str]:
    return [f for f in files if f.split(os.sep, 1)[0] == STATE_DIR]


def build_manifest(ckpt_path: str, extra: Optional[Dict[str, Any]] = None,
                   sha256: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The integrity record for ``ckpt_path``. ``sha256`` holds digests the
    writer already computed; every other file is hashed here."""
    files = _walk_files(ckpt_path)
    digests = {f: d for f, d in (sha256 or {}).items() if f in files}
    digests.update(sha256_files(ckpt_path,
                                [f for f in files if f not in digests]))
    shards = _listing(files)
    manifest: Dict[str, Any] = {
        "version": MANIFEST_VERSION,
        "files": {f: os.path.getsize(os.path.join(ckpt_path, f))
                  for f in files},
        "sha256": {f: digests[f] for f in files},
        "shard_listing": shards,
        "shard_listing_sha256": hashlib.sha256(
            "\n".join(shards).encode()).hexdigest(),
    }
    if META_FILE in digests:
        manifest["meta_sha256"] = digests[META_FILE]
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(ckpt_path: str, extra: Optional[Dict[str, Any]] = None,
                   sha256: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Build and atomically persist the manifest; → it."""
    manifest = build_manifest(ckpt_path, extra, sha256)
    atomic_write_text(os.path.join(ckpt_path, MANIFEST_FILE),
                      json.dumps(manifest, indent=2, sort_keys=True))
    return manifest


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(ckpt_path, MANIFEST_FILE)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{ckpt_path}: unreadable manifest: {e}")


def verify_checkpoint(ckpt_path: str, require_manifest: bool = False
                      ) -> Optional[Dict[str, Any]]:
    """Verify ``ckpt_path`` against its manifest. → the manifest (None for
    a directory without one). Raises :class:`CheckpointCorruptError` on
    any divergence."""
    if not os.path.isdir(ckpt_path):
        raise CheckpointCorruptError(f"{ckpt_path}: checkpoint directory "
                                     f"missing")
    manifest = read_manifest(ckpt_path)
    if manifest is None:
        if require_manifest:
            raise CheckpointCorruptError(f"{ckpt_path}: no manifest")
        if not _walk_files(ckpt_path):
            raise CheckpointCorruptError(f"{ckpt_path}: empty checkpoint "
                                         f"directory")
        return None

    sizes = manifest.get("files", {})
    for rel, size in sizes.items():
        p = os.path.join(ckpt_path, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptError(f"{ckpt_path}: missing file {rel!r}")
        actual = os.path.getsize(p)
        if actual != size:
            raise CheckpointCorruptError(
                f"{ckpt_path}: size mismatch for {rel!r} "
                f"(manifest {size}, on disk {actual})")

    shards = _listing(_walk_files(ckpt_path))
    want = hashlib.sha256("\n".join(shards).encode()).hexdigest()
    if manifest.get("shard_listing_sha256") not in (None, want):
        raise CheckpointCorruptError(
            f"{ckpt_path}: array files added or removed under {STATE_DIR}/ "
            f"since save")

    recorded = dict(manifest.get("sha256", {}))
    if "meta_sha256" in manifest:
        if not os.path.exists(os.path.join(ckpt_path, META_FILE)):
            raise CheckpointCorruptError(f"{ckpt_path}: {META_FILE} missing")
        recorded[META_FILE] = manifest["meta_sha256"]
    try:
        actual = sha256_files(ckpt_path, recorded)
    except OSError as e:
        raise CheckpointCorruptError(f"{ckpt_path}: unreadable file: {e}")
    for rel, digest in sorted(recorded.items()):
        if actual[rel] != digest:
            raise CheckpointCorruptError(
                f"{ckpt_path}: content hash mismatch for {rel!r} "
                f"(altered, truncated or partially written)")
    return manifest


def is_valid_checkpoint(ckpt_path: str) -> bool:
    try:
        verify_checkpoint(ckpt_path)
        return True
    except CheckpointCorruptError:
        return False
