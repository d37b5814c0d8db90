"""The universal checkpoint directory, read and exported by the port (its
own copy of ``deepspeed_tpu/checkpoint/ds_to_universal.py``).

A universal directory holds ``index.json`` (version 2) and, for every
parameter, ``zero/<name with '/' as '.'>/`` with ``fp32.npy`` and its
optimizer leaves (Adam's ``exp_avg.npy`` and ``exp_avg_sq.npy``; Lion's
``exp_avg``; Adagrad's ``sum_of_squares``). The index records each
leaf's file, dtype and shape: the dtype is re-applied on load, so
bfloat16 leaves survive ``.npy`` as their raw 2-byte words. This module
does not need ``ml_dtypes``: such a leaf is read as raw integers and
viewed as the torch dtype.

A tag directory of the port's checkpoints *is* a universal directory, so

  * :func:`load_universal` reads both a port tag directory and the
    directory the JAX package's ``convert`` writes, and the JAX package's
    own ``load_universal`` reads a port tag directory;
  * :func:`convert` exports a port checkpoint tag (verified against its
    integrity manifest first) as a stand-alone universal directory;
  * :func:`main` is its command line (``--input_folder``,
    ``--output_folder``, ``--tag``, ``--no_strict``, as in the JAX
    package).

Arrays come back as CPU torch tensors (numpy has no bfloat16 without
``ml_dtypes``). Only index version 2 is read: the JAX package's
pre-index (v1) exports are not.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

UNIVERSAL_SUBDIR = "zero"  # reference layout: <dir>/zero/<param>/fp32.npy
INDEX_FILE = "index.json"
INDEX_VERSION = 2
PARAM_FILE = "fp32"
LOAD_WORKERS = 8

BF16 = "bfloat16"  # numpy names it only through ml_dtypes


def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host ndarray of ``t`` and the dtype name to record; a bfloat16
    tensor becomes its raw 2-byte words (numpy ``V2``) recorded as
    ``bfloat16``, as the JAX package records it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), BF16
    a = t.numpy()
    return a, a.dtype.name


def _save_leaf(pdir: str, fname: str, arr: np.ndarray,
               dtype: Optional[str] = None) -> Dict[str, Any]:
    """Write one array; → its index record (``dtype`` defaults to the
    array's own)."""
    np.save(os.path.join(pdir, fname), arr)
    return {"file": fname + ".npy", "dtype": dtype or arr.dtype.name,
            "shape": list(arr.shape)}


def _load_leaf(pdir: str, rec: Dict[str, Any]) -> torch.Tensor:
    """One array with its recorded dtype restored, as a CPU tensor."""
    raw = np.load(os.path.join(pdir, rec["file"]))
    want = rec.get("dtype")
    if want == BF16:
        if raw.dtype.itemsize != 2:
            raise ValueError(f"{pdir}/{rec['file']}: {raw.dtype} cannot hold "
                             f"bfloat16")
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    if want and raw.dtype.name != want:
        raw = raw.astype(want)  # the recorded dtype wins
    return torch.from_numpy(raw)


def load_universal(universal_dir: str, include_moments: bool = False
                   ) -> Dict[str, Any]:
    """Universal dir (index version 2) → ``{universal name: tensor}`` with
    faithful dtypes; ``include_moments=True`` returns ``{name: {"param":
    ..., "exp_avg": ..., ...}}`` with every leaf the index lists. Leaves
    are read by a pool of threads."""
    with open(os.path.join(universal_dir, INDEX_FILE)) as f:
        index = json.load(f)
    zdir = os.path.join(universal_dir, UNIVERSAL_SUBDIR)
    jobs = {(name, ln): (os.path.join(zdir, name.replace("/", ".")), lrec)
            for name, rec in index["params"].items()
            for ln, lrec in rec["leaves"].items()
            if include_moments or ln == "param"}
    with ThreadPoolExecutor(LOAD_WORKERS) as pool:
        arrays = dict(zip(jobs, pool.map(lambda j: _load_leaf(*j),
                                         jobs.values())))
    out: Dict[str, Any] = {}
    for (name, ln), arr in arrays.items():
        if include_moments:
            out.setdefault(name, {})[ln] = arr
        else:
            out[name] = arr
    return out


def unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def convert(checkpoint_dir: str, output_dir: str, tag: Optional[str] = None,
            strict: bool = True) -> str:
    """Port checkpoint → stand-alone universal dir. → the tag converted.

    ``tag=None`` takes the committed ``latest``, falling back to the newest
    valid tag. ``strict`` verifies the tag against its integrity manifest
    first: a torn checkpoint fails here instead of exporting garbage."""
    from ..runtime.checkpoint_engine.numpy_checkpoint_engine import \
        NumpyCheckpointEngine
    from ..runtime.fault.manifest import verify_checkpoint

    if tag is None:
        tag = NumpyCheckpointEngine(checkpoint_dir).latest_tag()
        if tag is None:
            raise FileNotFoundError(
                f"{checkpoint_dir}: no valid committed checkpoint tag")
    src = os.path.join(checkpoint_dir, str(tag))
    if strict:
        verify_checkpoint(src)  # raises CheckpointCorruptError
    with open(os.path.join(src, INDEX_FILE)) as f:
        index = json.load(f)
    index["source_tag"] = str(tag)
    os.makedirs(output_dir, exist_ok=True)
    shutil.copytree(os.path.join(src, UNIVERSAL_SUBDIR),
                    os.path.join(output_dir, UNIVERSAL_SUBDIR),
                    dirs_exist_ok=True)
    with open(os.path.join(output_dir, INDEX_FILE), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
    return str(tag)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint of the PyTorch port to the offline "
                    "universal layout (per-param fp32 + optimizer leaves, "
                    "dtype-faithful)")
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--tag", default=None,
                        help="checkpoint tag (default: the committed "
                             "'latest', falling back to the newest valid "
                             "tag); verified against the integrity "
                             "manifest before conversion")
    parser.add_argument("--no_strict", action="store_true",
                        help="skip integrity verification of the source tag")
    args = parser.parse_args(argv)
    tag = convert(args.input_folder, args.output_folder, args.tag,
                  strict=not args.no_strict)
    print(f"universal checkpoint (tag {tag}) written to {args.output_folder}")


if __name__ == "__main__":
    main()
