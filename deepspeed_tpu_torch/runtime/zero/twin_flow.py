"""Twin-Flow's split of the optimizer state (counterpart of
``deepspeed_tpu/runtime/zero/twin_flow.py``; Offload++'s ``ratio``).

With ``0 < offload_optimizer.ratio < 1`` each state leaf splits on one
axis: the first ``n_dev`` rows stay in device memory, the last ``n_host``
rows live in pinned host memory and stream through the update
(``runtime/swap_tensor/streamed_update.py``), which joins the two parts,
runs the optimizer on the whole leaf and splits the result back, as the
JAX wrapper's ``join``/``split`` do.

:func:`plan_leaf` is the JAX ``_plan_leaf`` at one device (a granule of
one row): the axis is the leaf's largest dimension (the first of equal
ones), ``n_host = round(rows · ratio)`` kept within ``[0, rows - 1]``, so
the device part is never empty; scalars and 1-row leaves stay on the
device. :func:`byte_split` is the JAX ``byte_split`` over the state's
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    axis: int           # split axis (the leaf's largest dim)
    n_dev: int          # rows of ``axis`` staying in device memory
    n_host: int         # rows of ``axis`` on the host
    scalar: bool        # shape () — never split


def plan_leaf(shape: Tuple[int, ...], ratio: float) -> LeafPlan:
    """Where one state leaf of ``shape`` splits at ``ratio``."""
    if not shape:
        return LeafPlan(0, 0, 0, True)
    axis = max(range(len(shape)), key=lambda d: shape[d])
    rows = shape[axis]
    n_host = int(round(rows * ratio))
    n_host = min(max(n_host, 0), rows - 1)
    if n_host <= 0:
        n_host = 0
    return LeafPlan(axis, rows - n_host, n_host, False)


def byte_split(leaves: Iterable[Tuple[Tuple[int, ...], int]],
               ratio: float) -> Tuple[int, int]:
    """``(device_bytes, host_bytes)`` of state leaves given as
    ``(shape, itemsize)`` split at ``ratio``."""
    dev_b = host_b = 0
    for shape, itemsize in leaves:
        lp = plan_leaf(tuple(shape), ratio)
        if lp.scalar:
            dev_b += itemsize
            continue
        row = itemsize
        for d, n in enumerate(shape):
            if d != lp.axis:
                row *= n
        dev_b += lp.n_dev * row
        host_b += lp.n_host * row
    return dev_b, host_b
