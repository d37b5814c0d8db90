"""fused_gemm — the collective as an edge of the producing matmul, for the
PyTorch port (counterpart of ``deepspeed_tpu/runtime/comm/fused_gemm.py``;
T3, arXiv:2401.16677).

  * :func:`gemm_reduce_scatter` / :func:`gemm_all_gather_matmul` — the
    call-site wrappers for code that owns the producing matmul, over
    ``kernels/fused_collective_matmul.py``'s epilogue (K11) and prologue
    (K11, or K12 on a quantized wire);
  * :func:`fused_gemm_allreduce` — the leaf-seam form: the mean-allreduce
    of one gradient leaf on the fused-gemm schedule (reduce-scatter, then
    all-gather back), or the fused quantized wire.

The JAX prologue wrapper takes an optional ``GatherWindowCache`` (the
overlap subsystem's weight prefetch); the port has no overlap manager yet,
so a ``window_cache`` raises ``NotImplementedError`` (ROADMAP M6), as does
``predict_fused_gemm_bytes``, which waits for the overlap selector.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import comm
from ...kernels.fused_collective_matmul import (
    all_gather_matmul,
    matmul_reduce_scatter,
)
from .fused_wire import fused_quantized_allreduce, group_count, inv_n

#: the algorithm's name in the JAX package's selector and gauges
FUSED_GEMM = "fused_gemm"


def gemm_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axes,
                        wire_bits: int = 0,
                        group_size: int = 256) -> torch.Tensor:
    """The mean reduce-scatter epilogue matmul
    (:func:`~...kernels.fused_collective_matmul.matmul_reduce_scatter`):
    the replacement for ``psum_scatter(x @ w)`` on row-parallel
    projections and gradient-producing matmuls."""
    return matmul_reduce_scatter(x, w, axes, wire_bits=wire_bits,
                                 group_size=group_size)


def gemm_all_gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, axes,
                           wire_bits: int = 0, group_size: int = 256,
                           window_cache=None,
                           gather_fn=None) -> torch.Tensor:
    """The all-gather prologue matmul for weight shards
    (:func:`~...kernels.fused_collective_matmul.all_gather_matmul`)."""
    if window_cache is not None or gather_fn is not None:
        raise NotImplementedError(
            "gemm_all_gather_matmul(window_cache=...): the overlap "
            "subsystem's GatherWindowCache is not ported yet (ROADMAP M6)")
    return all_gather_matmul(x, w_shard, axes, wire_bits=wire_bits,
                             group_size=group_size)


def fused_gemm_allreduce(grad: torch.Tensor, axes, wire_bits: int = 0,
                         group_size: int = 256,
                         n: Optional[int] = None) -> torch.Tensor:
    """Mean-allreduce of one gradient leaf on the fused-gemm schedule.

    Full precision: ``all_gather(psum_scatter(g) / n)`` over the leaf
    flattened and zero-padded to a multiple of n — the mean with the
    reduce-scatter's summation order, the division a multiply by fl(1/n). int8/int4: the fused quantized wire
    (``fused_wire.fused_quantized_allreduce``)."""
    if n is None:
        n = group_count(axes)
    if n <= 1:
        return grad
    if wire_bits:
        out, _, _ = fused_quantized_allreduce(grad, axes, bits=wire_bits,
                                              group_size=group_size)
        return out
    flat = grad.reshape(-1).to(torch.float32)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = comm.reduce_scatter_tensor(flat) * inv_n(n)
    full = comm.all_gather_into_tensor(part)
    return full[:size].reshape(grad.shape).to(grad.dtype)


def predict_fused_gemm_bytes(bucket_bytes: int, wire: str, n: int,
                             group_size: int = 256):
    """The JAX package's predicted operand bytes of a fused-gemm bucket
    exchange, read by its overlap selector; that selector is not ported
    yet (ROADMAP M6)."""
    raise NotImplementedError(
        "predict_fused_gemm_bytes serves the overlap subsystem's algorithm "
        "selector, which is not ported yet (ROADMAP M6)")
