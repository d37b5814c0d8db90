"""Fused quantize → exchange → dequantize collectives for the PyTorch port
(counterpart of ``deepspeed_tpu/runtime/comm/fused_wire.py``; EQuARX,
arXiv:2506.17615).

Each collective's operand is produced directly by one quantize+pack kernel
(``quant_pack_wire``: K9a for int8, K9b for int4), and the receive side of
the reduce-scatter unpacks, dequantizes and averages the n peers' copies
in one kernel (``unpack_dequant_mean``, K10b), so the n float32 copies are
never written. Between the quantize and the exchange there is nothing but
a reshape.

The JAX functions run inside ``shard_map`` with the data ``axes`` bound;
here they run in every rank of the world (``deepspeed_tpu_torch.comm``)
and ``axes`` names the data axis: ``("data",)`` (or ``"data"``) exchanges
over the world, ``()`` is a world of one. The JAX package checks the
fusion by walking the jaxpr (``wire_ops``, ``assert_fused_pack``,
``assert_quantized_wire``); the port's counterpart is the facade's record
of every collective's op, dtype and bytes (``comm.comm_record()``).

Given the same per-rank inputs, every function returns the JAX function's
values bit for bit: the same scale and rounding rules in the kernels, the
same padding, the same peer order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import comm
from ...ops.quantizer.quantizer import (
    quant_pack_wire,
    unpack_dequant_mean,
    unpack_dequant_wire,
    wire_residual,
)
from ..topology import DATA


def group_count(axes) -> int:
    """The exchange group's size: the world for the data axis, 1 for no
    axis. Any other axis is model parallelism, which is M9."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes or ())
    if not axes:
        return 1
    if axes != (DATA,):
        raise NotImplementedError(
            f"collectives over axes {axes}: the port's world is one data "
            f"axis; other axes are not ported yet (ROADMAP M9)")
    return comm.get_world_size()


def inv_n(n: int) -> float:
    """fl(1/n) in float32: the reference's ``x / n`` under ``jit`` is a
    multiply by it (XLA folds the division by the constant), so the port's
    means multiply by it too."""
    return float(torch.ones((), dtype=torch.float32) / n)


def _pad_flat(tensor: torch.Tensor, multiple: int) -> torch.Tensor:
    flat = tensor.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _exchange_mean(w: torch.Tensor, s: torch.Tensor, bits: int, n: int,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage 1's wire: all-to-all the n chunks of (wire, scales), then
    K10b over what arrived (plus ``add``, LoCo's server residual, in the
    same rounding). → this rank's mean partition, float32 flat."""
    gpc = w.shape[0] // n                             # groups per chunk
    w_x = comm.all_to_all_single(w).view(n, gpc, w.shape[1])
    s_x = comm.all_to_all_single(s).view(n, gpc, 1)
    return unpack_dequant_mean(w_x, s_x, bits, n, add)


def _gather_dequant(w: torch.Tensor, s: torch.Tensor, bits: int,
                    dtype=torch.float32) -> torch.Tensor:
    """All-gather (wire, scales) and dequantize every rank's rows (K10a).
    → ``[n * groups * group_size]`` in rank order."""
    w_all = comm.all_gather_into_tensor(w)
    s_all = comm.all_gather_into_tensor(s)
    return unpack_dequant_wire(w_all, s_all, bits, dtype=dtype)


def fused_quantized_reduce_scatter(tensor: torch.Tensor, axes,
                                   bits: int = 4, group_size: int = 256,
                                   return_sent: bool = False):
    """qgZ stage 1: quantize+pack this rank's contribution in one kernel,
    all-to-all the wire bytes, dequantize+mean this rank's partition in one
    kernel. → this rank's mean partition (float32 flat, the input padded
    to a multiple of n·group_size, then cut in n).

    ``return_sent=True`` also returns the dequantized signal this rank
    sent, cut to the input's length: the LoCo error-feedback seam, rebuilt
    from the same wire the exchange used."""
    n = group_count(axes)
    if n <= 1:
        flat = tensor.reshape(-1).to(torch.float32)
        return (flat, flat) if return_sent else flat
    size = tensor.numel()
    flat = _pad_flat(tensor, n * group_size)
    w, s = quant_pack_wire(flat, bits, group_size)
    mine = _exchange_mean(w, s, bits, n)
    if return_sent:
        return mine, unpack_dequant_wire(w, s, bits)[:size]
    return mine


def fused_quantized_all_gather(flat_shard: torch.Tensor, axes,
                               bits: int = 8, group_size: int = 256,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """qwZ's wire: one quantize+pack kernel on this rank's flat shard, the
    wire all-gathered, one unpack+dequant kernel. → every rank's shard
    concatenated flat, each cut to the shard's length."""
    n = group_count(axes)
    flat = flat_shard.reshape(-1)
    if n <= 1:
        return flat.to(out_dtype)
    w, s = quant_pack_wire(flat, bits, group_size)
    padded = w.shape[0] * group_size                  # per-rank padded length
    vals = _gather_dequant(w, s, bits, out_dtype).view(n, padded)
    return vals[:, :flat.numel()].reshape(-1)


def fused_quantized_allreduce(grad: torch.Tensor, axes, bits: int = 8,
                              group_size: int = 256,
                              error: Optional[torch.Tensor] = None,
                              server_error: Optional[torch.Tensor] = None,
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                         Optional[torch.Tensor]]:
    """The fully quantized mean-allreduce (qgZ): stage 1 the quantized
    all-to-all and K10b's mean of this rank's partition, stage 2 that
    partition re-quantized and all-gathered. With LoCo (``error``, the
    stage-1 residual of this rank's contribution, and ``server_error``, the
    stage-2 residual of its partition) both hops carry error feedback.
    → ``(mean in grad's shape and dtype, new error, new server_error)``."""
    n = group_count(axes)
    if n <= 1:
        return grad, error, server_error
    flat = grad.reshape(-1).to(torch.float32)
    if error is not None:
        flat = flat + error.reshape(-1)
    size = flat.numel()
    flat = _pad_flat(flat, n * group_size)

    # stage 1: one quant+pack kernel, wire all-to-all, fused dequant+mean
    w, s = quant_pack_wire(flat, bits, group_size)
    new_error = None
    if error is not None:                             # what missed the wire
        new_error = wire_residual(flat, w, s, bits)[:size].reshape(
            grad.shape)
    # my partition's mean, plus LoCo's server residual in the same rounding
    mine = _exchange_mean(w, s, bits, n, None if server_error is None
                          else server_error.reshape(-1))
    del w, s, flat

    # stage 2: re-quantize the partition, wire all-gather, fused dequant
    new_server_error = None
    w2, s2 = quant_pack_wire(mine, bits, group_size)
    if server_error is not None:
        new_server_error = wire_residual(mine, w2, s2, bits).reshape(
            server_error.shape)
    del mine
    full = _gather_dequant(w2, s2, bits)[:size]
    return (full.reshape(grad.shape).to(grad.dtype), new_error,
            new_server_error)
