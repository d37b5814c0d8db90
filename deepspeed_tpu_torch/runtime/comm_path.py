"""The data-parallel gradient exchange of the PyTorch port (counterpart of
the stage-0 part of ``deepspeed_tpu/runtime/comm_path.py``).

In the JAX package the loss and gradients of the explicit-communication
step run under ``shard_map`` over the data axes, and the exchanges are
written by hand. In the port every rank of the ``torch.distributed``
world is one data index: it computes the gradients of its own rows and
exchanges them here, with the facade's collectives:

  * the plain wire: ``psum(g) / n`` per leaf (``all_reduce``, then a
    multiply by fl(1/n), as XLA compiles the division), the mean the JAX
    engine's fused path computes at ZeRO 0;
  * ``zero_quantized_gradients`` (qgZ): :func:`quantized_allreduce` per
    leaf on the int4 wire, the fused kernels of
    ``runtime/comm/fused_wire.py`` (K9b, K10b, K10a) or, with
    ``fused=False``, the legacy composed wire;
  * ``zeropp_loco``: LoCo error feedback on both hops of that wire, with
    one worker and one server residual per leaf kept by each rank (each
    new residual computed by ``wire_residual``, K10a's variant).

What stays refused: the sparse-gradient wire (``sparse_gradients``,
ROADMAP M8), qwZ (M8), ZeRO stages 1-3 on a world (M6; the engine
raises), and the overlap manager's bucketed, 2-hop and fused-gemm
plain-wire algorithms (the ``overlap`` block, M6); ``runtime/config.py``
raises for the others.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import comm
from ..ops.quantizer.quantizer import (
    _quantize_groups,
    dequantize_int4,
    dequantize_int8,
    quantize_int8,
    unpack_dequant_mean,
    wire_residual,
)
from .comm.fused_wire import (
    fused_quantized_allreduce,
    group_count,
    inv_n,
)
from .topology import DATA


def dp_axes_info(topology):
    """The active data-parallel axes, their size, and the entry naming them
    (the JAX ``dp_axes_info``): ``(("data",), n, "data")`` on a world of
    n > 1, ``((), 1, None)`` on one process."""
    n = topology.dims.get(DATA, 1)
    axes = (DATA,) if n > 1 else ()
    return axes, n, (DATA if axes else None)


def loco_partition_size(numel: int, n: int, group_size: int = 256) -> int:
    """Length of one rank's reduced partition (the stage-2 LoCo buffer)."""
    pad = (-numel) % (n * group_size)
    return (numel + pad) // n


def _quantize_int4_compiled(x: torch.Tensor, group_size: int):
    """The legacy interleaved int4 quantize as XLA compiles it inside the
    reference's jitted step: the scale is ``max|x| * fl(1/7)`` (the
    division folded into a multiply), where the eager ``quantize_int4``
    divides. → (packed int8 [groups, group_size/2], scales [groups, 1])."""
    q, scale = _quantize_groups(x, group_size, 7)
    packed = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)
    return packed.to(torch.int8), scale


#: the legacy wire's (quantize, dequantize), as the reference's step runs it
_LEGACY_WIRE = {8: (quantize_int8, dequantize_int8),
                4: (_quantize_int4_compiled, dequantize_int4)}


def _legacy_values(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Legacy wire bytes → int8 values [groups, group_size]: int8 is the
    identity; int4 is interleaved (element 2i low nibble, 2i+1 high)."""
    if bits == 8:
        return q
    lo = torch.bitwise_left_shift(q, 4).to(torch.int8) >> 4
    hi = q >> 4
    return torch.stack([lo, hi], dim=2).reshape(q.shape[0], -1)


def quantized_allreduce(grad: torch.Tensor, axes, bits: int = 8,
                        group_size: int = 256,
                        error: Optional[torch.Tensor] = None,
                        server_error: Optional[torch.Tensor] = None,
                        fused: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
    """Mean-allreduce with a fully quantized wire (qgZ).

    Stage 1: each rank quantizes its contribution and all-to-alls it;
    stage 2: the reduced partition is re-quantized and all-gathered. With
    LoCo both hops carry error feedback: ``error`` holds the stage-1
    residual of this rank's contribution, ``server_error`` the stage-2
    residual of its partition. ``fused=True`` runs the fused wire
    (``fused_wire.fused_quantized_allreduce``); ``fused=False`` the legacy
    wire (K8a/K8b, or the plain interleaved int4 pair), whose mean over
    peers is K10b on the unpacked values: the reduction XLA makes of the
    reference's dequantize-then-``mean``.
    → ``(mean, new error, new server_error)``."""
    n = group_count(axes)
    if n <= 1:
        return grad, error, server_error
    if fused:
        return fused_quantized_allreduce(grad, axes, bits=bits,
                                         group_size=group_size, error=error,
                                         server_error=server_error)
    if bits not in _LEGACY_WIRE:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    quant, dequant = _LEGACY_WIRE[bits]
    flat = grad.reshape(-1).to(torch.float32)
    if error is not None:
        flat = flat + error.reshape(-1)
    size = flat.numel()
    pad = (-size) % (n * group_size)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    # stage 1: quantize local contributions, exchange, reduce my partition
    q, s = quant(flat, group_size)
    new_error = None
    if error is not None:                             # what missed the wire
        new_error = wire_residual(flat, _legacy_values(q, bits), s, 8)[:size]
        new_error = new_error.reshape(grad.shape)
    gpc = q.shape[0] // n
    q_x = comm.all_to_all_single(q)
    s_x = comm.all_to_all_single(s).view(n, gpc, 1)
    vals = _legacy_values(q_x, bits).view(n, gpc, group_size)
    # my reduced partition, plus LoCo's server residual in the same rounding
    mine = unpack_dequant_mean(vals, s_x, 8, n, None if server_error is None
                               else server_error.reshape(-1))

    # stage 2: quantized all-gather of the reduced partitions
    new_server_error = None
    q2, s2 = quant(mine, group_size)
    if server_error is not None:
        new_server_error = wire_residual(mine, _legacy_values(q2, bits), s2, 8)
        new_server_error = new_server_error.reshape(server_error.shape)
    q2_all = comm.all_gather_into_tensor(q2)
    s2_all = comm.all_gather_into_tensor(s2)
    full = dequant(q2_all, s2_all).reshape(-1)[:size]
    return (full.reshape(grad.shape).to(grad.dtype), new_error,
            new_server_error)


# --------------------------------------------------------------------- #
# The engine's wire
# --------------------------------------------------------------------- #
class WireContext:
    """What the engine's data-parallel step needs to exchange gradients
    (the stage-0 subset of the JAX ``_WireContext``): the config's wires,
    the world's data axis, and the per-leaf exchange."""

    def __init__(self, engine):
        zc = engine.config.zero_config
        self.engine = engine
        self.qgz = bool(zc.zero_quantized_gradients)
        self.loco = bool(zc.zeropp_loco) and self.qgz
        self.grad_bits = 4   # qgZ wire (reference quant_reduce.cu uses int4)
        self.group_size = 256
        self.data_axes, self.n_dp, _ = dp_axes_info(engine.topology)
        self.gas = engine.gradient_accumulation_steps()

    def init_errors(self, params: Dict[str, torch.Tensor]
                    ) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """LoCo's residuals of this rank, per leaf: ``worker`` in the
        leaf's shape, ``server`` one partition long; ``None`` without
        LoCo."""
        if not self.loco:
            return None
        return {name: {"worker": torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device),
                       "server": torch.zeros(
                           loco_partition_size(p.numel(), self.n_dp,
                                               self.group_size),
                           dtype=torch.float32, device=p.device)}
                for name, p in params.items()}

    def local_loss_and_grads(self, rows) -> Tuple[torch.Tensor,
                                                   Dict[str, torch.Tensor]]:
        """This rank's micro-batches (``rows``, ``[gas]`` of them): their
        scaled backward passes summed into the masters' float32
        ``.grad``, divided by gas; no cross-rank reduction. → (the mean
        local loss, the gradients by name)."""
        engine = self.engine
        engine._zero_grads()
        losses = [engine._loss_and_backward(mb) for mb in rows]
        grads = engine._grads()
        if self.gas > 1:
            for g in grads.values():
                g.div_(self.gas)
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).mean()
        return loss, grads

    def exchange_grads(self, grads: Dict[str, torch.Tensor],
                       comm_error=None):
        """Mean-exchange every leaf: the quantized allreduce with qgZ, else
        ``all_reduce(g) / n``. → ``(grads, new LoCo residuals or None)``;
        ``grads`` is updated in place. Without a dynamic loss scaler no step
        can overflow, so each leaf's new residuals replace its old ones in
        ``comm_error`` as soon as they exist (one set alive, not two);
        with one, they are kept apart for :meth:`guard_loco_errors`."""
        commit = not self.engine.loss_scaler.dynamic
        new_error = comm_error if commit else ({} if self.loco else None)
        for name, g in grads.items():
            if not self.data_axes:
                continue
            if self.qgz:
                e = comm_error[name] if self.loco else None
                out, new_w, new_s = quantized_allreduce(
                    g, self.data_axes, bits=self.grad_bits,
                    group_size=self.group_size,
                    error=e["worker"] if e else None,
                    server_error=e["server"] if e else None)
                g.copy_(out)
                del out, e
                if self.loco:
                    new_error[name] = {"worker": new_w, "server": new_s}
            else:
                comm.all_reduce(g).mul_(inv_n(self.n_dp))
        return grads, new_error

    def guard_loco_errors(self, new_error, old_error, overflow: bool):
        """A skipped (overflow) step must not commit inf/nan residuals:
        they would poison every later corrected gradient."""
        return old_error if overflow else new_error

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The data-mean loss every rank returns (``pmean`` of the local
        losses)."""
        if not self.data_axes:
            return loss
        return comm.all_reduce(loss.clone(), comm.ReduceOp.AVG)


def build_explicit_comm_step(engine):
    """The data-parallel ``train_batch`` step (the JAX
    ``build_explicit_comm_step`` at ZeRO 0): this rank's micro-batches'
    gradients summed in float32 and divided by gas, unscaled before the
    wire (LoCo residuals live in true units), exchanged once at the
    boundary, then the update without a second unscale; LoCo residuals are
    kept only when the step did not overflow. → ``step(rows) -> loss``,
    ``rows`` this rank's ``[gas]`` list of micro-batches."""
    ctx = WireContext(engine)
    engine.comm_error = ctx.init_errors(engine.params)

    def step(rows) -> torch.Tensor:
        mean_loss, grads = ctx.local_loss_and_grads(rows)
        engine.loss_scaler.unscale_grads(grads, engine.scaler_state)
        grads, new_error = ctx.exchange_grads(grads, engine.comm_error)
        mean_loss = ctx.mean_loss(mean_loss)
        overflow = engine._apply_update(grads, unscale=False)
        if ctx.loco and engine.loss_scaler.dynamic:
            engine.comm_error = ctx.guard_loco_errors(
                new_error, engine.comm_error, overflow)
        engine._zero_grads()
        return mean_loss

    step.ctx = ctx
    return step
