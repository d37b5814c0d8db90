"""DeepSpeedEngine for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/engine.py``): ZeRO stages 0-3 on one device, or
stage 0 on each rank of a data-parallel ``torch.distributed`` world.

The engine holds float32 master parameters (``self.params``, a dict of
dotted name → leaf tensor that requires grad) and an optimizer over them.
Each micro-batch casts the masters to the compute dtype inside autograd
(bf16 under ``bf16.enabled``), as the JAX engine casts inside
``jax.grad``, so the gradients reach the masters in float32.

``train_batch`` runs the JAX fused step: the global batch is split into
``[gas, micro]``, the micro-batches' gradients are summed in float32 and
divided by ``gas``, then ``_apply_update`` in the reference's order:
unscale → clip by ``clip/(norm+1e-6)`` → ``where(isfinite(g), g, 0)`` →
optimizer update → skip the update on overflow (dynamic loss scaler only;
the masters and the optimizer state stay as they were, and the step is
counted in ``skipped_steps``). ``forward``/``backward``/``step`` are the
imperative path with the same update at the accumulation boundary;
``eval_batch`` is the loss under ``no_grad``.

On a world of n > 1 processes (``runtime/topology.py``: the data extent
is the world size) every rank holds the whole model, ``train_batch``
takes the same global batch as the JAX engine and rank r trains on the
rows the JAX mesh puts on data index r, rows ``[r·micro, (r+1)·micro)``
of each micro-batch. The gradients are exchanged as the JAX engine
exchanges them (``runtime/comm_path.py``): the plain mean, or with
``zero_quantized_gradients`` the quantized wire, with LoCo residuals kept
per rank under ``zeropp_loco``; every rank returns the data-mean loss and
applies the same update, so the ranks' parameters stay equal. The
imperative ``backward()``/``step()`` at n > 1 raise
``NotImplementedError`` (ROADMAP M8). ``save_checkpoint`` writes from rank
0 between two barriers; every rank loads.

ZeRO on one device: stages 1-3 train exactly as stage 0 (the JAX sharding
plan replicates every array at ZeRO size 1) and
``zero_optimization_stage()`` reports the configured stage; a stage >= 1
on a world of n > 1 raises ``NotImplementedError`` (ROADMAP M6, ZeRO
sharding). ``offload_optimizer.device: cpu`` keeps the optimizer state in
host memory and streams it through each update
(``runtime/swap_tensor/streamed_update.py``), all of it at ``ratio`` 1 or
a Twin-Flow share of each leaf below 1; ``pipeline_read`` stages the
first pieces before the forward (``host_tier.HostOffloadPrefetcher``).
The results are bit for bit the resident engine's. As in the JAX engine,
``offload_param`` and ``offload_optimizer.device: nvme`` are accepted and
change nothing. ``offload_states``/``reload_states`` move the optimizer
state and the masters to host memory or to files and back.

A client optimizer is a factory ``f(masters) -> torch.optim.Optimizer``
(``optimizer.ClientOptimizer``), stepped in the engine's order.

Updates are in place (the JAX engine donates its state instead). When the
model's parameters are already float32 on the engine's device, the masters
share their storage, so the model sees the trained values.

``save_checkpoint``/``load_checkpoint`` keep the JAX signatures. A tag
directory is a universal checkpoint directory
(``runtime/checkpoint_engine/numpy_checkpoint_engine.py``): the float32
masters and every optimizer state tensor by its layout name, plus the
optimizer's update count, the loss scaler, ``global_steps``,
``skipped_steps``, ``micro_steps``, the lr scheduler's state and
``client_state`` — everything a bit-for-bit resume needs. A directory the
JAX package's ``ds_to_universal.convert`` wrote loads too (``load_dir``
itself, holding ``index.json``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import comm
from ..accelerator import get_accelerator
from ..checkpoint.ds_to_universal import INDEX_FILE
from ..checkpoint.universal.layout import universal_name
from ..utils.logging import logger
from .checkpoint_engine.numpy_checkpoint_engine import NumpyCheckpointEngine
from .config import DeepSpeedConfig
from .fp16.loss_scaler import LossScalerState, create_loss_scaler
from .lr_schedules import get_schedule_fn
from .optimizer import ClientOptimizer, build_optimizer
from .topology import DATA, get_topology


@dataclasses.dataclass
class _Away:
    """One ``offload_states`` group while it is off the device."""
    device: str                                   # "cpu" or "nvme"
    tensors: Dict[str, torch.Tensor]              # the emptied device tensors
    sizes: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    scratch: list = dataclasses.field(default_factory=list)
    host: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    swapper: Any = None


def _global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    sq = [g.float().square().sum() for g in grads.values()]
    return torch.stack(sq).sum().sqrt()


class DeepSpeedEngine:
    def __init__(self, model: Any, config: DeepSpeedConfig,
                 model_parameters: Optional[Dict[str, torch.Tensor]] = None,
                 lr_scheduler: Any = None, device=None, topology=None,
                 optimizer: Optional[Callable] = None):
        self.config = config
        self.device = get_accelerator().resolve_device(device)
        self.topology = topology if topology is not None else get_topology()
        self.dp_world_size = self.topology.dims[DATA]
        if self.dp_world_size != comm.get_world_size():
            raise ValueError(f"the topology's data extent "
                             f"{self.dp_world_size} is not the world size "
                             f"{comm.get_world_size()}")
        self.dp_rank = self.topology.data_index
        zc = config.zero_config
        if zc.stage >= 1 and self.dp_world_size > 1:
            raise NotImplementedError(
                f"zero_optimization.stage={zc.stage} on a world of "
                f"{self.dp_world_size}: ZeRO sharding is not ported yet "
                f"(ROADMAP M6); stages 1-3 run on one device, stage 0 on a "
                f"world")
        self.module = model
        self.loss_fn = self._resolve_loss_fn(model)
        self.compute_dtype = config.dtype
        self.lr_scheduler = lr_scheduler

        named = model_parameters
        if named is None:
            if not hasattr(model, "named_parameters"):
                raise ValueError("model_parameters (a dict of name → tensor) "
                                 "is required")
            named = dict(model.named_parameters())
        self.params: Dict[str, torch.Tensor] = {
            name: t.detach().to(self.device, torch.float32).requires_grad_()
            for name, t in named.items()}

        self._schedule_fn = self._resolve_schedule()
        self.optimizer = self._resolve_optimizer(optimizer)
        #: the update over host-resident state, None when resident
        self._offload = None
        self._offload_prefetcher = None
        if zc.offload_optimizer_device() == "cpu":
            self._offload = self._build_offload(zc)
        else:
            self.optimizer.init(self.params)
        #: what offload_states moved off the device, by group
        self._offloaded: Dict[str, Any] = {}
        self.loss_scaler = create_loss_scaler(config.fp16, self.compute_dtype)
        self.scaler_state = self.loss_scaler.init()

        self.global_steps = 0
        self.skipped_steps = 0
        self.micro_steps = 0
        #: LoCo residuals of this rank (``comm_path``), None without LoCo
        self.comm_error = None
        self._dp_step = None
        if self.dp_world_size > 1:
            from .comm_path import build_explicit_comm_step

            self._dp_step = build_explicit_comm_step(self)
        logger.info(f"engine ready: device={self.device} "
                    f"dp={self.dp_world_size} rank={self.dp_rank} "
                    f"dtype={self.compute_dtype} "
                    f"batch={config.train_batch_size} "
                    f"micro={config.train_micro_batch_size_per_gpu} "
                    f"gas={config.gradient_accumulation_steps}")

    # ------------------------------------------------------------------ #
    # Resolution helpers
    # ------------------------------------------------------------------ #
    @staticmethod
    def _resolve_loss_fn(model) -> Callable:
        """``model.loss_fn(params, batch, rng)`` or a callable
        ``f(params, batch, rng) -> loss``."""
        if hasattr(model, "loss_fn"):
            return model.loss_fn
        if callable(model):
            return model
        raise TypeError(f"cannot derive a loss function from {type(model)}")

    def _resolve_schedule(self) -> Callable[[int], float]:
        cfg = self.config
        base_lr = cfg.optimizer.params.get("lr", 1e-3) if cfg.optimizer \
            else 1e-3
        if cfg.scheduler and cfg.scheduler.type:
            return get_schedule_fn(cfg.scheduler.type, cfg.scheduler.params,
                                   base_lr=base_lr)
        return lambda step: base_lr

    def _resolve_optimizer(self, client: Optional[Callable]):
        if client is not None:
            scheduled = bool(self.config.scheduler and
                             self.config.scheduler.type)
            return ClientOptimizer(
                client, self._schedule_fn if scheduled else None)
        cfg = self.config.optimizer
        if cfg is None:
            return build_optimizer("adam", {}, self._schedule_fn)
        return build_optimizer(cfg.type, dict(cfg.params), self._schedule_fn)

    def _build_offload(self, zc):
        """The streamed update of ``offload_optimizer.device: cpu``."""
        from .swap_tensor.host_tier import HostOffloadPrefetcher
        from .swap_tensor.streamed_update import StreamedUpdate

        if isinstance(self.optimizer, ClientOptimizer):
            raise ValueError(
                "offload_optimizer.device=cpu cannot stream a client "
                "optimizer: its state lives where torch.optim puts it "
                "(next to each parameter), not in host buffers the engine "
                "owns; name the optimizer in the config instead")
        block = zc.offload_optimizer
        ratio = float(block.ratio) if block is not None else 1.0
        buffers = block.buffer_count if block is not None else 4
        offload = StreamedUpdate(self.optimizer, self.params, self.device,
                                 ratio=ratio, buffer_count=buffers)
        if block is not None and block.pipeline_read:
            self._offload_prefetcher = HostOffloadPrefetcher()
        return offload

    @property
    def _state_owner(self):
        """What steps the optimizer and reads and writes its state by
        name: the streamed update when the state is offloaded."""
        return self._offload if self._offload is not None else self.optimizer

    # ------------------------------------------------------------------ #
    # Introspection (reference names)
    # ------------------------------------------------------------------ #
    @property
    def global_samples(self) -> int:
        return self.micro_steps * self.train_micro_batch_size_per_gpu() * \
            self.dp_world_size

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.config.zero_stage

    def get_lr(self):
        return [float(self._schedule_fn(self.global_steps))]

    def get_loss_scale(self) -> float:
        return float(self.scaler_state.scale)

    def is_gradient_accumulation_boundary(self) -> bool:
        gas = self.gradient_accumulation_steps()
        return self.micro_steps % gas == 0 and self.micro_steps > 0

    # ------------------------------------------------------------------ #
    # Core math
    # ------------------------------------------------------------------ #
    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: v.to(self.device) for k, v in batch.items()}
        return batch.to(self.device)

    def _compute_params(self) -> Dict[str, torch.Tensor]:
        """The masters cast to the compute dtype, inside autograd."""
        return {name: p.to(self.compute_dtype)
                for name, p in self.params.items()}

    def _loss_and_backward(self, batch) -> torch.Tensor:
        """One micro-batch: cast → forward → scaled backward; the float32
        gradients add into each master's ``.grad``. → the loss, float32."""
        loss = self.loss_fn(self._compute_params(), batch, None)
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss = loss.float()
        self.loss_scaler.scale_loss(loss, self.scaler_state).backward()
        return loss.detach()

    def _grads(self) -> Dict[str, torch.Tensor]:
        return {name: p.grad if p.grad is not None else torch.zeros_like(p)
                for name, p in self.params.items()}

    def _zero_grads(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _apply_update(self, grads: Dict[str, torch.Tensor],
                      grad_norm_scale: Optional[float] = None,
                      unscale: bool = True) -> bool:
        """Unscale, clip, zero non-finite values, update, and skip the
        update on overflow (dynamic scaler only), in the reference's
        order; ``grads`` are modified in place. ``unscale=False`` when the
        caller unscaled before the wire. → whether the step overflowed."""
        if unscale:
            self.loss_scaler.unscale_grads(grads, self.scaler_state)
        if grad_norm_scale is not None:
            for g in grads.values():
                g.mul_(grad_norm_scale)
        overflow = self.loss_scaler.check_overflow(grads) \
            if self.loss_scaler.dynamic else False
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            scale = torch.clamp(clip / (_global_norm(grads) + 1e-6), max=1.0)
            for g in grads.values():
                g.mul_(scale)
        for g in grads.values():
            torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        if not overflow:
            self._state_owner.step(self.params, grads)
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    overflow)
        if overflow:
            self.skipped_steps += 1
        else:
            self.global_steps += 1
        return bool(overflow)

    # ------------------------------------------------------------------ #
    # Fused path
    # ------------------------------------------------------------------ #
    def train_batch(self, batch) -> torch.Tensor:
        """One optimizer step over a global batch whose leading dim is
        ``train_batch_size``; with gradient accumulation it is split into
        ``gas`` micro-batches. → the mean micro-batch loss (float32)."""
        self._require_states("train_batch")
        gas = self.gradient_accumulation_steps()
        batch = self._to_device(batch)
        if self._offload_prefetcher is not None:
            self._offload_prefetcher.arm(self._offload)
        if self._dp_step is not None:
            loss = self._dp_step(self._rank_rows(batch))
            self.micro_steps += gas
            return loss
        self._zero_grads()
        if gas == 1:
            mean_loss = self._loss_and_backward(batch)
        else:
            def micro(i):
                if isinstance(batch, dict):
                    return {k: v.reshape(gas, -1, *v.shape[1:])[i]
                            for k, v in batch.items()}
                return batch.reshape(gas, -1, *batch.shape[1:])[i]

            losses = [self._loss_and_backward(micro(i)) for i in range(gas)]
            mean_loss = torch.stack(losses).mean()
        grads = self._grads()
        if gas > 1:
            for g in grads.values():
                g.div_(gas)
        self._apply_update(grads)
        self._zero_grads()
        self.micro_steps += gas
        return mean_loss

    def _rank_rows(self, batch):
        """This rank's micro-batches of a global batch: ``[gas]`` of rows
        ``[r·micro, (r+1)·micro)`` of each global micro-batch, as the JAX
        mesh shards them over the data axis."""
        gas = self.gradient_accumulation_steps()
        micro = self.config.train_micro_batch_size_per_gpu
        lo = self.dp_rank * micro

        def rows(x, i):
            x = x.reshape(gas, -1, *x.shape[1:])[i]
            if x.shape[0] != micro * self.dp_world_size:
                raise ValueError(f"a global micro-batch has {x.shape[0]} "
                                 f"rows, not micro {micro} x dp "
                                 f"{self.dp_world_size}")
            return x[lo:lo + micro]

        if isinstance(batch, dict):
            return [{k: rows(v, i) for k, v in batch.items()}
                    for i in range(gas)]
        return [rows(batch, i) for i in range(gas)]

    # ------------------------------------------------------------------ #
    # Imperative path (reference API shape)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        """Loss-only forward (eval); for training use backward()/step().
        On a world of n > 1 each rank takes its rows of the global batch
        and every rank returns the data-mean loss."""
        self._require_states("forward")
        batch = self._to_device(batch)
        if self._dp_step is not None:
            micro = batch.shape[0] if not isinstance(batch, dict) else \
                next(iter(batch.values())).shape[0]
            if micro % self.dp_world_size:
                raise ValueError(f"a batch of {micro} rows does not split "
                                 f"over {self.dp_world_size} ranks")
            per = micro // self.dp_world_size
            lo = self.dp_rank * per
            batch = {k: v[lo:lo + per] for k, v in batch.items()} \
                if isinstance(batch, dict) else batch[lo:lo + per]
        out = self.loss_fn(self._compute_params(), batch, None)
        out = out[0] if isinstance(out, tuple) else out
        if self._dp_step is not None:
            out = self._dp_step.ctx.mean_loss(out.float())
        return out

    __call__ = forward

    def backward(self, batch) -> torch.Tensor:
        """Forward and backward of one micro-batch; its float32 gradients
        add to those of the accumulation window. Like the JAX engine (and
        unlike the reference), it takes the micro-batch, not a loss.
        → the micro-batch loss."""
        self._refuse_imperative_dp("backward")
        self._require_states("backward")
        loss = self._loss_and_backward(self._to_device(batch))
        self.micro_steps += 1
        return loss

    def _refuse_imperative_dp(self, name: str) -> None:
        if self._dp_step is not None:
            raise NotImplementedError(
                f"{name}() on a data-parallel world of "
                f"{self.dp_world_size}: the imperative path's exchange at "
                f"the accumulation boundary is not ported yet (ROADMAP M8); "
                f"use train_batch")

    def step(self) -> None:
        """Apply the update at the accumulation boundary (else a no-op),
        the accumulated sum scaled by 1/gas after unscaling."""
        self._refuse_imperative_dp("step")
        self._require_states("step")
        if not self.is_gradient_accumulation_boundary():
            return
        grads = self._grads()
        self._apply_update(grads,
                           grad_norm_scale=1.0 / self.gradient_accumulation_steps())
        self._zero_grads()

    def eval_batch(self, batch) -> torch.Tensor:
        return self.forward(batch)

    def no_sync(self):
        """Reference ``engine.no_sync()``: the gradients are exchanged only
        at the optimizer step (``train_batch``), so there is nothing to
        suppress between boundaries — a no-op context."""
        import contextlib

        return contextlib.nullcontext()

    def zero_grad(self) -> None:
        """Drop the gradients accumulated since the last update."""
        self._zero_grads()

    def get_fp32_state_dict(self) -> Dict[str, torch.Tensor]:
        """The float32 masters on the host, by dotted name (reference
        ``get_fp32_state_dict``; every rank holds the whole model)."""
        return {name: p.detach().to("cpu", torch.float32, copy=True)
                for name, p in self.params.items()}

    # ------------------------------------------------------------------ #
    # State offload (JAX engine.offload_states / reload_states)
    # ------------------------------------------------------------------ #
    def _device_groups(self, what: str) -> Tuple[Dict[str, torch.Tensor],
                                                 Sequence[torch.Tensor]]:
        """The device tensors of one ``offload_states`` group: those whose
        values move, and scratch whose memory is only freed (the streamed
        update's ring)."""
        if what in ("params", "hp_params"):
            return dict(self.params), ()
        if what != "optimizer":
            raise ValueError(f"cannot offload {what!r}")
        if self._offload is not None:
            return self._offload.device_state(), self._offload.ring_buffers()
        owner = self.optimizer
        if isinstance(owner, ClientOptimizer):
            return {f"{name}/{k}": t for name in self.params
                    for k, t in owner.named_state(name).items()
                    if t.device == self.device}, ()
        return {f"{name}/{k}": t for name in self.params
                for k, t in owner.named_state(name).items()}, ()

    @staticmethod
    def _free_storage(t: torch.Tensor) -> Tuple[int, torch.Size, Any]:
        """Release ``t``'s device memory. → what :meth:`_remake_storage`
        needs: the storage's bytes (shared with every tensor on it, the
        model's parameter too), or -1 when the storage is not resizable
        (a tensor made from numpy), whose ``.data`` is dropped instead;
        the shape and dtype."""
        shape, dtype = t.shape, t.dtype
        storage = t.untyped_storage()
        if not storage.resizable():
            t.data = torch.empty(0, dtype=dtype, device=t.device)
            return -1, shape, dtype
        nbytes = storage.nbytes()
        if t.storage_offset() or nbytes != t.numel() * t.element_size():
            raise ValueError("offload_states moves whole tensors; this one "
                             "is a view into a larger storage")
        storage.resize_(0)
        return nbytes, shape, dtype

    @staticmethod
    def _remake_storage(t: torch.Tensor, nbytes: int, shape, dtype) -> None:
        if nbytes < 0:
            t.data = torch.empty(shape, dtype=dtype, device=t.device)
        else:
            t.untyped_storage().resize_(nbytes)

    @torch.no_grad()
    def offload_states(self, include=("optimizer",), device: str = "cpu",
                       nvme_path: Optional[str] = None,
                       pin_memory: bool = True,
                       non_blocking: bool = False) -> None:
        """Move engine state off the device and free its memory:
        ``include`` names ``"optimizer"`` and/or ``"params"`` (or
        ``"hp_params"``, the float32 masters); ``device="cpu"`` copies
        into host memory (page-locked when ``pin_memory`` and the engine
        is on CUDA, ``swap_tensor.pinned``), ``"nvme"`` writes
        files under ``nvme_path`` (a new folder in the temporary directory
        by default) with ``partitioned_param_swapper.AsyncTensorSwapper``.
        Each tensor's storage is released (so the model's parameters,
        which share the masters' storage, go too) and comes back at
        :meth:`reload_states`; until then ``train_batch`` and the other
        entry points raise."""
        if device not in ("cpu", "nvme"):
            raise ValueError(f"offload_states device must be 'cpu' or "
                             f"'nvme', got {device!r}")
        if self._offload is not None:
            self._offload.invalidate_staged()
        pin = bool(pin_memory) and self.device.type == "cuda"
        for what in include:
            key = "params" if what == "hp_params" else what
            if key in self._offloaded:
                raise RuntimeError(f"{what!r} is already offloaded")
            tensors, scratch = self._device_groups(key)
            away = _Away(device, tensors)
            if device == "nvme":
                from .swap_tensor.partitioned_param_swapper import \
                    AsyncTensorSwapper

                away.swapper = AsyncTensorSwapper(tempfile.mkdtemp(
                    prefix="dstpu_swap_", dir=nvme_path))
                away.swapper.swap_out(key, tensors, blocking=not non_blocking)
            else:
                from .swap_tensor.pinned import pinned_empty

                for k, t in tensors.items():
                    away.host[k] = pinned_empty(t.shape, t.dtype) if pin \
                        else torch.empty(t.shape, dtype=t.dtype)
                    away.host[k].copy_(t, non_blocking=pin and non_blocking)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            away.sizes = {k: self._free_storage(t)
                          for k, t in tensors.items()}
            away.scratch = [(t, self._free_storage(t)) for t in scratch]
            self._offloaded[key] = away

    @torch.no_grad()
    def reload_states(self, non_blocking: bool = False) -> None:
        """Bring back what :meth:`offload_states` moved: each tensor's
        storage is re-made on the device and its values copied in."""
        for key, away in list(self._offloaded.items()):
            for k, t in away.tensors.items():
                self._remake_storage(t, *away.sizes[k])
            for t, size in away.scratch:
                self._remake_storage(t, *size)
            if away.swapper is not None:
                away.swapper.swap_in(key, into=away.tensors)
                away.swapper.cleanup()
            else:
                for k, t in away.tensors.items():
                    t.copy_(away.host[k], non_blocking=non_blocking)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            del self._offloaded[key]

    def _require_states(self, what: str) -> None:
        if self._offloaded:
            raise RuntimeError(
                f"{what}() while {sorted(self._offloaded)} is offloaded by "
                f"offload_states(): call reload_states() first")

    # ------------------------------------------------------------------ #
    # Checkpointing (the universal layout; JAX engine signatures)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        save_latest: bool = True,
                        exclude_frozen_parameters: bool = False) -> bool:
        """Save the run as ``save_dir/tag`` (default ``global_step{n}``)
        and, with ``save_latest``, commit it as ``latest``.
        ``client_state`` must be JSON-serialisable (tensors become
        lists). ``exclude_frozen_parameters`` is accepted and, as in the
        JAX engine, has no effect: every master is saved."""
        self._require_states("save_checkpoint")
        tag = tag or f"global_step{self.global_steps}"
        leaves = {}
        for name, p in self.params.items():
            leaves[universal_name(name)] = {
                "param": p.detach(), **self._state_owner.named_state(name)}
        scheduler = self.lr_scheduler.state_dict() \
            if hasattr(self.lr_scheduler, "state_dict") else None
        meta = {
            "global_steps": self.global_steps,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "optimizer": {"type": type(self.optimizer).__name__,
                          "count": self.optimizer.count},
            "loss_scaler": dataclasses.asdict(self.scaler_state),
            "lr_scheduler": scheduler,
            "client_state": client_state or {},
            "config": {"zero_stage": self.config.zero_stage,
                       "world_size": self.dp_world_size},
        }
        # the ranks' masters are equal: rank 0 writes, the others wait, so
        # no two processes ever write one tag
        comm.barrier()
        if self.dp_rank == 0:
            store = NumpyCheckpointEngine(save_dir)
            store.save({"leaves": leaves, "meta": meta,
                        "step": self.global_steps}, tag)
            if save_latest:
                store.commit(tag)
            logger.info(f"saved checkpoint {save_dir}/{tag}")
        comm.barrier()
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False
                        ) -> Tuple[Optional[str], dict]:
        """Restore ``load_dir/tag``; ``tag=None`` takes the committed
        ``latest``, falling back to the newest valid committed tag, or
        reads ``load_dir`` itself when it is a universal directory (it
        holds ``index.json``). A damaged explicit tag raises
        ``CheckpointCorruptError``. With ``load_module_only`` or without
        ``load_optimizer_states`` only the masters are restored, as in the
        JAX engine. ``load_module_strict`` requires the checkpoint's
        parameter names to be the engine's. → ``(path, client_state)``, or
        ``(None, {})`` when there is nothing to load."""
        self._require_states("load_checkpoint")
        if tag is None and os.path.exists(os.path.join(load_dir, INDEX_FILE)):
            load_dir, tag = os.path.split(os.path.abspath(load_dir))
        store = NumpyCheckpointEngine(load_dir)
        if tag is None:
            tag = store.latest_tag()
            if tag is None:
                logger.warning(f"no (valid) checkpoint found under {load_dir}")
                return None, {}
        ckpt = store.load(None, tag)
        leaves, meta = ckpt["leaves"], ckpt["meta"]
        names = {name: universal_name(name) for name in self.params}
        missing = sorted(n for n, u in names.items() if u not in leaves)
        extra = sorted(set(leaves) - set(names.values()))
        if load_module_strict and (missing or extra):
            raise ValueError(f"checkpoint {ckpt['path']} does not match the "
                             f"engine's parameters: missing {missing}, "
                             f"unexpected {extra}")
        full = load_optimizer_states and not load_module_only
        absent = set()
        with torch.no_grad():
            for name, p in self.params.items():
                rec = leaves.get(names[name])
                if rec is None:
                    continue
                p.copy_(rec["param"])
                if full:
                    absent |= self._state_owner.load_named_state(name, rec)
        if absent:
            logger.warning(
                f"checkpoint {ckpt['path']} holds no {sorted(absent)} for "
                f"{type(self.optimizer).__name__}: that optimizer state "
                f"starts from its initial value")
        if full:
            self._restore_counters(meta, ckpt["step"])
        if load_lr_scheduler_states and meta and meta.get("lr_scheduler") \
                and hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        logger.info(f"loaded checkpoint {ckpt['path']}")
        return ckpt["path"], (meta or {}).get("client_state", {})

    def _restore_counters(self, meta: Optional[dict], step: int) -> None:
        """The counters of a port checkpoint, or of a JAX universal export
        (no ``meta.json``): ``step`` updates, none skipped, the scaler as
        initialised."""
        if meta is None:
            self.global_steps = self.optimizer.count = step
            self.skipped_steps = 0
            self.micro_steps = step * self.gradient_accumulation_steps()
            self.scaler_state = self.loss_scaler.init()
            return
        self.global_steps = int(meta["global_steps"])
        self.skipped_steps = int(meta["skipped_steps"])
        self.micro_steps = int(meta["micro_steps"])
        self.optimizer.count = int(meta["optimizer"]["count"])
        self.scaler_state = LossScalerState(**meta["loss_scaler"])
