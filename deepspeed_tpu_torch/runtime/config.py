"""Training config for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/config.py``).

``DeepSpeedConfig`` reads the keys the train path uses, under the
reference framework's JSON names: ``train_batch_size``,
``train_micro_batch_size_per_gpu``, ``gradient_accumulation_steps``,
``optimizer``, ``scheduler``, ``gradient_clipping``,
``zero_optimization`` (``stage`` and ZeRO++'s
``zero_quantized_gradients`` and ``zeropp_loco``), ``fp16``, ``bf16`` and
``checkpoint``. The batch solve and its ``ValueError``s are the JAX
package's, with the data-parallel size of the topology it is given (the
world size; 1 without one). The ``checkpoint`` block takes the JAX fields
and, like the JAX package, acts on none of them: the port's saves are
synchronous whatever ``async_save`` says. ``zero_quantized_weights``
(qwZ) is, as in the JAX package, ignored with a warning below stage 3.

A block the JAX package honours but the port does not implement yet
raises ``NotImplementedError`` naming its ``ROADMAP.md`` item, instead of
being ignored. Keys neither package knows are ignored, as the JAX package
ignores them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

import torch

from ..utils.logging import logger

# top-level blocks the JAX package honours that the port does not
# implement yet → the ROADMAP item that ports them
_NOT_PORTED = {
    "overlap": "M6 (ZeRO 1-3 and comm/compute overlap)",
    "sparse_gradients": "M8 (quantized and sparse comm)",
    "communication_data_type": "M6",
    "activation_checkpointing": "M9 (remat comes from TransformerConfig."
                                "remat in the port)",
    "pipeline": "M9 (other parallelism)",
    "tensor_parallel": "M9",
    "autotp": "M9",
    "sequence_parallel_size": "M9",
    "moe": "M9",
    "data_efficiency": "M10 (model and feature breadth)",
    "curriculum_learning": "M10",
    "compression_training": "M10",
    "telemetry": "M11 (operational planes)",
    "comms_logger": "M11",
    "profiling": "M11",
    "flops_profiler": "M11",
    "tensorboard": "M11",
    "csv_monitor": "M11",
    "wandb": "M11",
    "comet": "M11",
    "fault": "M11",
    "elasticity": "M11",
    "autotuning": "M11",
    "aio": "M11",
    "debug": "M11",
}


def _enabled(value: Any) -> bool:
    """Whether a not-ported block asks for something: a dict with an
    ``enabled`` gate when enabled, any other dict when a value in it is
    set, a flag when true, any other scalar unless it is the default
    (``sequence_parallel_size: 1``, ``communication_data_type: "fp32"``)."""
    if isinstance(value, dict):
        if "enabled" in value:
            return bool(value["enabled"])
        return any(bool(v) for v in value.values())
    if isinstance(value, bool) or value is None:
        return bool(value)
    return value not in (1, "fp32")


@dataclasses.dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0            # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False


@dataclasses.dataclass
class CheckpointConfig:
    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = dataclasses.field(default_factory=dict)
    async_save: bool = True


@dataclasses.dataclass
class ZeroConfig:
    stage: int = 0
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    #: LoCo error feedback on the quantized gradient wire
    zeropp_loco: bool = False


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "Adam"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _block(cls, raw: Optional[Dict[str, Any]]):
    """A sub-config from its dict; unknown keys are ignored (the JAX
    package warns and ignores them too)."""
    raw = raw or {}
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


class DeepSpeedConfig:
    """The train path's config: ``config`` is a dict or a JSON file path;
    ``topology`` (a ``runtime.topology.MeshTopology``) sets the
    data-parallel size of the batch solve."""

    def __init__(self, config: Union[str, Dict[str, Any], None] = None,
                 topology=None):
        if config is None:
            config = {}
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise TypeError(f"config must be dict or path, got {type(config)}")
        self.raw: Dict[str, Any] = config

        self.train_batch_size: Optional[int] = config.get("train_batch_size")
        self.train_micro_batch_size_per_gpu: Optional[int] = config.get(
            "train_micro_batch_size_per_gpu")
        self.gradient_accumulation_steps: Optional[int] = config.get(
            "gradient_accumulation_steps")
        self.gradient_clipping: float = config.get("gradient_clipping", 0.0)

        self.fp16 = _block(FP16Config, config.get("fp16"))
        self.bf16 = _block(BF16Config,
                           config.get("bf16", config.get("bfloat16")))
        self.optimizer = _block(OptimizerConfig, config["optimizer"]) \
            if "optimizer" in config else None
        self.scheduler = _block(SchedulerConfig, config["scheduler"]) \
            if "scheduler" in config else None
        self.checkpoint_config = _block(CheckpointConfig,
                                        config.get("checkpoint"))
        zero = dict(config.get("zero_optimization", {}) or {})
        self.zero_config = _block(ZeroConfig, zero)
        self.zero_stage: int = self.zero_config.stage
        self._topology = topology

        self._resolve_batch()
        self._sanity_check()
        self._refuse_not_ported(config, zero)
        if self.zero_config.zero_quantized_weights and self.zero_stage < 3:
            logger.warning("zero_quantized_weights ignored below ZeRO "
                           "stage 3")

    @property
    def dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    def data_parallel_size(self) -> int:
        if self._topology is not None:
            return self._topology.get_data_parallel_world_size()
        return 1

    def _resolve_batch(self) -> None:
        """Solve train = micro * gas * dp for whichever terms are missing
        (the JAX ``_resolve_batch``)."""
        dp = self.data_parallel_size()
        train, micro, gas = (self.train_batch_size,
                             self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
        elif micro is not None:
            gas = 1
            train = micro * dp
        else:
            micro, gas = 1, 1
            train = dp
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def _sanity_check(self) -> None:
        dp = self.data_parallel_size()
        t, m, g = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                   self.gradient_accumulation_steps)
        if t != m * g * dp:
            raise ValueError(
                f"batch config invalid: train_batch_size={t} != micro({m}) * "
                f"gas({g}) * dp({dp})")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero stage must be 0-3, got {self.zero_stage}")

    @staticmethod
    def _refuse_not_ported(config: Dict[str, Any],
                           zero: Dict[str, Any]) -> None:
        if zero.get("stage", 0) > 0:
            raise NotImplementedError(
                f"zero_optimization.stage={zero['stage']} is not ported yet "
                f"(ROADMAP M6); the port trains with stage 0")
        for key in ("offload_optimizer", "offload_param"):
            block = zero.get(key) or {}
            if block.get("device", "none") not in ("none", None):
                raise NotImplementedError(
                    f"zero_optimization.{key} is not ported yet (ROADMAP M6)")
        if zero.get("overlap_comm"):
            raise NotImplementedError(
                "zero_optimization.overlap_comm is not ported yet "
                "(ROADMAP M6)")
        if zero.get("zero_hpz_partition_size", 1) > 1 \
                or zero.get("mics_shard_size", -1) > 0:
            raise NotImplementedError(
                "hpZ/MiCS shard groups (zero_hpz_partition_size, "
                "mics_shard_size) are not ported yet (ROADMAP M6)")
        for key, item in _NOT_PORTED.items():
            if key in config and _enabled(config[key]):
                raise NotImplementedError(
                    f"config block {key!r} is not ported yet (ROADMAP {item})")
