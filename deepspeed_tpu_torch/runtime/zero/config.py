"""The ``zero_optimization`` block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``), read as the JAX package reads
it: the same keys, defaults, ``stage3_*`` aliases and the deprecated
``cpu_offload``. Unknown keys are ignored with a warning, as there.

On one device the port acts on ``stage`` (reported; stages 1-3 train as
stage 0, since the JAX sharding plan replicates every array at ZeRO size
1), ``offload_optimizer.device: cpu`` with ``ratio``, ``buffer_count`` and
``pipeline_read``, and the ZeRO++ flags. Like the JAX engine it accepts
``offload_param`` and ``offload_optimizer.device: nvme`` and acts on
neither (the JAX engine reads only ``offload_optimizer_device() ==
"cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ...utils.logging import logger

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _build(cls, raw: Dict[str, Any], aliases: Dict[str, str] = None):
    """``cls`` from a dict: aliases renamed, unknown keys warned about and
    dropped, ``ge=0`` fields checked by the class."""
    raw = dict(raw or {})
    for alias, name in (aliases or {}).items():
        if alias in raw:
            raw[name] = raw.pop(alias)
    names = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(raw) - names)
    if extra:
        logger.warning(f"{cls.__name__}: unknown config keys ignored: "
                       f"{extra}")
    return cls(**{k: v for k, v in raw.items() if k in names})


def _device(value: Any) -> str:
    value = "none" if value is None else str(value)
    if value not in OFFLOAD_DEVICES:
        raise ValueError(f"offload device must be one of {OFFLOAD_DEVICES}, "
                         f"got {value!r}")
    return value


def _non_negative(obj, *names: str) -> None:
    for name in names:
        if getattr(obj, name) < 0:
            raise ValueError(f"{type(obj).__name__}.{name} must be >= 0, "
                             f"got {getattr(obj, name)}")


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig:
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def __post_init__(self):
        self.device = _device(self.device)


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig:
    device: str = "none"
    nvme_path: Optional[str] = None
    #: device buffers of the streamed update's ring
    buffer_count: int = 4
    pin_memory: bool = False
    #: stage the first ring's worth of host state before the forward
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    #: share of the optimizer state's bytes on the host: 1.0 all of it;
    #: 0 < ratio < 1 splits each leaf (Twin-Flow, ``twin_flow.py``)
    ratio: float = 1.0

    def __post_init__(self):
        self.device = _device(self.device)
        if self.buffer_count < 1:
            raise ValueError(f"offload_optimizer.buffer_count must be >= 1, "
                             f"got {self.buffer_count}")


_STAGE3_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_model_persistence_threshold": "model_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save":
        "gather_16bit_weights_on_model_save",
}


@dataclasses.dataclass
class DeepSpeedZeroConfig:
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    cpu_offload: Optional[bool] = None  # deprecated alias

    # stage-3 knobs, also read under their ``stage3_`` names
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 2 ** 63 - 1
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False

    # ZeRO++
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    #: LoCo error feedback on the quantized gradient wire
    zeropp_loco: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    override_module_apply: bool = True
    log_trace_cache_warnings: bool = False

    def __post_init__(self):
        _non_negative(self, "reduce_bucket_size", "allgather_bucket_size",
                      "sub_group_size", "prefetch_bucket_size",
                      "param_persistence_threshold",
                      "model_persistence_threshold", "max_live_parameters",
                      "max_reuse_distance", "zero_hpz_partition_size")
        if isinstance(self.offload_param, dict):
            self.offload_param = _build(DeepSpeedZeroOffloadParamConfig,
                                        self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = _build(
                DeepSpeedZeroOffloadOptimizerConfig, self.offload_optimizer)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "DeepSpeedZeroConfig":
        return _build(cls, raw, _STAGE3_ALIASES)

    def offload_optimizer_device(self) -> str:
        if self.cpu_offload:
            return "cpu"
        return self.offload_optimizer.device if self.offload_optimizer \
            else "none"

    def offload_param_device(self) -> str:
        return self.offload_param.device if self.offload_param else "none"
