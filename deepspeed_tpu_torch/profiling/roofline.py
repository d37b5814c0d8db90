"""Peak numbers per device kind (counterpart of
``deepspeed_tpu/profiling/roofline.py``, the part the decode roofline
reads).

One table maps device names (``torch.cuda.get_device_name``) to the dense
bf16 tensor-core peak and the HBM bandwidth. The H100 row holds the SXM
data-sheet figures that ``chip_smoke.py``'s kernel bounds use. Unknown
kinds, and the CPU, get a conservative stand-in so CPU runs produce
finite, clearly labelled utilisation numbers instead of dividing by zero.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..accelerator import get_accelerator


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak numbers for one device kind."""

    kind: str
    peak_flops: float          # dense bf16 FLOP/s per device
    hbm_bandwidth: float       # bytes/s per device

    @property
    def ridge_intensity(self) -> float:
        """Flops/byte above which the device is compute-bound."""
        return self.peak_flops / max(self.hbm_bandwidth, 1.0)


#: ordered: first substring match against the device name wins
DEVICE_SPECS = (
    DeviceSpec("H100", 989e12, 3.35e12),       # H100 SXM data sheet
)

#: conservative stand-in so CPU runs produce finite (clearly labelled)
#: utilization numbers instead of dividing by zero
CPU_FALLBACK = DeviceSpec("cpu", 1e12, 100e9)


def spec_for_kind(kind: str) -> DeviceSpec:
    """Spec from a device-name string alone. Unknown kinds get the CPU
    fallback numbers under the given name."""
    for spec in DEVICE_SPECS:
        if spec.kind.lower() in str(kind).lower():
            return dataclasses.replace(spec, kind=str(kind))
    return dataclasses.replace(CPU_FALLBACK, kind=str(kind))


def device_spec(device: Any = None) -> DeviceSpec:
    """Spec for ``device`` (``None`` means CUDA, as everywhere in the port;
    a CUDA device is looked up by its name, the CPU gets the fallback)."""
    dev = get_accelerator().resolve_device(device)
    if dev.type != "cuda":
        return CPU_FALLBACK
    return spec_for_kind(torch.cuda.get_device_name(dev))

