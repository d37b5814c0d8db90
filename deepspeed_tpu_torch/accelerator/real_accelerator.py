"""Device resolution for the PyTorch port (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``).

The port runs on CUDA. An entry point given ``device=None`` resolves to
``cuda`` and raises when CUDA is absent; the CPU is used only when the
caller names it (``device="cpu"``), as the CPU tests do. There is no
silent switch from one to the other.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


class CudaAccelerator:
    """The ``torch.cuda`` helpers the port needs, behind one object."""

    def resolve_device(self, device: Union[None, str, torch.device] = None
                       ) -> torch.device:
        """``None`` → ``cuda``; ``"cpu"`` → the CPU; a CUDA device must
        exist. Raises ``RuntimeError`` instead of falling back."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by "
                "default; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise RuntimeError(f"unsupported device {dev}")
        return dev

    def current_stream(self, device: Optional[torch.device] = None):
        return torch.cuda.current_stream(device)

    def synchronize(self, device: Optional[torch.device] = None) -> None:
        torch.cuda.synchronize(device)


_ACCELERATOR = CudaAccelerator()


def get_accelerator() -> CudaAccelerator:
    return _ACCELERATOR
