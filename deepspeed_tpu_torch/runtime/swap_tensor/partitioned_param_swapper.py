"""Tensors swapped to files and back (counterpart of
``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py``).

:class:`AsyncTensorSwapper` writes each tensor of a named group to its
own file under a swap folder and reads it back, with plain file IO: the
JAX swapper's fallback when its native aio engine is absent (the aio
engine is ROADMAP M11). ``engine.offload_states(device="nvme")`` uses it.
A tensor goes out as its raw bytes (bfloat16 too) and comes back with its
recorded dtype and shape, as a CPU tensor or copied into a given one.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch


class AsyncTensorSwapper:
    def __init__(self, swap_folder: str, aio_config=None):
        os.makedirs(swap_folder, exist_ok=True)
        self.swap_folder = swap_folder
        self._meta: Dict[str, Dict[str, dict]] = {}

    def _path(self, name: str, key: str) -> str:
        return os.path.join(self.swap_folder,
                            f"{name}.{key}".replace("/", ".") + ".swp")

    def swap_out(self, name: str, tensors: Dict[str, torch.Tensor],
                 blocking: bool = True) -> None:
        """Write every tensor of the group ``name`` to its file. Frees
        nothing by itself: the caller drops the device memory. Writes are
        synchronous (``blocking`` is accepted, as the JAX fallback's)."""
        metas = {}
        for key, t in tensors.items():
            host = t.detach().to("cpu").contiguous()
            path = self._path(name, key)
            host.view(torch.uint8).numpy().tofile(path)
            metas[key] = {"shape": tuple(host.shape), "dtype": host.dtype,
                          "path": path}
        self._meta[name] = metas

    def swap_in(self, name: str,
                into: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Read the group ``name`` back: copied into ``into``'s tensors
        when given (their device and storage), else as CPU tensors."""
        out = {}
        for key, meta in self._meta[name].items():
            raw = torch.from_numpy(np.fromfile(meta["path"], dtype=np.uint8))
            t = raw.view(meta["dtype"]).reshape(meta["shape"])
            if into is not None:
                into[key].copy_(t)
                t = into[key]
            out[key] = t
        return out

    def release(self, name: str) -> None:
        for meta in self._meta.pop(name, {}).values():
            try:
                os.remove(meta["path"])
            except OSError:
                pass

    def cleanup(self) -> None:
        for name in list(self._meta):
            self.release(name)
        shutil.rmtree(self.swap_folder, ignore_errors=True)


# Reference class-name aliases
AsyncPartitionedParameterSwapper = AsyncTensorSwapper
PartitionedOptimizerSwapper = AsyncTensorSwapper
