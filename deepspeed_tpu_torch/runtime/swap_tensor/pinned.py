"""Page-locked host tensors of exactly their size, for asynchronous copies
to and from the card.

``torch.empty(..., pin_memory=True)`` takes its memory from PyTorch's
caching host allocator, which rounds every block up to a power of two: a
2.1 GB optimizer leaf holds 4.3 GB of pinned memory, and the host state
of an offloaded model can take up to twice its bytes. :func:`pinned_empty`
asks the CUDA runtime for exactly the tensor's bytes (``cudaHostAlloc``)
and wraps them in a tensor; the memory goes back (``cudaFreeHost``, after
the device has finished with it) when the last tensor on it is freed.
Page-locking ordinary tensors in place (``cudaHostRegister``) keeps the
bytes exact too but copies slower (``chip_smoke.py``'s pinned probe,
``PERF.md``). A failed allocation raises.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Tuple

import torch

from ...utils.logging import logger


def _cudart():
    """The CUDA runtime PyTorch loaded (its soname's major version)."""
    major = (torch.version.cuda or "12").split(".")[0]
    return ctypes.CDLL(f"libcudart.so.{major}")


def _free(lib, ptr: int) -> None:
    torch.cuda.synchronize()
    err = lib.cudaFreeHost(ctypes.c_void_p(ptr))
    if err != 0:
        logger.warning(f"cudaFreeHost failed with CUDA error {err}")


def pinned_empty(shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A new page-locked host tensor of ``shape`` holding exactly its
    bytes."""
    nbytes = dtype.itemsize
    for n in shape:
        nbytes *= n
    if not nbytes:
        return torch.empty(shape, dtype=dtype)
    lib = _cudart()
    ptr = ctypes.c_void_p()
    err = lib.cudaHostAlloc(ctypes.byref(ptr), ctypes.c_size_t(nbytes), 0)
    if err != 0 or not ptr.value:
        raise RuntimeError(f"cudaHostAlloc of {nbytes} bytes failed with "
                           f"CUDA error {err}")
    buf = (ctypes.c_char * nbytes).from_address(ptr.value)
    # the tensor's storage keeps ``buf`` alive; the memory goes when it goes
    weakref.finalize(buf, _free, lib, ptr.value).atexit = False
    return torch.frombuffer(buf, dtype=dtype).view(shape)
