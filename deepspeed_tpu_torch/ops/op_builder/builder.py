"""nvcc builder for the port's CUDA kernels (counterpart of
``deepspeed_tpu/ops/op_builder/builder.py``, which builds the JAX package's
host-side C++ with g++).

Each source ``deepspeed_tpu_torch/csrc/<name>.cu`` becomes one shared
library with a plain C interface, compiled for Hopper at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

All missing libraries are compiled in parallel (one ``nvcc`` per source,
started together) and loaded with ``ctypes``. ``<hash>`` covers the source,
the shared headers and the flags, so an edit rebuilds and an unchanged tree
loads what is already built. The build directory
(``deepspeed_tpu_torch/build/``) is listed in ``.gitignore``. A missing
``nvcc`` or a failed compile raises with the compiler's output; there is no
other route to the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import torch

from ...accelerator import get_accelerator

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: the kernels' element-type codes (``enum DType`` in ``csrc/paged_common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.access(nvcc, os.X_OK):
        return nvcc
    raise RuntimeError("nvcc not found (looked on PATH and under "
                       f"{home}/bin): the port's kernels cannot be built")


class CUDAKernelBuilder:
    """Builds and loads ``csrc/*.cu``; one instance per process is enough
    (see :func:`load_kernels`)."""

    def __init__(self):
        self.csrc_dir = CSRC_DIR
        self.build_dir = BUILD_DIR
        #: compiler output of the last build, by source name (ptxas prints
        #: each kernel's registers, shared memory and spills)
        self.build_log: Dict[str, str] = {}
        self.build_seconds = 0.0

    def sources(self) -> List[str]:
        return sorted(os.path.join(self.csrc_dir, f)
                      for f in os.listdir(self.csrc_dir) if f.endswith(".cu"))

    def _headers(self) -> List[str]:
        return sorted(os.path.join(self.csrc_dir, f)
                      for f in os.listdir(self.csrc_dir) if f.endswith(".cuh"))

    def so_path(self, source: str) -> str:
        h = hashlib.sha256()
        for path in [source, *self._headers()]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        name = os.path.splitext(os.path.basename(source))[0]
        return os.path.join(self.build_dir, f"{name}-{h.hexdigest()[:16]}.so")

    def build(self) -> Dict[str, str]:
        """Compile every source whose library is missing, all at once;
        → {name: .so path}."""
        nvcc = None
        os.makedirs(self.build_dir, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {}
        out = {}
        try:
            for src in self.sources():
                name = os.path.splitext(os.path.basename(src))[0]
                so = self.so_path(src)
                out[name] = so
                if os.path.exists(so):
                    continue
                nvcc = nvcc or find_nvcc()
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, f"-I{self.csrc_dir}", "-o", tmp, src]
                jobs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, so)
            failed = []
            for name, (proc, tmp, so) in jobs.items():
                log, _ = proc.communicate()
                self.build_log[name] = log
                if proc.returncode != 0:
                    failed.append(f"--- {name} (exit {proc.returncode}) ---\n"
                                  f"{log[-4000:]}")
                else:
                    os.replace(tmp, so)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        finally:
            for proc, tmp, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0
        return out

    def load(self, device=None) -> Dict[str, ctypes.CDLL]:
        """Build what is missing and load every library. ``device=None``
        means CUDA, which must be present."""
        dev = get_accelerator().resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError(f"the CUDA kernels need a CUDA device, not {dev}")
        return {name: ctypes.CDLL(so) for name, so in self.build().items()}


_BUILDER: Optional[CUDAKernelBuilder] = None
_LIBS: Optional[Dict[str, ctypes.CDLL]] = None


def get_builder() -> CUDAKernelBuilder:
    global _BUILDER
    if _BUILDER is None:
        _BUILDER = CUDAKernelBuilder()
    return _BUILDER


def load_kernels(device=None) -> Dict[str, ctypes.CDLL]:
    """The process's loaded kernel libraries, built on first use."""
    global _LIBS
    if _LIBS is None:
        _LIBS = get_builder().load(device)
    return _LIBS


def kernel_function(lib: str, fn: str, argtypes: List):
    """The ``extern "C"`` launcher ``fn`` of ``csrc/<lib>.cu`` with its
    ctypes signature declared (``restype`` int: the launch's
    ``cudaError_t``). Builds the libraries on first use."""
    f = getattr(load_kernels()[lib], fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
