"""The PyTorch port stands alone: it imports neither JAX, nor the JAX
package, nor ``ml_dtypes``, and its entry points do not fall back to the
CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO_ROOT, "deepspeed_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deepspeed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "deepspeed_tpu"
             or m.startswith("deepspeed_tpu.") or m == "ml_dtypes"
             or m.startswith("ml_dtypes."))
print(len(names))
print(",".join(bad))
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.split("\n")[-3:-1]
    assert int(n_modules) >= 15
    assert bad == "", f"the port imported {bad}"


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    n_files = 0
    for root, _, files in os.walk(PKG_DIR):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            n_files += 1
            path = os.path.join(root, fn)
            for mod in _imports(path):
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax",
                           "ml_dtypes"):
                    offenders.append(f"{os.path.relpath(path, REPO_ROOT)}: "
                                     f"{mod}")
    assert n_files >= 15
    assert offenders == []


def test_entry_points_need_cuda_unless_told_otherwise():
    """device=None means CUDA; without it the port raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     TransformerConfig)
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops.op_builder import CUDAKernelBuilder

    cfg = TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
    model = CausalLM(cfg, init_params(cfg, torch.Generator(), device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngineV2(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CUDAKernelBuilder().load()
    with pytest.raises(RuntimeError, match="CUDA kernels need a CUDA device"):
        CUDAKernelBuilder().load("cpu")
