"""JAX parameter tree ⇄ ``CausalLM`` or ``UniversalCausalLM`` state, by
name.

The caller turns the JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX. A
nested dict ``{"layers": {"q_proj": {"kernel": ...}}}`` maps to the dotted
state key ``layers.q_proj.kernel``; the arrays keep their layout and dtype.
The config picks the expected tree: a ``TransformerConfig`` the JAX
``init_params`` one, an ``ArchConfig`` the JAX ``init_universal_params``
one.
:func:`qparams_from_numpy` does the same for a tree that the JAX
``quantize_params`` returned, keeping its quantized nodes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from torch import nn

from .families import ArchConfig, universal_param_shapes
from .transformer import TransformerConfig, is_router, param_shapes


def _is_q(node: Any) -> bool:
    return isinstance(node, Mapping) and "__q__" in node


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping) and not _is_q(val):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = val
    return flat


def params_from_numpy(tree: Mapping,
                      cfg: Union[TransformerConfig, ArchConfig]
                      ) -> Dict[str, torch.Tensor]:
    """Nested numpy tree → ``CausalLM`` (or, for an ``ArchConfig``,
    ``UniversalCausalLM``) state dict (CPU tensors in the arrays' dtype;
    a MoE router float32 whatever its array's). Raises ``ValueError`` on
    a missing, extra or misshaped leaf."""
    flat = _flatten(tree)
    expected = universal_param_shapes(cfg) if isinstance(cfg, ArchConfig) \
        else param_shapes(cfg)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise ValueError(f"parameter tree does not match the config: "
                         f"missing {missing}, extra {extra}")
    state = {}
    for name, shape in expected.items():
        arr = np.asarray(flat[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        t = _tensor(arr)
        state[name] = t.float() if is_router(name) else t
    return state


def params_to_numpy(state: Union[nn.Module, Mapping[str, torch.Tensor]]
                    ) -> Dict:
    """``CausalLM`` or ``UniversalCausalLM`` (or its state dict) → nested
    numpy tree with the JAX names: the inverse of
    :func:`params_from_numpy`."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: Dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def _tensor(arr) -> torch.Tensor:
    """numpy array → CPU tensor; a bfloat16 array (numpy has no such type:
    JAX hands over ``ml_dtypes``' one) is carried by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def qparams_from_numpy(tree: Mapping) -> Dict[str, Any]:
    """A JAX ``quantize_params`` tree turned into numpy leaf by leaf →
    the port's form: dotted name → CPU tensor, or → quantized node
    ``{"__q__": int8 tensor, "__scale__": f32 tensor, "__shape__": tuple,
    "__dtype__": str, "__bits__": int}`` (``jax.tree.map`` has made the
    node's shape, dtype and width 0-d arrays; they become Python values
    again). ``inference.quantization.dequantize_params`` takes the
    result."""
    out = {}
    for name, val in _flatten(tree).items():
        if _is_q(val):
            out[name] = {"__q__": _tensor(val["__q__"]),
                         "__scale__": _tensor(val["__scale__"]),
                         "__shape__": tuple(int(d) for d in val["__shape__"]),
                         "__dtype__": str(np.asarray(val["__dtype__"])),
                         "__bits__": int(np.asarray(val.get("__bits__", 8)))}
        else:
            out[name] = _tensor(val)
    return out
