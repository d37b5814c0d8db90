"""JAX parameter tree ⇄ ``CausalLM`` state, by name.

The caller turns the JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX. A
nested dict ``{"layers": {"q_proj": {"kernel": ...}}}`` maps to the dotted
state key ``layers.q_proj.kernel``; the arrays keep their layout and dtype.
:func:`qparams_from_numpy` does the same for a tree that the JAX
``quantize_params`` returned, keeping its quantized nodes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .transformer import CausalLM, TransformerConfig, param_shapes


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


def params_from_numpy(tree: Mapping, cfg: TransformerConfig
                      ) -> Dict[str, torch.Tensor]:
    """Nested numpy tree → ``CausalLM`` state dict (CPU tensors in the
    arrays' dtype). Raises ``ValueError`` on a missing, extra or misshaped
    leaf."""
    flat = _flatten(tree)
    expected = param_shapes(cfg)
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
        state[name] = torch.from_numpy(np.array(arr, order="C"))
    return state


def params_to_numpy(state: Union[CausalLM, Mapping[str, torch.Tensor]]
                    ) -> Dict:
    """``CausalLM`` (or its state dict) → nested numpy tree with the JAX
    names: the inverse of :func:`params_from_numpy`."""
    if isinstance(state, CausalLM):
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
