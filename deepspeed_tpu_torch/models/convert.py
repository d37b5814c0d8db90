"""JAX parameter tree ⇄ ``CausalLM`` state, by name.

The caller turns the JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX. A
nested dict ``{"layers": {"q_proj": {"kernel": ...}}}`` maps to the dotted
state key ``layers.q_proj.kernel``; the arrays keep their layout and dtype.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .transformer import CausalLM, TransformerConfig, param_shapes


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
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
