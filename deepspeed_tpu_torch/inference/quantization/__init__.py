"""Weight-only quantization for serving (counterpart of
``deepspeed_tpu/inference/quantization``; reference: deepspeed/inference/
quantization/).

Quantize a parameter dict's matmul-sized leaves group-wise (int8 through
K8a, or the legacy packed int4), keep the shape, dtype and width beside
each, and dequantize them back (K8b) for the forward. int8 halves the
bfloat16 weight bytes, int4 halves them again.

The functions take the port's state dict (dotted JAX names, the stacked
``[L, ...]`` leaves) or a nested dict of tensors. The leaves quantized are
the JAX rule's: floating point, at least 2-D and of at least ``min_size``
elements. A quantized leaf becomes the reference's node
``{"__q__", "__scale__", "__shape__", "__dtype__", "__bits__"}``, with
``__dtype__`` spelled as the JAX package spells it (``"bfloat16"``), so a
JAX quantized tree converted by ``models.convert.qparams_from_numpy``
dequantizes here to the JAX package's values.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from ...ops.quantizer.quantizer import get_quant_fns

_MIN_QUANT_SIZE = 1 << 14  # don't quantize tiny tensors (biases, 1-D norms)


def _is_q(node: Any) -> bool:
    return isinstance(node, Mapping) and "__q__" in node


def _map(fn, tree: Any) -> Any:
    """``fn`` over the leaves of nested mappings; quantized nodes are
    leaves."""
    if isinstance(tree, Mapping) and not _is_q(tree):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any):
    if _is_q(tree):
        yield from tree.values()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (numpy's and JAX's spelling)."""
    return str(dtype).rsplit(".", 1)[-1]


def quantize_params(params: Mapping, group_size: int = 256,
                    min_size: int = _MIN_QUANT_SIZE,
                    bits: int = 8) -> Tuple[Dict, Dict]:
    """→ (quantized dict, meta). Quantized leaves become
    ``{"__q__": int8 (packed pairs for bits=4), "__scale__": f32,
    "__shape__": ..., "__dtype__": ..., "__bits__": ...}`` on the leaf's
    device; ``bits=4`` quarters the weight bytes of bfloat16 serving."""
    quant, _ = get_quant_fns(bits)
    count = [0]

    def one(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and leaf.numel() >= min_size and leaf.dim() >= 2:
            q, s = quant(leaf, group_size)
            count[0] += 1
            return {"__q__": q, "__scale__": s,
                    "__shape__": tuple(leaf.shape),
                    "__dtype__": _dtype_name(leaf.dtype), "__bits__": bits}
        return leaf

    out = _map(one, params)
    return out, {"quantized_leaves": count[0], "group_size": group_size,
                 "bits": bits}


def dequantize_params(qparams: Mapping, dtype=torch.bfloat16) -> Dict:
    """Inverse of :func:`quantize_params`: each quantized node becomes a
    ``dtype`` tensor of its ``__shape__`` on its device."""

    def one(node):
        if _is_q(node):
            dequant = get_quant_fns(int(node.get("__bits__", 8)))[1]
            return dequant(node["__q__"], node["__scale__"],
                           shape=tuple(node["__shape__"]), dtype=dtype)
        return node

    return _map(one, qparams)


def quantized_memory_bytes(qparams: Mapping) -> int:
    """Bytes of every tensor in the (quantized) dict."""
    return sum(t.numel() * t.element_size() for t in _leaves(qparams)
               if isinstance(t, torch.Tensor))


__all__ = ["quantize_params", "dequantize_params", "quantized_memory_bytes"]
