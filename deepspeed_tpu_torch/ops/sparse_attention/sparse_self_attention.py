"""Sparse self-attention for the port (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``; reference:
deepspeed/ops/sparse_attention/sparse_self_attention.py +
bert_sparse_self_attention.py).

Two paths share the layout classes. ``use_kernel=True`` takes the
block-sparse kernels (block_sparse_kernel.py: masked blocks cost nothing,
differentiable through the dQ and dK/dV kernels), for serving and
training. The masked-dense path is plain PyTorch, as it is plain jnp in
the reference: it carries the rpe/padding/attn-mask extras with the
reference's arithmetic, and is the numerics oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .block_sparse_kernel import attend, prepare_layout
from .sparsity_config import DenseSparsityConfig, SparsityConfig


class SparseSelfAttention:
    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config or DenseSparsityConfig(
            num_heads=1)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}
        self._masks = {}

    def layout(self, seq_len: int) -> np.ndarray:
        """The config's ``[heads, n, n]`` block layout, built once per S."""
        if seq_len not in self._layouts:
            self._layouts[seq_len] = np.asarray(
                self.sparsity_config.make_layout(seq_len))
        return self._layouts[seq_len]

    def token_mask(self, seq_len: int, device=None) -> torch.Tensor:
        """[heads, S, S] bool mask expanded from the block layout."""
        key = (seq_len, str(torch.device(device or "cpu")))
        if key not in self._masks:
            b = self.sparsity_config.block
            mask = np.kron(self.layout(seq_len), np.ones((b, b), dtype=bool))
            self._masks[key] = torch.from_numpy(mask).to(device or "cpu")
        return self._masks[key]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None, use_kernel: bool = False):
        """q/k/v: [B, H, S, hd] (reference layout). Returns [B, H, S, hd].

        ``use_kernel=True`` takes the block-sparse kernels (the no-LSE
        forward when no gradient will be taken; the forward with the LSE
        and the dQ, dK/dV kernels otherwise) but not the
        rpe/padding/attn-mask extras; those keep the masked-dense path."""
        B, H, S, hd = query.shape
        if use_kernel:
            if rpe is not None or key_padding_mask is not None or \
                    attn_mask is not None:
                raise ValueError("kernel path takes the plain layout only")
            tables = prepare_layout(self.layout(S), self.sparsity_config.block,
                                    H, query.device)
            return attend(query, key, value, tables)
        mask = self.token_mask(S, query.device)                 # [Hl, S, S]
        if mask.shape[0] == 1:
            mask = mask.expand(H, S, S)
        scores = torch.einsum("bhqd,bhkd->bhqk", query, key) / torch.sqrt(
            torch.tensor(hd, dtype=query.dtype, device=query.device))
        if rpe is not None:
            scores = scores + rpe
        neg = torch.tensor(torch.finfo(torch.float32).min,
                           device=scores.device).to(scores.dtype)
        scores = torch.where(mask[None], scores, neg)
        if key_padding_mask is not None:
            pad = key_padding_mask[:, None, None, :]
            scores = scores + pad if self.key_padding_mask_mode == "add" else \
                torch.where(pad.bool(), scores, neg)
        if attn_mask is not None:
            scores = scores * attn_mask if self.attn_mask_mode == "mul" else \
                scores + attn_mask
        probs = torch.softmax(scores.float(), dim=-1).to(query.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, value)


class BertSparseSelfAttention(SparseSelfAttention):
    """Reference class alias (bert_sparse_self_attention.py)."""
