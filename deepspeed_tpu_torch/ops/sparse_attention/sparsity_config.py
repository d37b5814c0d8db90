"""Block-sparse attention layouts for the port (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, which the port
does not import; reference: deepspeed/ops/sparse_attention/
sparsity_config.py — Dense/Fixed/BigBird/Longformer/Variable patterns).

A layout is a [heads, num_blocks, num_blocks] bool array over attention
blocks; the sparse kernels only compute blocks where layout=True. The
classes draw their random blocks from ``random.Random(seed)`` in the JAX
package's order, so both packages build the same layouts bit for bit.
"""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def num_layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def _broadcast(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global columns (reference Fixed pattern)."""

    def __init__(self, num_heads: int, block: int = 16, num_local_blocks: int = 4,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1, **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_layout_heads()):
            # local windows
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                layout[h, start:end, start:end] = True
            # global: first num_global_blocks of each window attend/attended
            pattern = h % self.num_different_global_patterns
            for start in range(0, n, self.num_local_blocks):
                g0 = start + pattern * self.num_global_blocks
                g1 = min(g0 + self.num_global_blocks, n)
                layout[h, :, g0:g1] = True        # vertical (everyone → global)
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=bool))
            layout &= tril[None]
        return self._broadcast(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global tokens (reference BSLongformer)."""

    def __init__(self, num_heads: int, block: int = 16, num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional", **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads()):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = True
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices, self.global_block_end_indices)
            else:
                spans = [(i, i + 1) for i in self.global_block_indices]
            for g0, g1 in spans:
                layout[h, :, g0:g1] = True
                layout[h, g0:g1, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self._broadcast(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global blocks (reference BigBird)."""

    def __init__(self, num_heads: int, block: int = 16, num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3, num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0, **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = random.Random(self.seed)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads()):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = True
                for _ in range(self.num_random_blocks):
                    layout[h, i, rng.randrange(n)] = True
            g = self.num_global_blocks
            layout[h, :, :g] = True
            layout[h, :g, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self._broadcast(layout)


class VariableSparsityConfig(SparsityConfig):
    """Mixed local window sizes + globals (reference Variable)."""

    def __init__(self, num_heads: int, block: int = 16, num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional", seed: int = 0, **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = random.Random(self.seed)
        for h in range(self.num_layout_heads()):
            start = 0
            windows = list(self.local_window_blocks)
            while start < n:
                w = windows[0] if len(windows) == 1 else windows.pop(0)
                end = min(start + w, n)
                layout[h, start:end, start:end] = True
                start = end
            for g in self.global_block_indices:
                if g < n:
                    layout[h, :, g] = True
                    layout[h, g, :] = True
            for i in range(n):
                for _ in range(self.num_random_blocks):
                    layout[h, i, rng.randrange(n)] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self._broadcast(layout)
