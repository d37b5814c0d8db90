"""Blocked (paged) KV cache in device memory (counterpart of
``deepspeed_tpu/inference/v2/ragged/kv_cache.py``; reference:
inference/v2/ragged/kv_cache.py:40).

Storage is ONE flat page pool shared by every layer:
``[num_layers * num_blocks + 1, block_size, 2 * kv_heads, head_dim]`` —
K heads at ``[..., :KV, :]``, V heads at ``[..., KV:, :]``. Layer ``l``'s
view of logical page ``p`` is physical page ``l * num_blocks + p``, so a
per-layer page table is plain metadata arithmetic (``table + l * num_blocks``)
and the paged-attention kernels need no layer index. The FINAL page is a
shared trash page that padded tokens write into.

The pool is updated IN PLACE: ``paged_kv_append`` writes new rows into
``pages`` with ``index_put_``, and the kernels read it where it lies. (The
JAX package donates the buffer through each compiled step and gets a new
array back; PyTorch tensors are mutable, so there is nothing to hand back.)
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCacheConfig:
    num_layers: int
    num_blocks: int              # logical pages per layer
    block_size: int              # tokens per page
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def total_pages(self) -> int:
        """Physical pages including the trailing shared trash page."""
        return self.num_layers * self.num_blocks + 1

    @property
    def pad_page_flag(self) -> int:
        """Layer-relative sentinel the batch wrapper marks padded tokens
        with (any value >= num_blocks routes to the trash page)."""
        return self.num_blocks


class BlockedKVCache:
    def __init__(self, config: KVCacheConfig, device: torch.device):
        self.config = config
        c = config
        self.pages = torch.zeros(
            (c.total_pages, c.block_size, 2 * c.num_kv_heads, c.head_dim),
            dtype=c.dtype, device=device)

    def mem_bytes(self) -> int:
        return self.pages.numel() * self.pages.element_size()
