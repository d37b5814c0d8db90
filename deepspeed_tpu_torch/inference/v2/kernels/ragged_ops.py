"""Paged serving attention for the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2/kernels/ragged_ops.py``).

Two kernels, written by hand in CUDA C++ for Hopper (``csrc/``), replace
the JAX package's two Pallas kernels on the serving path:

  * :func:`ragged_paged_attention` — ``csrc/ragged_paged_attention.cu``,
    replacing ``_ragged_paged_kernel`` (prefill and mixed batches);
  * :func:`decode_paged_attention` — ``csrc/decode_paged_attention.cu``,
    replacing ``_decode_paged_kernel`` (one query token per sequence).

Each wrapper keeps the JAX signature and layouts: q ``[T, H, hd]``; the
page pool ``[num_pages, page_size, 2*KV, hd]`` (K heads first, then V
heads); ``kv_lens [S]``, ``page_table [S, NB]`` and ``cu_q_lens [S+1]`` in
int32. On a CUDA tensor the wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it
(:func:`ragged_paged_attention_reference`, :func:`decode_attend_dense`),
which the CPU tests hold against the JAX kernels. Each wrapper counts its
kernel launches in a plain integer attribute, ``<wrapper>.launches``.

:func:`paged_kv_append` is the KV-cache write, an XLA scatter in the JAX
package, here an in-place ``index_put_``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ....accelerator import get_accelerator
from ....ops.op_builder.builder import (DTYPE_CODES, check_launch,
                                        kernel_function)

_NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_MAX_G = 8

_ARGTYPES = {
    "ragged_paged_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "decode_paged_attention": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _launcher(name: str):
    """The ``<name>_launch`` C function of ``csrc/<name>.cu``, built on
    first use."""
    return kernel_function(name, f"{name}_launch", _ARGTYPES[name])


def _check_shapes(q, kv_pages, kv_lens, page_table, num_kv_heads,
                  cu_q_lens=None):
    """→ (H, KV, G, hd, ps, S, NB); raises on inconsistent shapes."""
    if q.dim() != 3 or kv_pages.dim() != 4:
        raise ValueError(f"q must be [T, H, hd] and kv_pages [pages, ps, 2KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(kv_pages.shape)}")
    _, H, hd = q.shape
    _, ps, ckv, hd_k = kv_pages.shape
    KV = num_kv_heads
    if hd != hd_k:
        raise ValueError(f"head_dim mismatch {hd} vs {hd_k}")
    if ckv != 2 * KV:
        raise ValueError(f"kv_pages combined-head dim {ckv} != 2*{KV}")
    if H % KV != 0:
        raise ValueError("query heads must be a multiple of kv heads")
    if page_table.dim() != 2:
        raise ValueError("page_table must be [S, NB]")
    S, NB = page_table.shape
    if tuple(kv_lens.shape) != (S,):
        raise ValueError(f"kv_lens must be [{S}], got {tuple(kv_lens.shape)}")
    if cu_q_lens is not None and tuple(cu_q_lens.shape) != (S + 1,):
        raise ValueError(f"cu_q_lens must be [{S + 1}], "
                         f"got {tuple(cu_q_lens.shape)}")
    return H, KV, H // KV, hd, ps, S, NB


def _check_kernel_inputs(name, q, kv_pages, ints, G, hd):
    """What the CUDA kernels take: one CUDA device, float32 or bfloat16 q
    and pool of one dtype, contiguous int32 metadata, hd in {64, 128},
    G <= 8, 16-byte aligned q and pool."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not {dev}")
    for t in (kv_pages, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, "
                             f"got one on {t.device}")
    if q.dtype not in DTYPE_CODES or kv_pages.dtype != q.dtype:
        raise ValueError(f"{name}: q and kv_pages must both be float32 or "
                         f"bfloat16, got {q.dtype} and {kv_pages.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: metadata must be int32, got {t.dtype}")
    for t in (q, kv_pages, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel supports head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")
    if G > _KERNEL_MAX_G:
        raise ValueError(f"{name}: the kernel supports at most "
                         f"{_KERNEL_MAX_G} query heads per kv head, got {G}")
    for t in (q, kv_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q and kv_pages must be 16-byte aligned")


# --------------------------------------------------------------------- #
# K6: ragged paged attention (prefill / mixed batches)
# --------------------------------------------------------------------- #
def ragged_paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_table: torch.Tensor,
                           cu_q_lens: torch.Tensor, *, num_kv_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Ragged causal attention over the paged KV pool, flat-token layout.

    Replaces ``deepspeed_tpu/inference/v2/kernels/ragged_ops.py``
    ``_ragged_paged_kernel``. Sequence s's query tokens sit at
    ``[cu_q_lens[s], cu_q_lens[s+1])`` of ``q`` and attend causally to its
    ``kv_lens[s]`` cached positions (seen + in flight), read through
    ``page_table[s]``; flat rows no sequence owns are padding and give 0.
    → ``[T, H, hd]`` in q's dtype.

    On CUDA: ``csrc/ragged_paged_attention.cu``, one block per (query tile
    of one sequence, KV head). Bound on the H100: for long prompts the
    operations, ``4·H·hd·Σ causal pairs`` against 989 TFLOP/s in bf16;
    for short ones the bytes of q, out and each sequence's K/V context.
    The simple design computes on CUDA cores without tensor cores or
    asynchronous copies (see the source's notes).
    """
    H, KV, G, hd, ps, S, NB = _check_shapes(q, kv_pages, kv_lens, page_table,
                                            num_kv_heads, cu_q_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, kv_pages, kv_lens, page_table, cu_q_lens,
            num_kv_heads=num_kv_heads, scale=scale)
    ints = (kv_lens, page_table, cu_q_lens)
    _check_kernel_inputs("ragged_paged_attention", q, kv_pages, ints, G, hd)
    out = torch.zeros_like(q)
    err = _launcher("ragged_paged_attention")(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_table.data_ptr(), cu_q_lens.data_ptr(), out.data_ptr(),
        q.shape[0], H, KV, hd, ps, S, NB, float(scale),
        DTYPE_CODES[q.dtype], get_accelerator().current_stream(q.device).cuda_stream)
    check_launch("ragged_paged_attention", err)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_paged_attention_reference(q, kv_pages, kv_lens, page_table,
                                     cu_q_lens, *, num_kv_heads: int,
                                     scale: Optional[float] = None):
    """Plain PyTorch version of :func:`ragged_paged_attention`: per
    sequence, gather its ``kv_lens`` context rows from the pages and run
    masked softmax attention in float32. Columns past the context are never
    gathered, so a NaN in another sequence's or an unused page cannot
    reach a row. Reads ``cu_q_lens``/``kv_lens`` on the host."""
    H, KV, G, hd, ps, S, _ = _check_shapes(q, kv_pages, kv_lens, page_table,
                                           num_kv_heads, cu_q_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    cu = cu_q_lens.tolist()
    kvls = kv_lens.tolist()
    for s in range(S):
        q0, q1, kvl = cu[s], cu[s + 1], kvls[s]
        n = q1 - q0
        if n <= 0 or kvl <= 0:
            continue
        n_pages = -(-kvl // ps)
        ctx = kv_pages[page_table[s, :n_pages].long()].reshape(
            n_pages * ps, 2 * KV, hd)[:kvl].float()
        k = ctx[:, :KV].repeat_interleave(G, dim=1)             # [kvl, H, hd]
        v = ctx[:, KV:].repeat_interleave(G, dim=1)
        scores = torch.einsum("thd,chd->htc", q[q0:q1].float(), k) * scale
        q_pos = kvl - n + torch.arange(n, device=q.device)
        mask = torch.arange(kvl, device=q.device)[None, :] <= q_pos[:, None]
        scores = torch.where(mask[None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out[q0:q1] = torch.einsum("htc,chd->thd", probs, v)
    return out.to(q.dtype)


# --------------------------------------------------------------------- #
# K7: decode paged attention (one query token per sequence)
# --------------------------------------------------------------------- #
def decode_paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_table: torch.Tensor, *,
                           num_kv_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Paged attention for pure-decode batches: ONE query token per
    sequence. q ``[S, H, hd]``; row s attends to positions
    ``< kv_lens[s]``; rows with ``kv_lens == 0`` are padding and give 0.

    Replaces ``deepspeed_tpu/inference/v2/kernels/ragged_ops.py``
    ``_decode_paged_kernel``. On CUDA: ``csrc/decode_paged_attention.cu``,
    one block per (sequence, KV head). Bound on the H100: bytes,
    ``Σ_s kv_lens[s]·2·KV·hd·sizeof(elem)`` at 3.35 TB/s. The simple design
    leaves the card under-filled at small batch (S·KV blocks) and walks
    each context serially; splitting the context (flash-decoding) is later
    work.
    """
    H, KV, G, hd, ps, S, NB = _check_shapes(q, kv_pages, kv_lens, page_table,
                                            num_kv_heads)
    if q.shape[0] != S:
        raise ValueError(f"q has {q.shape[0]} rows for {S} sequences")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return decode_attend_dense(q, kv_pages, kv_lens, page_table,
                                   num_kv_heads=num_kv_heads, scale=scale)
    _check_kernel_inputs("decode_paged_attention", q, kv_pages,
                         (kv_lens, page_table), G, hd)
    out = torch.empty_like(q)
    err = _launcher("decode_paged_attention")(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_table.data_ptr(), out.data_ptr(), S, H, KV, hd, ps, NB,
        float(scale), DTYPE_CODES[q.dtype],
        get_accelerator().current_stream(q.device).cuda_stream)
    check_launch("decode_paged_attention", err)
    decode_paged_attention.launches += 1
    return out


decode_paged_attention.launches = 0


def decode_attend_dense(q, kv_pages, kv_lens, page_table, *,
                        num_kv_heads: int, scale: Optional[float] = None):
    """Plain PyTorch version of :func:`decode_paged_attention` (the JAX
    package's ``decode_attend_dense``): gather every sequence's whole page
    table, zero V past ``kv_lens`` before the product (select before
    multiply), masked softmax in float32; padding rows give 0."""
    S, H, hd = q.shape
    _, ps, _, _ = kv_pages.shape
    KV = num_kv_heads
    G = H // KV
    NB = page_table.shape[1]
    C = NB * ps
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    ctx_pos = torch.arange(C, device=q.device)
    pg = page_table[:, ctx_pos // ps].long()                    # [S, C]
    off = (ctx_pos % ps)[None, :].expand(S, C)
    ctx = kv_pages[pg, off]                                     # [S, C, 2KV, hd]
    k_ctx, v_ctx = ctx[..., :KV, :], ctx[..., KV:, :]
    valid = ctx_pos[None, :] < kv_lens[:, None]                 # [S, C]
    v_ctx = torch.where(valid[:, :, None, None], v_ctx,
                        torch.zeros((), dtype=v_ctx.dtype, device=q.device))
    if G != 1:
        k_ctx = k_ctx.repeat_interleave(G, dim=2)
        v_ctx = v_ctx.repeat_interleave(G, dim=2)
    scores = torch.einsum("shd,schd->shc", q.float(), k_ctx.float()) * scale
    mask = valid[:, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("shc,schd->shd", probs, v_ctx.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------- #
# Paged KV append (linear_blocked_kv_rotary's cache-update half)
# --------------------------------------------------------------------- #
def paged_kv_append(kv_pages: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    page_of_token: torch.Tensor,
                    off_of_token: torch.Tensor) -> torch.Tensor:
    """Write new K/V rows into their cache pages, IN PLACE.

    kv_pages ``[num_pages, page_size, 2*KV, hd]``; k/v ``[T, KV, hd]``;
    page_of_token/off_of_token ``[T]`` (padded tokens target the trash
    page, where duplicate writes are harmless). Returns ``kv_pages``."""
    comb = torch.cat([k, v], dim=1).to(kv_pages.dtype)
    kv_pages.index_put_((page_of_token.long(), off_of_token.long()), comb)
    return kv_pages
