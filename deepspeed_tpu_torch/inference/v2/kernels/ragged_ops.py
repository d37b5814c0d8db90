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

Both kernels take any head dim up to 256 (built for padded widths 64, 128
and 256, the true hd at run time: the page pool is never copied) and any
query group G = H / KV, up to MQA; a larger head dim raises ``ValueError``.
Both take ALiBi as the reference does: ``alibi`` is a sequence of H
per-query-head slopes (:func:`alibi_slopes` gives the standard ones) and
``alibi_scaled`` picks Falcon's bias over Bloom's.

:func:`paged_kv_append` is the KV-cache write, an XLA scatter in the JAX
package, here an in-place ``index_put_``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ....accelerator import get_accelerator
from ....ops.op_builder.builder import (DTYPE_CODES, check_launch,
                                        kernel_function)

_NEG_INF = -1e30
#: the widest head dim the kernels take (padded widths 64, 128, 256)
MAX_HEAD_DIM = 256
_PADDED_HEAD_DIMS = (64, 128, 256)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, pages, kv_lens, page_table, cu_q_lens, slopes, out; T, H, KV, hd,
    # ps, S, NB; scale; alibi, vb, dtype; stream
    "ragged_paged_attention": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    # q, pages, kv_lens, page_table, slopes, out, ws; S, H, KV, hd, ps, NB;
    # scale; alibi, vb, dtype; stream
    "decode_paged_attention": [_P] * 7 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
}
#: the kernels' ALiBi modes (``enum AlibiMode`` in the sources)
_ALIBI_MODES = {None: 0, False: 1, True: 2}


def _launcher(name: str):
    """The ``<name>_launch`` C function of ``csrc/<name>.cu``, built on
    first use."""
    return kernel_function(name, f"{name}_launch", _ARGTYPES[name])


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """The standard ALiBi slopes of ``num_heads`` heads, float32 ``[H]``
    (Bloom's ``build_alibi_tensor``; the port's copy of the JAX package's
    ``models/families.py alibi_slopes``)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** (2 * i + 1)
                   for i in range(num_heads - closest)]
    return torch.tensor(slopes, dtype=torch.float32)


def _alibi_values(alibi, H: int):
    """``alibi`` (a sequence of per-query-head slopes, or None) as a tuple
    of float32 values; raises unless there are H of them."""
    if alibi is None:
        return None
    vals = tuple(torch.as_tensor(alibi, dtype=torch.float32,
                                 device="cpu").reshape(-1).tolist())
    if len(vals) != H:
        raise ValueError(f"alibi slopes must be per query head: {len(vals)} "
                         f"slopes for {H} heads")
    return vals


_SLOPE_CACHE = {}


def _slope_tensor(vals, device):
    """The float32 ``[H]`` slopes on ``device``, cached by value and device
    (no host-to-device copy on each call of the serving loop)."""
    key = (vals, str(device))
    t = _SLOPE_CACHE.get(key)
    if t is None:
        t = torch.tensor(vals, dtype=torch.float32, device=device)
        _SLOPE_CACHE[key] = t
    return t


def alibi_bias(slopes: torch.Tensor, k_pos: torch.Tensor, scale: float,
               scaled: bool) -> torch.Tensor:
    """The ALiBi bias ``[H, C]`` of the reference kernels, added to the
    scaled scores before the mask: Bloom ``slope·k_pos`` in float32;
    Falcon (``scaled``) ``bf16(slope)·bf16(k_pos)·scale``, the product of
    the two bf16 values exact in float32 and not rounded to bf16 again.
    That is what XLA computes for the reference's ``(slope.astype(bf16) *
    k_pos.astype(bf16)).astype(f32) * scale`` under ``jit`` (the Pallas
    kernels, and the JAX engine's jitted ``decode_attend_dense``): its
    simplifier drops the bf16 round trip of the product. An eager call of
    the JAX ``decode_attend_dense`` rounds the product once more."""
    if scaled:
        prod = (slopes.to(torch.bfloat16).float()[:, None]
                * k_pos.to(torch.bfloat16).float()[None, :])
        return prod * scale
    return slopes[:, None] * k_pos.float()[None, :]


def biased_scores(raw: torch.Tensor, scale: float,
                  bias: torch.Tensor) -> torch.Tensor:
    """``raw·scale + bias`` rounded once, as one fused multiply-add (XLA
    contracts the reference's ``dot * scale + bias`` so, and the kernels
    use ``fmaf``): float64 holds the float32 product exactly."""
    return (raw.double() * scale + bias.double()).float()


def padded_head_dim(hd: int) -> int:
    """The padded width the paged-attention kernels are built for (64, 128
    or 256) that holds ``hd``; raises past 256."""
    for w in _PADDED_HEAD_DIMS:
        if hd <= w:
            return w
    raise ValueError(f"paged attention kernels take head_dim <= "
                     f"{MAX_HEAD_DIM}, got {hd} (ROADMAP Queue 3)")


def copy_width(hd: int, elem: int, *tensors: torch.Tensor) -> int:
    """Bytes a copy of the kernels' row loads (16, 8, 4 or 2): the widest
    that divides a row of ``hd`` elements of ``elem`` bytes and every base
    pointer."""
    vb = 16
    while vb > elem and ((hd * elem) % vb
                         or any(t.data_ptr() % vb for t in tensors)):
        vb //= 2
    return vb


@functools.lru_cache(maxsize=None)
def decode_split_count(num_blocks: int, page_size: int) -> int:
    """K7's first-pass split count for a page table ``num_blocks`` pages
    wide of ``page_size``-row pages, as ``csrc/decode_paged_attention.cu``
    defines it (its workspace holds that many partial states a row)."""
    return kernel_function("decode_paged_attention",
                           "decode_paged_attention_nsplit",
                           [ctypes.c_int, ctypes.c_int])(num_blocks, page_size)


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


def _check_kernel_inputs(name, q, kv_pages, ints, hd):
    """What the CUDA kernels take: one CUDA device, float32 or bfloat16 q
    and pool of one dtype, contiguous int32 metadata, hd <= 256."""
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd} (ROADMAP Queue 3)")


# --------------------------------------------------------------------- #
# K6: ragged paged attention (prefill / mixed batches)
# --------------------------------------------------------------------- #
def ragged_paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_table: torch.Tensor,
                           cu_q_lens: torch.Tensor, *, num_kv_heads: int,
                           scale: Optional[float] = None, alibi=None,
                           alibi_scaled: bool = False) -> torch.Tensor:
    """Ragged causal attention over the paged KV pool, flat-token layout.

    Replaces ``deepspeed_tpu/inference/v2/kernels/ragged_ops.py``
    ``_ragged_paged_kernel``. Sequence s's query tokens sit at
    ``[cu_q_lens[s], cu_q_lens[s+1])`` of ``q`` and attend causally to its
    ``kv_lens[s]`` cached positions (seen + in flight), read through
    ``page_table[s]``; flat rows no sequence owns are padding and give 0.
    ``alibi``: H per-query-head slopes (or None); the bias ``slope·k_pos``
    (``alibi_scaled``: Falcon's ``bf16(slope)·bf16(k_pos)·scale``,
    :func:`alibi_bias`) is added to the scaled scores before the mask.
    → ``[T, H, hd]`` in q's dtype.

    On CUDA: ``csrc/ragged_paged_attention.cu``, one CTA per (tile of up
    to 64 rows, tokens x a slice of the query group, of one sequence, KV
    head). bf16: mma.sync tensor-core products, two warp groups walking
    alternate 64-position chunks, each fed by a two-stage cp.async ring
    through the page table, a base-2 softmax, the mask on diagonal and
    tail chunks only; deterministic. float32: the exact CUDA-core kernel.
    Bound
    on the H100: for long prompts the operations, ``4·H·hd·Σ causal
    pairs`` against 989 TFLOP/s in bf16; for short ones the bytes of q,
    out and each sequence's K/V context.
    """
    H, KV, G, hd, ps, S, NB = _check_shapes(q, kv_pages, kv_lens, page_table,
                                            num_kv_heads, cu_q_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    slopes = _alibi_values(alibi, H)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, kv_pages, kv_lens, page_table, cu_q_lens,
            num_kv_heads=num_kv_heads, scale=scale, alibi=slopes,
            alibi_scaled=alibi_scaled)
    ints = (kv_lens, page_table, cu_q_lens)
    _check_kernel_inputs("ragged_paged_attention", q, kv_pages, ints, hd)
    out = torch.zeros_like(q)
    slope_t = None if slopes is None else _slope_tensor(slopes, q.device)
    err = _launcher("ragged_paged_attention")(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_table.data_ptr(), cu_q_lens.data_ptr(),
        None if slope_t is None else slope_t.data_ptr(), out.data_ptr(),
        q.shape[0], H, KV, hd, ps, S, NB, float(scale),
        _ALIBI_MODES[None if slopes is None else bool(alibi_scaled)],
        copy_width(hd, q.element_size(), q, kv_pages), DTYPE_CODES[q.dtype],
        get_accelerator().current_stream(q.device).cuda_stream)
    check_launch("ragged_paged_attention", err)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_paged_attention_reference(q, kv_pages, kv_lens, page_table,
                                     cu_q_lens, *, num_kv_heads: int,
                                     scale: Optional[float] = None,
                                     alibi=None, alibi_scaled: bool = False):
    """Plain PyTorch version of :func:`ragged_paged_attention`: per
    sequence, gather its ``kv_lens`` context rows from the pages and run
    masked softmax attention in float32, the ALiBi bias (if any) added to
    the scaled scores before the mask. Columns past the context are never
    gathered, so a NaN in another sequence's or an unused page cannot
    reach a row. Reads ``cu_q_lens``/``kv_lens`` on the host."""
    H, KV, G, hd, ps, S, _ = _check_shapes(q, kv_pages, kv_lens, page_table,
                                           num_kv_heads, cu_q_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    slopes = _alibi_values(alibi, H)
    if slopes is not None:
        slopes = torch.tensor(slopes, dtype=torch.float32, device=q.device)
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
        raw = torch.einsum("thd,chd->htc", q[q0:q1].float(), k)
        k_pos = torch.arange(kvl, device=q.device)
        if slopes is None:
            scores = raw * scale
        else:
            scores = biased_scores(raw, scale, alibi_bias(
                slopes, k_pos, scale, alibi_scaled)[:, None, :])
        q_pos = kvl - n + torch.arange(n, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
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
                           scale: Optional[float] = None, alibi=None,
                           alibi_scaled: bool = False) -> torch.Tensor:
    """Paged attention for pure-decode batches: ONE query token per
    sequence. q ``[S, H, hd]``; row s attends to positions
    ``< kv_lens[s]``; rows with ``kv_lens == 0`` are padding and give 0.
    ``alibi``/``alibi_scaled`` as :func:`ragged_paged_attention`.

    Replaces ``deepspeed_tpu/inference/v2/kernels/ragged_ops.py``
    ``_decode_paged_kernel``. Bound on the H100: bytes,
    ``Σ_s kv_lens[s]·2·KV·hd·sizeof(elem)`` at 3.35 TB/s. On CUDA:
    ``csrc/decode_paged_attention.cu``, split-context (flash-decoding) in
    two launches counted as one call: pass 1 runs one block per (sequence,
    KV head, split of 64 context positions), each with all its K/V row
    copies in flight before it computes, its query heads in slices of 8,
    and writes float32 partial softmax states to a workspace this wrapper
    allocates; pass 2 merges a sequence's live splits in split order. The
    split count (:func:`decode_split_count`) comes from the page table's
    width, so the wrapper never reads ``kv_lens`` on the host, and the
    first pass's grid and workspace grow with that width (the engine's
    ``max_ctx``), not with the live context; every sum's order depends on
    context positions alone, so the output is bit-identical at every page
    size.
    """
    H, KV, G, hd, ps, S, NB = _check_shapes(q, kv_pages, kv_lens, page_table,
                                            num_kv_heads)
    if q.shape[0] != S:
        raise ValueError(f"q has {q.shape[0]} rows for {S} sequences")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    slopes = _alibi_values(alibi, H)
    if q.device.type == "cpu":
        return decode_attend_dense(q, kv_pages, kv_lens, page_table,
                                   num_kv_heads=num_kv_heads, scale=scale,
                                   alibi=slopes, alibi_scaled=alibi_scaled)
    _check_kernel_inputs("decode_paged_attention", q, kv_pages,
                         (kv_lens, page_table), hd)
    out = torch.empty_like(q)
    ws = torch.empty(S, H, decode_split_count(NB, ps),
                     padded_head_dim(hd) + 2, dtype=torch.float32,
                     device=q.device)
    slope_t = None if slopes is None else _slope_tensor(slopes, q.device)
    err = _launcher("decode_paged_attention")(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_table.data_ptr(),
        None if slope_t is None else slope_t.data_ptr(), out.data_ptr(),
        ws.data_ptr(), S, H, KV, hd, ps, NB, float(scale),
        _ALIBI_MODES[None if slopes is None else bool(alibi_scaled)],
        copy_width(hd, q.element_size(), q, kv_pages), DTYPE_CODES[q.dtype],
        get_accelerator().current_stream(q.device).cuda_stream)
    check_launch("decode_paged_attention", err)
    decode_paged_attention.launches += 1
    return out


decode_paged_attention.launches = 0


def decode_attend_dense(q, kv_pages, kv_lens, page_table, *,
                        num_kv_heads: int, scale: Optional[float] = None,
                        alibi=None, alibi_scaled: bool = False):
    """Plain PyTorch version of :func:`decode_paged_attention` (the JAX
    package's ``decode_attend_dense``): gather every sequence's whole page
    table, zero V past ``kv_lens`` before the product (select before
    multiply), the ALiBi bias (if any) added to the scaled scores, masked
    softmax in float32; padding rows give 0."""
    S, H, hd = q.shape
    _, ps, _, _ = kv_pages.shape
    KV = num_kv_heads
    G = H // KV
    NB = page_table.shape[1]
    C = NB * ps
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    slopes = _alibi_values(alibi, H)
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
    raw = torch.einsum("shd,schd->shc", q.float(), k_ctx.float())
    if slopes is None:
        scores = raw * scale
    else:
        slopes = torch.tensor(slopes, dtype=torch.float32, device=q.device)
        scores = biased_scores(raw, scale, alibi_bias(
            slopes, ctx_pos, scale, alibi_scaled)[None])
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
