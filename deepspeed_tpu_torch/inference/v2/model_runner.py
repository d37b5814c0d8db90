"""Ragged-batch model execution for the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2/model_runner.py``; reference:
inference/v2/model_implementations/inference_transformer_base.py:48).

One forward serves any mix of prefill and decode tokens in the flat-token
layout of ``ragged/ragged_wrapper.py``. Per layer over the flat token axis:

  rmsnorm → q/k/v projections → RoPE (per-token absolute positions)
  → paged KV append (in place) → paged attention → o proj → SwiGLU MLP,

and logits only for each sequence's last token. The page pool is ONE
tensor ``[L*num_blocks + 1, page_size, 2*KV, hd]``; layer l's page table is
``block_table + l*num_blocks`` and the final page is the trash page padded
tokens write into.

Attention impls (``RaggedInferenceEngineConfig.attn_impl``):
  "paged"  — the hand-written CUDA kernels (``kernels/ragged_ops.py``):
             ``ragged_paged_attention`` for prefill/mixed batches,
             ``decode_paged_attention`` for fused decode windows;
  "gather" — the dense page-gather oracle :func:`_attend_gather`, chosen
             explicitly, never by default.

Where the JAX package compiles a step and donates the pool, the port runs
eagerly and writes the pool in place. The fused decode window
(:func:`build_decode_loop`) is a Python loop whose sampling and metadata
advance stay on the device: nothing in it waits for the host.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...models.transformer import CausalLM, TransformerConfig, rms_norm
from .kernels.ragged_ops import (
    decode_paged_attention,
    paged_kv_append,
    ragged_paged_attention,
)
from .ragged.ragged_wrapper import pack_layout

_NEG_INF = -1e30


def _rope_at(pos: torch.Tensor, rotary_dim: int, theta: float):
    """cos/sin tables gathered at arbitrary positions [T] → [T, rd/2]."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=pos.device) / rotary_dim))
    freqs = pos.float()[:, None] * inv[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def _apply_rope_flat(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, hd] with per-token tables [T, hd/2]: the half-split (neox)
    rotation of the llama family."""
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _unpack_batch(packed: torch.Tensor, max_q: int, max_seqs: int,
                  max_blocks: int) -> Dict[str, torch.Tensor]:
    """Packed int32 metadata vector → dict of views (no copies)."""
    batch = {}
    for name, (off, shape) in pack_layout(max_q, max_seqs, max_blocks).items():
        if name == "_total":
            continue
        n = math.prod(shape)
        batch[name] = packed[off:off + n].view(shape)
    return batch


def _attend_gather(q_seq, kv_pages, page_table, q_len, ctx_len, scale):
    """Dense page-gather reference attention (the numerics oracle).

    Gathers the full padded context per sequence straight from the pool
    (``page_table`` rows are ABSOLUTE page ids) and runs masked softmax
    attention in float32. V is zeroed at out-of-context columns before the
    product (select before multiply), so unused table slots aliasing a
    poisoned page cannot leak NaN.

    q_seq [S, mq, H, hd]; kv_pages [NP, ps, 2KV, hd]; page_table [S, NB]
    → [S, mq, H, hd] float32.
    """
    S, mq, H, hd = q_seq.shape
    _, ps, ckv, _ = kv_pages.shape
    KV = ckv // 2
    NB = page_table.shape[1]
    C = NB * ps
    dev = q_seq.device
    ctx_pos = torch.arange(C, device=dev)
    pg = page_table[:, ctx_pos // ps].long()                  # [S, C]
    off = (ctx_pos % ps)[None, :].expand(S, C)
    ctx = kv_pages[pg, off]                                   # [S, C, 2KV, hd]
    k_ctx, v_ctx = ctx[..., :KV, :], ctx[..., KV:, :]
    valid_col = ctx_pos[None, :] < ctx_len[:, None]           # [S, C]
    v_ctx = torch.where(valid_col[:, :, None, None], v_ctx,
                        torch.zeros((), dtype=v_ctx.dtype, device=dev))
    if KV != H:
        k_ctx = k_ctx.repeat_interleave(H // KV, dim=2)
        v_ctx = v_ctx.repeat_interleave(H // KV, dim=2)
    rows = torch.arange(mq, device=dev)
    q_pos = ctx_len[:, None] - q_len[:, None] + rows[None, :]
    q_mask = rows[None, :] < q_len[:, None]
    attn_mask = (ctx_pos[None, None, :] <= q_pos[:, :, None]) & \
        (ctx_pos[None, None, :] < ctx_len[:, None, None]) & q_mask[:, :, None]
    scores = torch.einsum("sqhd,schd->shqc", q_seq.float(),
                          k_ctx.float()) * scale
    scores = torch.where(attn_mask[:, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("shqc,schd->sqhd", probs, v_ctx.float())


def _ragged_attend(q, kv_pages, batch, *, attn_impl: str, layer: int,
                   num_blocks: int, max_q: int, scale: float,
                   decode_mode: bool = False) -> torch.Tensor:
    """Attention dispatch: the ragged paged kernel, the one-token-per-
    sequence decode kernel (``decode_mode``: sequence i's single query token
    at flat index i, rows past n_seqs padded with ctx_len 0), or the dense
    page-gather oracle. q [T, H, hd] → [T, H*hd]."""
    T, H, hd = q.shape
    KV = kv_pages.shape[2] // 2
    q_len, ctx_len = batch["q_len"], batch["ctx_len"]
    pt_l = batch["block_table"] + layer * num_blocks          # [S, NB]
    if attn_impl == "paged" and decode_mode:
        SW = min(q_len.shape[0], T)
        out = decode_paged_attention(q[:SW], kv_pages, ctx_len[:SW],
                                     pt_l[:SW], num_kv_heads=KV, scale=scale)
        if T > SW:
            out = F.pad(out, (0, 0, 0, 0, 0, T - SW))
        return out.reshape(T, H * hd)
    if attn_impl == "paged":
        out = ragged_paged_attention(q, kv_pages, ctx_len, pt_l,
                                     batch["cu_q_lens"], num_kv_heads=KV,
                                     scale=scale)
        return out.reshape(T, H * hd)
    q_offset = batch["q_offset"].long()
    rows = torch.arange(max_q, device=q.device)
    q_idx = (q_offset[:, None] + rows[None, :]).clamp(0, T - 1)
    q_seq = q.reshape(T, -1)[q_idx.reshape(-1)].reshape(-1, max_q, H, hd)
    o_seq = _attend_gather(q_seq, kv_pages, pt_l, q_len, ctx_len,
                           scale).to(q.dtype)
    seq_of = batch["seq_of_token"].long()
    within = (torch.arange(T, device=q.device) - q_offset[seq_of]).clamp(
        0, max_q - 1)
    return o_seq[seq_of, within].reshape(T, H * hd)


def _layer_pages(page_of_token, layer: int, num_blocks: int, trash_page: int):
    """Layer-relative token pages → absolute pool pages; the wrapper's pad
    sentinel (>= num_blocks) routes to the shared trash page."""
    return torch.where(page_of_token < num_blocks,
                       page_of_token + layer * num_blocks, trash_page)


def ragged_forward(model: CausalLM, kv_pages: torch.Tensor,
                   packed: torch.Tensor, cfg: TransformerConfig, max_q: int,
                   num_blocks: int, attn_impl: str = "paged",
                   max_seqs: int = 0, max_blocks: int = 0,
                   decode_mode: bool = False) -> torch.Tensor:
    """→ last-token logits [max_seqs, vocab] float32. ``kv_pages`` is
    updated in place with this batch's K/V rows."""
    batch = _unpack_batch(packed, max_q, max_seqs, max_blocks)
    tokens = batch["tokens"]
    page_of = batch["page_of_token"]
    off_of = batch["off_of_token"]
    T = tokens.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    trash_page = kv_pages.shape[0] - 1
    lw = model.layers

    x = model.embed.embedding[tokens.long()]                  # [T, D]
    cos, sin = _rope_at(batch["pos_of_token"], hd, cfg.rope_theta)

    def proj(h, name, layer, n):
        p = getattr(lw, name)
        y = h @ p.kernel[layer]
        if cfg.attn_bias:
            y = y + p.bias[layer]
        return y.view(T, n, hd)

    for layer in range(cfg.num_layers):
        h = rms_norm(x, lw.attn_norm.scale[layer], cfg.norm_eps)
        q = _apply_rope_flat(proj(h, "q_proj", layer, H), cos, sin)
        k = _apply_rope_flat(proj(h, "k_proj", layer, KV), cos, sin)
        v = proj(h, "v_proj", layer, KV)
        paged_kv_append(kv_pages, k, v,
                        _layer_pages(page_of, layer, num_blocks, trash_page),
                        off_of)
        o = _ragged_attend(q, kv_pages, batch, attn_impl=attn_impl,
                           layer=layer, num_blocks=num_blocks, max_q=max_q,
                           scale=scale, decode_mode=decode_mode)
        x = x + o.to(x.dtype) @ lw.o_proj.kernel[layer]
        h = rms_norm(x, lw.mlp_norm.scale[layer], cfg.norm_eps)
        gate = F.silu(h @ lw.gate_proj.kernel[layer])
        up = h @ lw.up_proj.kernel[layer]
        x = x + (gate * up) @ lw.down_proj.kernel[layer]

    x = rms_norm(x, model.norm_f.scale, cfg.norm_eps)
    last = x[batch["logit_idx"].long()]                       # [S, D]
    if cfg.tie_embeddings:
        logits = last @ model.embed.embedding.T
    else:
        logits = last @ model.lm_head.kernel
    return logits.float()


def build_ragged_step(cfg: TransformerConfig, max_q: int, num_blocks: int,
                      attn_impl: str = "paged", max_seqs: int = 0,
                      max_blocks: int = 0, decode_mode: bool = False):
    """``(model, kv_pages, packed) → logits`` for one bucket's budgets."""
    if attn_impl not in ("paged", "gather"):
        raise ValueError(
            f"attn_impl must be 'paged' or 'gather', got {attn_impl!r}")
    return partial(ragged_forward, cfg=cfg, max_q=max_q,
                   num_blocks=num_blocks, attn_impl=attn_impl,
                   max_seqs=max_seqs, max_blocks=max_blocks,
                   decode_mode=decode_mode)


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits), on the device (Gumbel-max:
    argmax of logits plus Gumbel noise is an exact categorical sample)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """On-device token selection: argmax, temperature, or top-k sampling.
    ``logits`` [S, V] → int32 [S]. ``generator`` may be None for greedy."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    if top_k and top_k > 0:
        vals, idx = torch.topk(scaled, top_k, dim=-1)
        choice = _categorical(vals, generator)
        return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)
    return _categorical(scaled, generator).to(torch.int32)


def build_decode_loop(cfg: TransformerConfig, *, max_q: int, max_seqs: int,
                      max_blocks: int, block_size: int, num_blocks: int,
                      attn_impl: str, steps: int, temperature: float = 0.0,
                      top_k: int = 0):
    """Fused multi-step decode: ``steps`` forward+select iterations with the
    batch metadata advanced on the device between them.

    Requires a DECODE-ONLY batch laid out row-major (sequence i's single
    query token at flat index i) with KV pages allocated for the whole
    window, so the block table is static; only tokens / pages / offsets /
    positions / context lengths advance, recomputed from the block table on
    the device. Token i+1's embedding lookup reads the token sampled at
    step i where it lies: there is no host sync inside the loop.

    Returns ``loop(model, kv_pages, packed, generator) → (tokens [steps,
    max_seqs] int32, advanced packed metadata, nonfinite [max_seqs] bool)``.
    ``packed`` is advanced in place; ``nonfinite[i]`` is True when sequence
    i's logits went non-finite at any step of the window.
    """
    step_fn = build_ragged_step(cfg, max_q=max_q, num_blocks=num_blocks,
                                attn_impl=attn_impl, max_seqs=max_seqs,
                                max_blocks=max_blocks, decode_mode=True)
    layout = pack_layout(max_q, max_seqs, max_blocks)
    NB, bs, S = max_blocks, block_size, max_seqs
    # a decode row costs one flat token: at most min(max_seqs, max_q) rows
    SW = min(S, max_q)
    pad_page = num_blocks                       # wrapper's pad sentinel

    def field(meta, name, n):
        off = layout[name][0]
        return meta[off:off + n]

    def advance(meta, new_toks):
        """Next step's metadata: row i's token moves to position pos+1; its
        cache page/offset are re-derived from the (static) block table."""
        active = (field(meta, "q_len", SW) > 0).to(torch.int32)
        pos = field(meta, "pos_of_token", SW) + active
        ctx = field(meta, "ctx_len", SW) + active
        bt = field(meta, "block_table", S * NB).view(S, NB)[:SW]
        # the position after a window that ends at max_ctx has no block;
        # clamp it (that state is never resumed: can_schedule refuses it)
        blk_idx = (pos // bs).clamp(max=NB - 1).long()
        blk = bt.gather(1, blk_idx[:, None])[:, 0]
        on = active == 1
        field(meta, "tokens", SW).copy_(
            torch.where(on, new_toks[:SW], 0))
        field(meta, "page_of_token", SW).copy_(
            torch.where(on, blk, pad_page))
        field(meta, "off_of_token", SW).copy_(torch.where(on, pos % bs, 0))
        field(meta, "pos_of_token", SW).copy_(pos)
        field(meta, "ctx_len", SW).copy_(ctx)

    def loop(model, kv_pages, meta, generator=None):
        toks = torch.empty((steps, S), dtype=torch.int32, device=meta.device)
        bad = torch.zeros(S, dtype=torch.bool, device=meta.device)
        for i in range(steps):
            logits = step_fn(model, kv_pages, meta)
            # per-sequence poison flag (sticky across the window's steps)
            bad |= ~torch.isfinite(logits).all(dim=-1)
            toks[i] = sample_tokens(logits, generator, temperature, top_k)
            advance(meta, toks[i])
        return toks, meta, bad

    return loop

