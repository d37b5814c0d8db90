"""Ragged-batch model execution for the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2/model_runner.py``; reference:
inference/v2/model_implementations/inference_transformer_base.py:48).

One forward serves any mix of prefill and decode tokens in the flat-token
layout of ``ragged/ragged_wrapper.py``. Per layer over the flat token axis:

  norm → q/k/v projections → positions (RoPE per token, or ALiBi in the
  attention) → paged KV append (in place) → paged attention → o proj → MLP,

and logits only for each sequence's last token. The page pool is ONE
tensor ``[L*num_blocks + 1, page_size, 2*KV, hd]``; layer l's page table is
``block_table + l*num_blocks`` and the final page is the trash page padded
tokens write into.

One forward, :func:`ragged_forward`, serves both config types: a
Llama-family ``TransformerConfig`` runs as the ``ArchConfig`` it is
(``families.arch_of``: RMSNorm, full RoPE, SwiGLU, no o_proj or MLP
biases), beside the universal families' own ``ArchConfig``
(``models/families.py``). With ``verify_mode`` it returns the logits of
every flat position, for the speculative verify windows (K6 on short
multi-token rows).

Attention impls (``RaggedInferenceEngineConfig.attn_impl``):
  "paged"  — the hand-written CUDA kernels (``kernels/ragged_ops.py``):
             ``ragged_paged_attention`` (K6) for prefill/mixed batches,
             ``decode_paged_attention`` (K7) for fused decode windows;
  "gather" — the dense page-gather oracle :func:`_attend_gather`, chosen
             explicitly, never by default.

Where the JAX package compiles a step and donates the pool, the port runs
eagerly and writes the pool in place. The fused decode window
(:func:`build_decode_loop`) is a Python loop whose sampling and metadata
advance stay on the device: nothing in it waits for the host; the verify
step (:func:`build_verify_step`) hands the host two small vectors.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...models.families import arch_of, linear, mlp, norm, rope_partial
from ...models.families import rope_at as _rope_at
from .kernels.ragged_ops import (
    alibi_bias,
    alibi_slopes,
    biased_scores,
    decode_paged_attention,
    paged_kv_append,
    ragged_paged_attention,
)
from .ragged.ragged_wrapper import pack_layout

_NEG_INF = -1e30


def _apply_rope_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     rotary_dim: Optional[int] = None,
                     style: str = "neox") -> torch.Tensor:
    """x [T, H, hd] with per-token tables [T, rd/2]: the half-split (neox)
    rotation of the llama family, or partial (phi) and interleaved-pair
    (gptj) rotary, as ``families.rope_partial`` on the flat token axis."""
    return rope_partial(x, cos, sin,
                        x.shape[-1] if rotary_dim is None else rotary_dim,
                        style)


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


def _attend_gather(q_seq, kv_pages, page_table, q_len, ctx_len, scale,
                   alibi=None, alibi_scaled=False):
    """Dense page-gather reference attention (the numerics oracle).

    Gathers the full padded context per sequence straight from the pool
    (``page_table`` rows are ABSOLUTE page ids) and runs masked softmax
    attention in float32. V is zeroed at out-of-context columns before the
    product (select before multiply), so unused table slots aliasing a
    poisoned page cannot leak NaN. ``alibi`` (a float32 ``[H]`` slopes
    tensor) adds the kernels' position bias (``ragged_ops.alibi_bias``;
    ``alibi_scaled``: Falcon's).

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
    raw = torch.einsum("sqhd,schd->shqc", q_seq.float(), k_ctx.float())
    if alibi is None:
        scores = raw * scale
    else:
        bias = alibi_bias(alibi, ctx_pos, scale, alibi_scaled)  # [H, C]
        scores = biased_scores(raw, scale, bias[None, :, None, :])
    scores = torch.where(attn_mask[:, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("shqc,schd->sqhd", probs, v_ctx.float())


def _ragged_attend(q, kv_pages, batch, *, attn_impl: str, layer: int,
                   num_blocks: int, max_q: int, scale: float, alibi=None,
                   alibi_scaled: bool = False,
                   decode_mode: bool = False) -> torch.Tensor:
    """Attention dispatch: the ragged paged kernel (prefill, mixed and
    verify batches), the one-token-per-sequence decode kernel
    (``decode_mode``: sequence i's single query token at flat index i,
    rows past n_seqs padded with ctx_len 0), or the dense page-gather
    oracle. ``alibi``: H slopes or None. q [T, H, hd] → [T, H*hd]."""
    T, H, hd = q.shape
    KV = kv_pages.shape[2] // 2
    q_len, ctx_len = batch["q_len"], batch["ctx_len"]
    pt_l = batch["block_table"] + layer * num_blocks          # [S, NB]
    if attn_impl == "paged" and decode_mode:
        SW = min(q_len.shape[0], T)
        out = decode_paged_attention(q[:SW], kv_pages, ctx_len[:SW],
                                     pt_l[:SW], num_kv_heads=KV, scale=scale,
                                     alibi=alibi, alibi_scaled=alibi_scaled)
        if T > SW:
            out = F.pad(out, (0, 0, 0, 0, 0, T - SW))
        return out.reshape(T, H * hd)
    if attn_impl == "paged":
        out = ragged_paged_attention(q, kv_pages, ctx_len, pt_l,
                                     batch["cu_q_lens"], num_kv_heads=KV,
                                     scale=scale, alibi=alibi,
                                     alibi_scaled=alibi_scaled)
        return out.reshape(T, H * hd)
    q_offset = batch["q_offset"].long()
    rows = torch.arange(max_q, device=q.device)
    q_idx = (q_offset[:, None] + rows[None, :]).clamp(0, T - 1)
    q_seq = q.reshape(T, -1)[q_idx.reshape(-1)].reshape(-1, max_q, H, hd)
    slopes = None if alibi is None else torch.tensor(
        alibi, dtype=torch.float32, device=q.device)
    o_seq = _attend_gather(q_seq, kv_pages, pt_l, q_len, ctx_len, scale,
                           alibi=slopes,
                           alibi_scaled=alibi_scaled).to(q.dtype)
    seq_of = batch["seq_of_token"].long()
    within = (torch.arange(T, device=q.device) - q_offset[seq_of]).clamp(
        0, max_q - 1)
    return o_seq[seq_of, within].reshape(T, H * hd)


def _layer_pages(page_of_token, layer: int, num_blocks: int, trash_page: int):
    """Layer-relative token pages → absolute pool pages; the wrapper's pad
    sentinel (>= num_blocks) routes to the shared trash page."""
    return torch.where(page_of_token < num_blocks,
                       page_of_token + layer * num_blocks, trash_page)


def _layer_norms(lw):
    """(pre-attention, pre-MLP) norm nodes of the stacked layers: the
    llama tree's ``attn_norm``/``mlp_norm``, the families' ``ln1``/``ln2``
    (no ``ln2`` where a parallel block shares one LayerNorm)."""
    if hasattr(lw, "attn_norm"):
        return lw.attn_norm, lw.mlp_norm
    return lw.ln1, getattr(lw, "ln2", None)


def ragged_forward(model, kv_pages: torch.Tensor, packed: torch.Tensor,
                   cfg, max_q: int, num_blocks: int,
                   attn_impl: str = "paged", max_seqs: int = 0,
                   max_blocks: int = 0, decode_mode: bool = False,
                   verify_mode: bool = False) -> torch.Tensor:
    """A ``CausalLM`` (``cfg`` a ``TransformerConfig``) or a
    ``UniversalCausalLM`` (``cfg`` an ``ArchConfig``: learned positions
    with OPT's offset, ALiBi in the kernels, Bloom's and Falcon's scaled
    form, partial and interleaved rotary, parallel attention, dual
    LayerNorms, LayerNorm with bias, gelu (tanh and erf), relu and SwiGLU
    MLPs, the lm-head bias) over one flat-token batch. A Mixtral config
    routes each token's MLP over the experts (``moe_mlp_block``, sparse
    dispatch), padding excluded from expert capacity.

    → last-token logits [max_seqs, vocab] float32, or with ``verify_mode``
    the logits of every flat position [max_q, vocab] (the verify pass
    needs the argmax at each window position). ``kv_pages`` is updated in
    place with this batch's K/V rows."""
    cfg = arch_of(cfg)
    batch = _unpack_batch(packed, max_q, max_seqs, max_blocks)
    tokens = batch["tokens"]
    page_of = batch["page_of_token"]
    off_of = batch["off_of_token"]
    pos = batch["pos_of_token"]
    T = tokens.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    trash_page = kv_pages.shape[0] - 1
    lw = model.layers
    ln1, ln2 = _layer_norms(lw)
    # the batch's real tokens (padding carries the pad-page sentinel): a
    # routed MLP gives padding no expert capacity
    valid = page_of < num_blocks

    x = model.embed.embedding[tokens.long()]                  # [T, D]
    if cfg.pos == "learned":
        x = x + model.pos_embed.embedding[pos.long() + cfg.pos_offset]
    if cfg.embed_layernorm:
        x = norm(x, model.embed_ln, cfg)
    cos = sin = alibi = None
    if cfg.pos == "rope":
        cos, sin = _rope_at(pos, cfg.rotary_dim, cfg.rope_theta)
    if cfg.pos == "alibi":
        alibi = tuple(alibi_slopes(H).tolist())

    for layer in range(cfg.num_layers):
        h_attn = norm(x, ln1, cfg, layer)
        q = linear(h_attn, lw.q_proj, layer).view(T, H, hd)
        k = linear(h_attn, lw.k_proj, layer).view(T, KV, hd)
        v = linear(h_attn, lw.v_proj, layer).view(T, KV, hd)
        if cfg.pos == "rope":
            q = _apply_rope_flat(q, cos, sin, cfg.rotary_dim, cfg.rope_style)
            k = _apply_rope_flat(k, cos, sin, cfg.rotary_dim, cfg.rope_style)
        paged_kv_append(kv_pages, k, v,
                        _layer_pages(page_of, layer, num_blocks, trash_page),
                        off_of)
        o = _ragged_attend(q, kv_pages, batch, attn_impl=attn_impl,
                           layer=layer, num_blocks=num_blocks, max_q=max_q,
                           scale=scale, alibi=alibi,
                           alibi_scaled=cfg.alibi_scaled,
                           decode_mode=decode_mode)
        attn_out = linear(o.to(x.dtype), lw.o_proj, layer)
        if cfg.parallel_attn:
            h_mlp = norm(x, ln2, cfg, layer) if cfg.dual_ln else h_attn
            x = x + attn_out + mlp(h_mlp, lw, layer, cfg, valid)
        else:
            x = x + attn_out
            x = x + mlp(norm(x, ln2, cfg, layer), lw, layer, cfg, valid)

    x = norm(x, model.norm_f, cfg)
    last = x if verify_mode else x[batch["logit_idx"].long()]
    if cfg.tie_embeddings:
        logits = last @ model.embed.embedding.T
    else:
        logits = linear(last, model.lm_head)
    return logits.float()


def build_ragged_step(cfg, max_q: int, num_blocks: int,
                      attn_impl: str = "paged", max_seqs: int = 0,
                      max_blocks: int = 0, decode_mode: bool = False,
                      verify_mode: bool = False):
    """``(model, kv_pages, packed) → logits`` for one bucket's budgets."""
    if attn_impl not in ("paged", "gather"):
        raise ValueError(
            f"attn_impl must be 'paged' or 'gather', got {attn_impl!r}")
    return partial(ragged_forward, cfg=arch_of(cfg), max_q=max_q, num_blocks=num_blocks,
                   attn_impl=attn_impl, max_seqs=max_seqs,
                   max_blocks=max_blocks, decode_mode=decode_mode,
                   verify_mode=verify_mode)


def build_verify_step(cfg, *, max_q: int, num_blocks: int,
                      attn_impl: str = "paged", max_seqs: int = 0,
                      max_blocks: int = 0):
    """Speculative verify pass: score a ragged window of (seed + draft)
    tokens per sequence and return the greedy argmax at EVERY flat
    position with per-sequence non-finite flags.

    Only those two small vectors leave the device, never ``[T, vocab]``
    logits. The flags count real tokens only (``page_of_token <
    num_blocks``): padded rows alias the last sequence in
    ``seq_of_token`` and must not blame it.

    Returns ``step(model, kv_pages, packed) → (greedy [max_q] int32,
    nonfinite [max_seqs] bool)``, both on the device; ``kv_pages`` is
    updated in place."""
    step_fn = build_ragged_step(cfg, max_q=max_q, num_blocks=num_blocks,
                                attn_impl=attn_impl, max_seqs=max_seqs,
                                max_blocks=max_blocks, verify_mode=True)
    layout = pack_layout(max_q, max_seqs, max_blocks)

    def field(meta, name):
        off, shape = layout[name]
        return meta[off:off + math.prod(shape)]

    def step(model, kv_pages, meta):
        logits = step_fn(model, kv_pages, meta)               # [T, V]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        valid = field(meta, "page_of_token") < num_blocks
        bad_tok = ~torch.isfinite(logits).all(dim=-1) & valid
        bad = torch.zeros(max_seqs, dtype=torch.int32, device=meta.device)
        bad.index_add_(0, field(meta, "seq_of_token").long(),
                       bad_tok.to(torch.int32))
        return greedy, bad > 0

    return step


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


def build_decode_loop(cfg, *, max_q: int, max_seqs: int,
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

