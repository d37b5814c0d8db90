"""The universal model families for the PyTorch port (counterpart of
``deepspeed_tpu/models/families.py``): gpt2, gptj, opt, bloom, falcon and
phi, driven by :class:`ArchConfig` knobs instead of one class each.

The knobs are the reference's: learned positions (with OPT's offset),
ALiBi (Bloom's, and Falcon-RW's scaled form), full, partial and
interleaved rotary, parallel attention with one or two LayerNorms,
LayerNorm with bias or RMSNorm, gelu (tanh or erf), relu and SwiGLU MLPs,
tied or separate lm heads with an optional bias.

Parameters keep the JAX package's tree names (``embed.embedding``,
``layers.ln1.scale``, ``layers.q_proj.kernel``, ``layers.fc1.bias``, ...)
and layouts (stacked ``[L, ...]`` layer tensors, ``[in, out]`` kernels), so
``models/convert.py`` carries a JAX ``init_universal_params`` tree across
by name. :func:`universal_forward` is plain PyTorch; serving runs
``inference/v2/model_runner.ragged_forward`` on the paged kernels, which
also serves the Llama-family ``TransformerConfig`` as the ``ArchConfig``
:func:`arch_of` gives. Training the families is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..inference.v2.kernels.ragged_ops import alibi_slopes
from ..moe.sharded_moe import moe_mlp_block
from .transformer import (TransformerConfig, init_from_shapes,
                          register_params, rms_norm)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12
    max_seq_len: int = 1024
    #: "rope" | "learned" | "alibi"
    pos: str = "learned"
    pos_offset: int = 0             # OPT stores positions at index pos+2
    rope_theta: float = 10000.0
    rope_pct: float = 1.0           # phi: rotary on a fraction of head_dim
    #: "neox" (half-split halves, llama/falcon/phi) | "gptj" (interleaved
    #: pairs, rotate_every_two)
    rope_style: str = "neox"
    #: "layernorm" | "rmsnorm"
    norm: str = "layernorm"
    norm_eps: float = 1e-5
    #: "gelu" | "relu" | "silu_glu"
    mlp: str = "gelu"
    gelu_exact: bool = False        # falcon: erf gelu; gpt2/bloom/phi: tanh
    parallel_attn: bool = False     # falcon/phi: attn + mlp of one input
    #: Falcon-style ALiBi: bf16(slope)·bf16(pos), added before the
    #: 1/sqrt(hd) scaling (Bloom adds the float32 bias after it)
    alibi_scaled: bool = False
    dual_ln: bool = False           # falcon new arch: ln_attn and ln_mlp
    qkv_bias: bool = True
    out_bias: bool = True           # o_proj bias
    mlp_bias: Optional[bool] = None  # fc biases (None: follow out_bias)
    embed_layernorm: bool = False   # bloom
    tie_embeddings: bool = True
    lm_head_bias: bool = False      # gptj/phi carry an lm-head bias
    #: Mixtral (a ``TransformerConfig`` with ``num_experts > 1``, through
    #: :func:`arch_of`): the SwiGLU MLP routed over stacked experts
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.rope_pct)
        return rd - rd % 2


def arch_of(cfg) -> ArchConfig:
    """``cfg`` as an :class:`ArchConfig`: a ``TransformerConfig`` is the
    Llama family (RMSNorm, full neox RoPE, SwiGLU, biases on q/k/v only
    with ``attn_bias``), whose ``attn_norm``/``mlp_norm`` stand where the
    families have ``ln1``/``ln2``; its MoE fields carry the routed MLP."""
    if isinstance(cfg, ArchConfig):
        return cfg
    if not isinstance(cfg, TransformerConfig):
        raise TypeError(f"need a TransformerConfig or ArchConfig, got "
                        f"{type(cfg).__name__}")
    return ArchConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        max_seq_len=cfg.max_seq_len, pos="rope", rope_theta=cfg.rope_theta,
        norm="rmsnorm", norm_eps=cfg.norm_eps, mlp="silu_glu",
        qkv_bias=cfg.attn_bias, out_bias=False,
        tie_embeddings=cfg.tie_embeddings, num_experts=cfg.num_experts,
        moe_top_k=cfg.moe_top_k,
        moe_capacity_factor=cfg.moe_capacity_factor)


def universal_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Dotted parameter name → shape, the JAX ``init_universal_params``
    tree."""
    if cfg.num_experts > 1:
        raise ValueError("the universal families have no MoE; a Mixtral "
                         "model is a TransformerConfig with num_experts > 1")
    L, D, Fd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes: Dict[str, Tuple[int, ...]] = {"embed.embedding":
                                          (cfg.vocab_size, D)}

    def ln(name):
        shapes[f"layers.{name}.scale"] = (L, D)
        if cfg.norm == "layernorm":
            shapes[f"layers.{name}.bias"] = (L, D)

    def dense(name, n_in, n_out, bias):
        shapes[f"layers.{name}.kernel"] = (L, n_in, n_out)
        if bias:
            shapes[f"layers.{name}.bias"] = (L, n_out)

    ln("ln1")
    dense("q_proj", D, H * hd, cfg.qkv_bias)
    dense("k_proj", D, KV * hd, cfg.qkv_bias)
    dense("v_proj", D, KV * hd, cfg.qkv_bias)
    dense("o_proj", H * hd, D, cfg.out_bias)
    if not (cfg.parallel_attn and not cfg.dual_ln):
        ln("ln2")
    mlp_bias = cfg.out_bias if cfg.mlp_bias is None else cfg.mlp_bias
    if cfg.mlp == "silu_glu":
        dense("gate_proj", D, Fd, False)
        dense("up_proj", D, Fd, False)
        dense("down_proj", Fd, D, False)
    else:
        dense("fc1", D, Fd, mlp_bias)
        dense("fc2", Fd, D, mlp_bias)
    shapes["norm_f.scale"] = (D,)
    if cfg.norm == "layernorm":
        shapes["norm_f.bias"] = (D,)
    if cfg.pos == "learned":
        shapes["pos_embed.embedding"] = (cfg.max_seq_len + cfg.pos_offset, D)
    if cfg.embed_layernorm:
        shapes["embed_ln.scale"] = (D,)
        shapes["embed_ln.bias"] = (D,)
    if not cfg.tie_embeddings:
        shapes["lm_head.kernel"] = (D, cfg.vocab_size)
        if cfg.lm_head_bias:
            shapes["lm_head.bias"] = (cfg.vocab_size,)
    return shapes


def init_universal_params(cfg: ArchConfig, generator: torch.Generator,
                          dtype: torch.dtype = torch.float32,
                          device=None) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX ``init_universal_params``
    distributions (normal / sqrt(fan_in) kernels, 0.02-scaled embeddings,
    unit norm scales, zero biases) → a :class:`UniversalCausalLM` state
    dict. Numbers come from ``generator``, which must live on ``device``."""
    return init_from_shapes(universal_param_shapes(cfg), generator, dtype,
                            device)


# --------------------------------------------------------------------- #
# Math blocks
# --------------------------------------------------------------------- #
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The JAX ``layer_norm``: mean and variance in float32, the affine
    in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def norm(x: torch.Tensor, node: nn.Module, cfg: ArchConfig,
         layer: Optional[int] = None) -> torch.Tensor:
    """``cfg.norm`` with ``node``'s scale (and bias), layer ``layer`` of a
    stacked node."""
    scale = node.scale if layer is None else node.scale[layer]
    if cfg.norm == "rmsnorm":
        return rms_norm(x, scale, cfg.norm_eps)
    bias = node.bias if layer is None else node.bias[layer]
    return layer_norm(x, scale, bias, cfg.norm_eps)


def rope_partial(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_dim: int, style: str = "neox") -> torch.Tensor:
    """Rotary on the first ``rotary_dim`` features of each head; ``x``
    ``[..., tokens, heads, hd]``, tables ``[tokens, rotary_dim / 2]``.

    "neox": rotate split halves (llama/falcon/phi). "gptj": rotate
    interleaved even/odd pairs (rotate_every_two)."""
    rot, passthrough = x[..., :rotary_dim], x[..., rotary_dim:]
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    if style == "gptj":
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        rot = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                          dim=-1).flatten(-2)
    else:
        x1, x2 = rot.chunk(2, dim=-1)
        rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if rotary_dim < x.shape[-1]:
        return torch.cat([rot, passthrough], dim=-1)
    return rot


def rope_at(pos: torch.Tensor, rotary_dim: int, theta: float):
    """cos/sin tables at positions ``pos`` → ``[len(pos), rotary_dim/2]``
    float32."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=pos.device) / rotary_dim))
    freqs = pos.float()[:, None] * inv[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def activation(cfg: ArchConfig):
    """The non-GLU MLP's activation."""
    if cfg.mlp == "gelu":
        approximate = "none" if cfg.gelu_exact else "tanh"
        return lambda y: F.gelu(y, approximate=approximate)
    return F.relu


def linear(h: torch.Tensor, node: nn.Module,
           layer: Optional[int] = None) -> torch.Tensor:
    """``h @ kernel (+ bias)`` of ``node``, layer ``layer`` of a stacked
    node."""
    kernel = node.kernel if layer is None else node.kernel[layer]
    y = h @ kernel
    bias = getattr(node, "bias", None)
    if bias is not None:
        y = y + (bias if layer is None else bias[layer])
    return y


def mlp(h: torch.Tensor, lw: nn.Module, layer: int, cfg: ArchConfig,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer ``layer``'s MLP on ``h [T, D]``. With ``cfg.num_experts >
    1`` it is the routed expert SwiGLU (``moe_mlp_block``, sparse
    dispatch); ``valid [T]`` marks the batch's real tokens, so that
    padding takes no expert capacity."""
    if cfg.num_experts > 1:
        lp = {name: {"kernel": getattr(lw, name).kernel[layer]}
              for name in ("router", "gate_proj", "up_proj", "down_proj")}
        out, _ = moe_mlp_block(lp, h, k=cfg.moe_top_k,
                               capacity_factor=cfg.moe_capacity_factor,
                               dispatch_impl="sparse", valid=valid)
        return out
    if cfg.mlp == "silu_glu":
        gate = F.silu(linear(h, lw.gate_proj, layer))
        return linear(gate * linear(h, lw.up_proj, layer), lw.down_proj,
                      layer)
    return linear(activation(cfg)(linear(h, lw.fc1, layer)), lw.fc2, layer)


def lm_head(x: torch.Tensor, model: nn.Module, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return x @ model.embed.embedding.T
    return linear(x, model.lm_head)


def _attention(q, k, v, cfg: ArchConfig, slopes: Optional[torch.Tensor]):
    """Causal attention ``[B, S, H, hd]`` in float32, the ALiBi bias (if
    any) as the JAX ``_attention`` adds it."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    if slopes is not None:
        pos = torch.arange(S, device=q.device)
        if cfg.alibi_scaled:
            bias = (slopes.to(torch.bfloat16)[:, None]
                    * pos.to(torch.bfloat16)[None, :]).float() / math.sqrt(hd)
        else:
            bias = slopes[:, None] * pos.float()[None, :]
        scores = scores + bias[None, :, None, :]
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


# --------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------- #
def universal_forward(model: "UniversalCausalLM",
                      tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` → logits ``[B, S, V]`` in the parameters' dtype
    (the JAX ``universal_forward``)."""
    cfg = model.config
    B, S = tokens.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lw = model.layers
    x = model.embed.embedding[tokens.long()]
    pos = torch.arange(S, device=x.device)
    if cfg.pos == "learned":
        x = x + model.pos_embed.embedding[pos + cfg.pos_offset]
    if cfg.embed_layernorm:
        x = norm(x, model.embed_ln, cfg)
    cos = sin = slopes = None
    if cfg.pos == "rope":
        cos, sin = rope_at(pos, cfg.rotary_dim, cfg.rope_theta)
    if cfg.pos == "alibi":
        slopes = alibi_slopes(H).to(x.device)

    for layer in range(cfg.num_layers):
        h_attn = norm(x, lw.ln1, cfg, layer)
        q = linear(h_attn, lw.q_proj, layer).view(B, S, H, hd)
        k = linear(h_attn, lw.k_proj, layer).view(B, S, KV, hd)
        v = linear(h_attn, lw.v_proj, layer).view(B, S, KV, hd)
        if cfg.pos == "rope":
            q = rope_partial(q, cos, sin, cfg.rotary_dim, cfg.rope_style)
            k = rope_partial(k, cos, sin, cfg.rotary_dim, cfg.rope_style)
        o = _attention(q, k, v, cfg, slopes).reshape(B, S, H * hd)
        attn_out = linear(o, lw.o_proj, layer)
        if cfg.parallel_attn:
            h_mlp = norm(x, lw.ln2, cfg, layer) if cfg.dual_ln else h_attn
            x = x + attn_out + mlp(h_mlp, lw, layer, cfg)
        else:
            x = x + attn_out
            x = x + mlp(norm(x, lw.ln2, cfg, layer), lw, layer, cfg)
    return lm_head(norm(x, model.norm_f, cfg), model, cfg)


class UniversalCausalLM(nn.Module):
    """Holds a family's stacked parameters under the JAX names; served by
    ``InferenceEngineV2`` like ``CausalLM``. ``state`` maps dotted names
    to tensors (:func:`init_universal_params`, or
    ``models.convert.params_from_numpy``), used without a copy."""

    def __init__(self, cfg: ArchConfig, state: Dict[str, torch.Tensor],
                 trainable: bool = False):
        super().__init__()
        self.config = cfg
        register_params(self, universal_param_shapes(cfg), state, trainable)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return universal_forward(self, tokens)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
