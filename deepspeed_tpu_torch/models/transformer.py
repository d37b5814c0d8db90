"""Llama-family causal LM for the PyTorch port (counterpart of
``deepspeed_tpu/models/transformer.py``: ``TransformerConfig``, ``init_params``,
``rms_norm`` and the stacked-layer parameter tree).

The parameters keep the JAX package's names and layout so that a JAX tree
converts by name with no reshuffle (``models/convert.py``):

  * every layer tensor is stacked with a leading ``[L, ...]`` axis;
  * projection kernels are ``[in, out]`` (``y = x @ kernel``);
  * ``CausalLM.state_dict()`` keys are the JAX tree paths joined by dots:
    ``embed.embedding``, ``layers.q_proj.kernel``, ``norm_f.scale``,
    ``lm_head.kernel``, ...

This slice serves the dense ``TransformerConfig`` path only; MoE fields are
kept so configs round-trip, but ``CausalLM`` refuses ``num_experts > 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..accelerator import get_accelerator


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    #: bias on q/k/v projections (qwen2-family); o_proj stays bias-free
    attn_bias: bool = False
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    use_flash: bool = True
    attn_impl: str = "auto"
    flash_block_q: int = 256
    flash_block_k: int = 512
    fused_rmsnorm: str = "auto"
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_loss_coef: float = 0.01
    moe_dispatch: str = "sparse"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw):
        return TransformerConfig(vocab_size=256, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 max_seq_len=128, **kw)

    @staticmethod
    def llama3_8b(**kw):
        return TransformerConfig(vocab_size=128256, hidden_size=4096,
                                 intermediate_size=14336, num_layers=32,
                                 num_heads=32, num_kv_heads=8,
                                 max_seq_len=8192, rope_theta=500000.0, **kw)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Dotted parameter name → shape, the JAX ``init_params`` tree."""
    if cfg.num_experts > 1:
        raise NotImplementedError("MoE serving is not ported yet")
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "embed.embedding": (cfg.vocab_size, D),
        "layers.attn_norm.scale": (L, D),
        "layers.q_proj.kernel": (L, D, H * hd),
        "layers.k_proj.kernel": (L, D, KV * hd),
        "layers.v_proj.kernel": (L, D, KV * hd),
        "layers.o_proj.kernel": (L, H * hd, D),
        "layers.mlp_norm.scale": (L, D),
        "layers.gate_proj.kernel": (L, D, F),
        "layers.up_proj.kernel": (L, D, F),
        "layers.down_proj.kernel": (L, F, D),
        "norm_f.scale": (D,),
    }
    if cfg.attn_bias:
        shapes["layers.q_proj.bias"] = (L, H * hd)
        shapes["layers.k_proj.bias"] = (L, KV * hd)
        shapes["layers.v_proj.bias"] = (L, KV * hd)
    if not cfg.tie_embeddings:
        shapes["lm_head.kernel"] = (D, cfg.vocab_size)
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions (normal /
    sqrt(fan_in) kernels, 0.02-scaled embedding, unit norm scales, zero
    biases) → a ``CausalLM`` state dict. Numbers come from ``generator``,
    which must live on ``device``; they differ from ``jax.random``'s.

    Layer tensors are drawn one layer at a time in float32 and cast into
    the stacked tensor, so a full-width model needs one layer of float32
    scratch, not the whole model."""
    dev = get_accelerator().resolve_device(device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=dev)
        if name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith(".bias"):
            t.zero_()
        elif name == "embed.embedding":
            t.copy_(torch.randn(shape, generator=generator, device=dev) * 0.02)
        else:
            fan_in = shape[-2]
            if name.startswith("layers."):
                for layer in range(shape[0]):
                    t[layer].copy_(torch.randn(
                        shape[1:], generator=generator, device=dev)
                        / math.sqrt(fan_in))
            else:
                t.copy_(torch.randn(shape, generator=generator, device=dev)
                        / math.sqrt(fan_in))
        out[name] = t
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Same cast order as the JAX ``rms_norm``: the variance in float32,
    the normaliser cast back to ``x``'s dtype before the products."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


class _Node(nn.Module):
    """A named level of the parameter tree (``layers``, ``q_proj``, ...)."""


class CausalLM(nn.Module):
    """Holds the stacked parameters under the JAX names; the serving
    forward is ``inference/v2/model_runner.ragged_forward``.

    ``state`` is a dict of dotted name → tensor (from :func:`init_params`
    or ``models.convert.params_from_numpy``); its tensors are used as they
    are, without a copy. Parameters do not require grad: this slice only
    serves."""

    def __init__(self, cfg: TransformerConfig,
                 state: Dict[str, torch.Tensor]):
        super().__init__()
        self.config = cfg
        expected = param_shapes(cfg)
        missing = sorted(set(expected) - set(state))
        extra = sorted(set(state) - set(expected))
        if missing or extra:
            raise ValueError(f"parameter names do not match the config: "
                             f"missing {missing}, extra {extra}")
        for name, shape in expected.items():
            t = state[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            *path, leaf = name.split(".")
            node = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, _Node())
                node = getattr(node, part)
            node.register_parameter(leaf, nn.Parameter(t, requires_grad=False))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
