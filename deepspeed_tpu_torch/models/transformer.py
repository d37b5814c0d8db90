"""Llama-family causal LM for the PyTorch port (counterpart of
``deepspeed_tpu/models/transformer.py``: ``TransformerConfig``, ``init_params``,
``rms_norm``, the stacked-layer parameter tree, and the training side:
RoPE, the ``attention`` dispatch, ``forward`` and ``lm_loss``).

The parameters keep the JAX package's names and layout so that a JAX tree
converts by name with no reshuffle (``models/convert.py``):

  * every layer tensor is stacked with a leading ``[L, ...]`` axis;
  * projection kernels are ``[in, out]`` (``y = x @ kernel``);
  * ``CausalLM.state_dict()`` keys are the JAX tree paths joined by dots:
    ``embed.embedding``, ``layers.q_proj.kernel``, ``norm_f.scale``,
    ``lm_head.kernel``, ...

A config with ``num_experts > 1`` is the Mixtral family: every layer's
MLP is a top-k routed SwiGLU over stacked experts (``layers.router.kernel
[L, D, E]``, float32 whatever the other leaves' dtype, and
``layers.{gate,up}_proj.kernel [L, E, D, F]``, ``layers.down_proj.kernel
[L, E, F, D]``), served through ``inference/v2/model_runner.ragged_forward``
(``moe/sharded_moe.moe_mlp_block``); training it is ROADMAP M9.

``forward`` walks the layers in a Python loop over one ``torch.unbind`` of
each stacked tensor per call, so the backward builds each stacked gradient
with one ``stack`` instead of a zero-filled ``[L, ...]`` tensor per layer.
The two kernel knobs resolve on both devices alike, so the CPU tests walk
the dispatch the card walks (the JAX package resolves them to XLA off the
TPU): ``attn_impl="auto"`` is flash attention when ``use_flash`` and
S >= 128, ``fused_rmsnorm="auto"`` is on; ``"xla"``/``"off"`` select the
unfused composition. On CUDA tensors those run the hand-written kernels,
on CPU tensors their plain versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..accelerator import get_accelerator
from ..kernels.fused_collective_matmul import rmsnorm_matmul
from ..ops.transformer.flash_attention import flash_attention


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
    attn_impl: str = "auto"         # auto | flash | xla
    #: the JAX kernel's tile sizes; kept so configs round-trip, but the
    #: CUDA kernels choose their own tiles (64 x 64) and ignore these
    flash_block_q: int = 256
    flash_block_k: int = 512
    fused_rmsnorm: str = "auto"     # auto (= on) | on | off
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
    def tiny_moe(**kw):
        return TransformerConfig(vocab_size=256, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 max_seq_len=128, num_experts=4, moe_top_k=2,
                                 **kw)

    @staticmethod
    def mixtral_8x7b(**kw):
        return TransformerConfig(vocab_size=32000, hidden_size=4096,
                                 intermediate_size=14336, num_layers=32,
                                 num_heads=32, num_kv_heads=8,
                                 max_seq_len=32768, rope_theta=1e6,
                                 num_experts=8, moe_top_k=2, **kw)

    @staticmethod
    def llama3_8b(**kw):
        return TransformerConfig(vocab_size=128256, hidden_size=4096,
                                 intermediate_size=14336, num_layers=32,
                                 num_heads=32, num_kv_heads=8,
                                 max_seq_len=8192, rope_theta=500000.0, **kw)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Dotted parameter name → shape, the JAX ``init_params`` tree."""
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
    if cfg.num_experts > 1:
        E = cfg.num_experts
        shapes.update({"layers.router.kernel": (L, D, E),
                       "layers.gate_proj.kernel": (L, E, D, F),
                       "layers.up_proj.kernel": (L, E, D, F),
                       "layers.down_proj.kernel": (L, E, F, D)})
    if cfg.attn_bias:
        shapes["layers.q_proj.bias"] = (L, H * hd)
        shapes["layers.k_proj.bias"] = (L, KV * hd)
        shapes["layers.v_proj.bias"] = (L, KV * hd)
    if not cfg.tie_embeddings:
        shapes["lm_head.kernel"] = (D, cfg.vocab_size)
    return shapes


def is_router(name: str) -> bool:
    """A MoE router leaf (``layers.router.kernel``): it stays float32
    whatever dtype the other leaves are served or loaded in, as in the
    JAX package, since a bf16 round trip flips top-k selection on
    near-tie tokens."""
    return "router" in name.split(".")


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype parameter ``name`` takes when the model is cast to
    ``dtype``: float32 for a router, else ``dtype``."""
    return torch.float32 if is_router(name) else dtype


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions (normal /
    sqrt(fan_in) kernels, 0.02-scaled embedding, unit norm scales, zero
    biases; a MoE router float32) → a ``CausalLM`` state dict. Numbers
    come from ``generator``, which must live on ``device``; they differ
    from ``jax.random``'s."""
    return init_from_shapes(param_shapes(cfg), generator, dtype, device)


def init_from_shapes(shapes: Dict[str, Tuple[int, ...]],
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """Random tensors for dotted parameter names, by name: ``*.scale``
    ones, ``*.bias`` zeros, ``*.embedding`` normal x 0.02, every other
    (a ``[..., in, out]`` kernel) normal / sqrt(in); a router float32.

    Layer tensors are drawn one layer at a time in float32 and cast into
    the stacked tensor, so a full-width model needs one layer of float32
    scratch, not the whole model."""
    dev = get_accelerator().resolve_device(device)
    out = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, dtype=leaf_dtype(name, dtype), device=dev)
        if name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith(".bias"):
            t.zero_()
        elif name.endswith(".embedding"):
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


def rope_tables(seq_len: int, head_dim: int, theta: float,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[S, hd/2]`` float32, the JAX ``rope_tables``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    freqs = torch.outer(pos, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, hd]``: rotate the (first half, second half) pairs."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _xla_attention(q, k, v, causal: bool = True):
    """The JAX package's plain attention ``[B, S, H, hd]``: scores in the
    input dtype, softmax in float32, masked scores at the dtype's min."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q, k, v, cfg: TransformerConfig, causal: bool = True):
    """Flash attention (K1-K3) or the plain composition, by
    ``cfg.attn_impl``; ``"auto"`` is flash when ``use_flash`` and
    S >= 128, on either device."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if cfg.use_flash and q.shape[1] >= 128 else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal)
    raise NotImplementedError(f"attn_impl={impl!r} is not ported (ring and "
                              f"ulysses: ROADMAP M9)")


def _fused_rmsnorm_active(cfg: TransformerConfig) -> bool:
    mode = cfg.fused_rmsnorm
    if mode in ("auto", "on", True):
        return True
    if mode in ("off", False):
        return False
    raise ValueError(f"fused_rmsnorm must be auto|on|off, got {mode!r}")


def _layer(x, lp: Dict[str, torch.Tensor], cfg: TransformerConfig, cos, sin,
           fused: bool):
    """One decoder layer; ``lp`` maps ``q_proj.kernel``, ... to this
    layer's slices."""
    B, S, _ = x.shape
    hd, eps = cfg.head_dim, cfg.norm_eps

    def project(h_or_x, name, n_heads, norm_scale=None):
        if norm_scale is None:
            y = h_or_x @ lp[f"{name}.kernel"]
        else:
            y = rmsnorm_matmul(h_or_x, norm_scale, lp[f"{name}.kernel"], eps)
        bias = lp.get(f"{name}.bias")
        if bias is not None:
            y = y + bias
        return y.view(B, S, n_heads, hd)

    if fused:
        ns = lp["attn_norm.scale"]
        q = project(x, "q_proj", cfg.num_heads, ns)
        k = project(x, "k_proj", cfg.num_kv_heads, ns)
        v = project(x, "v_proj", cfg.num_kv_heads, ns)
    else:
        h = rms_norm(x, lp["attn_norm.scale"], eps)
        q = project(h, "q_proj", cfg.num_heads)
        k = project(h, "k_proj", cfg.num_kv_heads)
        v = project(h, "v_proj", cfg.num_kv_heads)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, cfg, causal=True)
    x = x + o.reshape(B, S, -1) @ lp["o_proj.kernel"]
    if fused:
        ns = lp["mlp_norm.scale"]
        gate = F.silu(rmsnorm_matmul(x, ns, lp["gate_proj.kernel"], eps))
        up = rmsnorm_matmul(x, ns, lp["up_proj.kernel"], eps)
    else:
        h = rms_norm(x, lp["mlp_norm.scale"], eps)
        gate = F.silu(h @ lp["gate_proj.kernel"])
        up = h @ lp["up_proj.kernel"]
    return x + (gate * up) @ lp["down_proj.kernel"]


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, S]`` → logits ``[B, S, V]`` in the params' dtype.

    ``params`` maps the dotted names of :func:`param_shapes` to tensors
    (the engine passes bf16 copies made inside autograd). ``cfg.remat``
    recomputes each layer in the backward (``torch.utils.checkpoint``),
    the ``"nothing_saveable"`` policy; other policies are not ported."""
    if cfg.num_experts > 1:
        raise NotImplementedError("MoE training is not ported yet (ROADMAP "
                                  "M9); MoE serves through InferenceEngineV2")
    if cfg.remat and cfg.remat_policy != "nothing_saveable":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; only "
            f"'nothing_saveable' (ROADMAP M9)")
    S = tokens.shape[1]
    x = F.embedding(tokens, params["embed.embedding"])
    cos, sin = rope_tables(S, cfg.head_dim, cfg.rope_theta, device=x.device)
    fused = _fused_rmsnorm_active(cfg)
    per_layer = {name[len("layers."):]: torch.unbind(t, 0)
                 for name, t in params.items() if name.startswith("layers.")}
    for layer in range(cfg.num_layers):
        lp = {name: ts[layer] for name, ts in per_layer.items()}
        if cfg.remat:
            x = checkpoint(_layer, x, lp, cfg, cos, sin, fused,
                           use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, cos, sin, fused)
    x = rms_norm(x, params["norm_f.scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed.embedding"].t()
    return x @ params["lm_head.kernel"]


def lm_loss(params: Dict[str, torch.Tensor], batch: Any,
            cfg: TransformerConfig) -> torch.Tensor:
    """Causal LM loss, float32: predict ``input_ids`` shifted by one.

    ``batch`` is ``{"input_ids": [B, S]}`` (+ optional ``"labels"`` with
    -100 ignored) or the token tensor itself; without labels the last
    position is padded with -100. The mean runs over valid tokens, with
    ``max(count, 1)``."""
    tokens = batch["input_ids"] if isinstance(batch, dict) else batch
    labels = batch.get("labels") if isinstance(batch, dict) else None
    logits = forward(params, tokens, cfg)
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-100)
    valid = labels >= 0
    total = F.cross_entropy(logits.float().flatten(0, 1),
                            torch.where(valid, labels, -100).flatten().long(),
                            ignore_index=-100, reduction="sum")
    return total / valid.sum().clamp(min=1)


class _Node(nn.Module):
    """A named level of the parameter tree (``layers``, ``q_proj``, ...)."""


def register_params(module: nn.Module, expected: Dict[str, Tuple[int, ...]],
                    state: Dict[str, torch.Tensor], trainable: bool) -> None:
    """Register ``state``'s tensors (used as they are, no copy) on
    ``module`` under their dotted names, one ``_Node`` per tree level.
    Raises ``ValueError`` unless the names and shapes are ``expected``."""
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
        node = module
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, _Node())
            node = getattr(node, part)
        node.register_parameter(leaf, nn.Parameter(t,
                                                   requires_grad=trainable))


class CausalLM(nn.Module):
    """Holds the stacked parameters under the JAX names; the serving
    forward is ``inference/v2/model_runner.ragged_forward``, the training
    one :func:`forward` through :meth:`loss_fn`.

    ``state`` is a dict of dotted name → tensor (from :func:`init_params`
    or ``models.convert.params_from_numpy``); its tensors are used as they
    are, without a copy. Parameters require grad only with
    ``trainable=True`` (serving keeps them frozen)."""

    def __init__(self, cfg: TransformerConfig,
                 state: Dict[str, torch.Tensor], trainable: bool = False):
        super().__init__()
        self.config = cfg
        register_params(self, param_shapes(cfg), state, trainable)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def loss_fn(self, params: Dict[str, torch.Tensor], batch: Any,
                rng=None) -> torch.Tensor:
        """``lm_loss`` on ``params`` (the engine's compute copies);
        ``rng`` is accepted for the JAX signature and unused."""
        return lm_loss(params, batch, self.config)

    def flops_per_token(self) -> float:
        """~6N flops/token for training (fwd+bwd), N = non-embedding
        params, plus the lm_head (the JAX ``flops_per_token``)."""
        cfg = self.config
        D, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        per_layer = 2 * D * (cfg.num_heads + 2 * cfg.num_kv_heads) \
            * cfg.head_dim + 2 * cfg.num_heads * cfg.head_dim * D \
            + 3 * 2 * D * Fd
        return 3 * (L * per_layer + 2 * D * cfg.vocab_size)
