"""Flash attention for the PyTorch port (counterpart of
``deepspeed_tpu/ops/transformer/flash_attention.py``).

Three kernels, written by hand in CUDA C++ for Hopper, replace the JAX
package's three Pallas kernels:

  * :func:`flash_attention_fwd` — ``csrc/flash_attention_fwd.cu``,
    replacing ``_fwd_kernel`` (O and the float32 row log-sum-exp);
  * :func:`flash_attention_bwd_dq` — ``csrc/flash_attention_bwd.cu``,
    replacing ``_bwd_dq_kernel``;
  * :func:`flash_attention_bwd_dkv` — ``csrc/flash_attention_bwd.cu``,
    replacing ``_bwd_dkv_kernel``.

:func:`flash_attention` wires them into a ``torch.autograd.Function``
that matches the reference's ``custom_vjp`` on ``_flash_bhsd``: the
forward saves q, k, v, O and the LSE; the backward computes
δ = rowsum(dO∘O) in float32 outside the kernels, then dQ and dK/dV.

Layouts keep the model's ``[B, S, H, hd]`` (the kernels read that layout
directly, so no transpose is made); the LSE and δ are ``[B, H, S]``
float32. GQA repeats the KV heads before the Function, as the reference
does, so autograd of the repeat sums dK and dV over each group.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it (``*_reference``),
which the CPU tests hold against the JAX kernels in interpret mode. The
backward's plain versions are the recompute math of ``_bwd`` (P from the
LSE), not autograd of the plain forward. Each wrapper counts its kernel
launches in ``<wrapper>.launches``. The CUDA kernels choose their own
tiles (bf16, TMA + wgmma: a block owns 128 rows, two warpgroups of 64;
the forward walks 128-key tiles, the backward 64-row tiles; float32:
64 x 64 on the CUDA cores); the model's ``flash_block_q``/``flash_block_k``
do not steer them. They are built for head dims 64, 128 and 256 (256 on
the exact tile kernels, in both types): any other hd up to 256 is
zero-padded to the next of the three (:func:`run_padded`; q, k, v and dO
are per-call activations, so the copies are cheap), with the scale from
the true hd and O, dQ, dK and dV sliced back; hd above 256 raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ...accelerator import get_accelerator
from ..op_builder.builder import DTYPE_CODES, check_launch, kernel_function

_NEG_INF = -1e30
#: the head dims the attention kernels are built for (K1-K3 here, K16-K19
#: in ``sparse_attention/block_sparse_kernel.py``); :func:`kernel_head_dim`
#: pads any other hd up to the next of them
KERNEL_HEAD_DIMS = (64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P]
_DQ_ARGS = [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P]
_DKV_ARGS = [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]


def _check_kernel_inputs(name, tensors, stats=()):
    """What the CUDA kernels take: one CUDA device, contiguous float32 or
    bfloat16 ``[B, S, H, hd]`` tensors of one dtype with hd in
    :data:`KERNEL_HEAD_DIMS`,
    16-byte aligned, with rows (``H·hd`` elements) a multiple of 16 bytes
    (TMA's stride rule for the bf16 backward's tensor maps); contiguous
    float32 row statistics."""
    first = tensors[0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not {dev}")
    if first.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: float32 or bfloat16 inputs, not "
                         f"{first.dtype}")
    if first.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {first.shape[-1]}")
    for t in tensors:
        if t.device != dev or t.dtype != first.dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")
        if tuple(t.shape) != tuple(first.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(first.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             f"aligned")
        if t.stride(1) * t.element_size() % 16:
            raise ValueError(f"{name}: rows of {t.stride(1)} elements are "
                             f"not a multiple of 16 bytes")
    B, S, H, _ = first.shape
    for t in stats:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, S) or not t.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"[{B}, {H}, {S}] on {dev}")


def kernel_head_dim(hd: int) -> int:
    """The head dim the CUDA kernels run ``hd`` at: the first of
    :data:`KERNEL_HEAD_DIMS` (64, 128, 256) at or above it. 64 and 128 run
    the TMA + wgmma kernels in bf16; 256 runs the exact tile kernels in
    both types (a [128 x 256] owned tile and its ring do not fit the
    wgmma kernels' shared memory). Raises above 256, the widest head the
    reference's model families use. The block-sparse kernels (K16-K19)
    share the rule."""
    for width in KERNEL_HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"the attention kernels take head_dim <= "
                     f"{KERNEL_HEAD_DIMS[-1]}, got {hd}: no kernel is built "
                     f"wider (a 16-row slice of a {hd}-wide float32 "
                     f"accumulator is more than a thread's registers hold)")


def run_padded(fn: Callable, tensors, n_sliced: int, *rest):
    """``fn(*tensors, *rest)`` with each ``[..., hd]`` tensor of
    ``tensors`` zero-padded to :func:`kernel_head_dim` (a fresh copy; the
    padded columns add +0 to every product and to δ) and the first
    ``n_sliced`` outputs sliced back to hd; the row statistics in ``rest``
    and the other outputs pass unchanged. ``rest`` carries the scale,
    which the caller takes from the true hd."""
    hd = tensors[0].shape[-1]
    width = kernel_head_dim(hd)
    if width == hd:
        return fn(*tensors, *rest)
    out = fn(*(F.pad(t, (0, width - hd)) for t in tensors), *rest)
    outs = out if isinstance(out, tuple) else (out,)
    outs = tuple(o[..., :hd].contiguous() if i < n_sliced else o
                 for i, o in enumerate(outs))
    return outs if isinstance(out, tuple) else outs[0]


def _stream(t: torch.Tensor) -> int:
    return get_accelerator().current_stream(t.device).cuda_stream


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# --------------------------------------------------------------------- #
# Plain PyTorch versions (float32 math)
# --------------------------------------------------------------------- #
def _scores(q, k, scale):
    """[B, S, H, hd] x2 → float32 scores [B, H, Sq, Sk]."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _causal_mask(S, device):
    pos = torch.arange(S, device=device)
    return pos[:, None] >= pos[None, :]


def flash_attention_fwd_reference(q, k, v, causal: bool = True,
                                  scale: Optional[float] = None):
    """Plain version of :func:`flash_attention_fwd`: masked softmax in
    float32 (masked scores -1e30, as the reference), → (O in q's dtype,
    LSE ``[B, H, S]`` float32)."""
    s = _scores(q, k, _scale(q, scale))
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """P = exp(S - lse) (0 where masked) and dS = P∘(dO·Vᵀ − δ)·scale, the
    recompute math of the reference's backward kernels, in float32
    ``[B, H, Sq, Sk]``; ``scale`` must be given."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(q.shape[1], q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                     causal: bool = True,
                                     scale: Optional[float] = None):
    """Plain version of :func:`flash_attention_bwd_dq`: dQ = dS·K."""
    _, ds = probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal: bool = True,
                                      scale: Optional[float] = None):
    """Plain version of :func:`flash_attention_bwd_dkv`: dK = dSᵀ·Q and
    dV = Pᵀ·dO."""
    p, ds = probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# K1: forward
# --------------------------------------------------------------------- #
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over ``[B, S, H, hd]`` q, k, v (KV heads already repeated
    to H) → (O ``[B, S, H, hd]``, LSE ``[B, H, S]`` float32).

    Replaces ``_fwd_kernel``. On CUDA: ``csrc/flash_attention_fwd.cu``
    (bf16: TMA + wgmma, a block of 128 query rows walking 128-key tiles,
    the softmax in base 2, deterministic; hd off 64/128 zero-padded,
    :func:`run_padded`). Bound on the H100: operations, 4·hd flops per
    visible (query, key) pair and head at 989 TFLOP/s in bf16."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    return run_padded(_fwd_launch, (q, k, v), 1, causal, scale)


def _fwd_launch(q, k, v, causal, scale):
    _check_kernel_inputs("flash_attention_fwd", (q, k, v))
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = kernel_function("flash_attention_fwd", "flash_attention_fwd_launch",
                          _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, H, hd, scale, int(causal),
        DTYPE_CODES[q.dtype], _stream(q))
    check_launch("flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


# --------------------------------------------------------------------- #
# K2: dQ
# --------------------------------------------------------------------- #
def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dQ of :func:`flash_attention_fwd` from the saved LSE and δ.

    Replaces ``_bwd_dq_kernel``. On CUDA: ``csrc/flash_attention_bwd.cu``
    (bf16: TMA + wgmma, deterministic). Bound: operations, 6·hd flops per
    visible pair and head."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale)
    return run_padded(_dq_launch, (q, k, v, do), 1, lse, delta, causal,
                      scale)


def _dq_launch(q, k, v, do, lse, delta, causal, scale):
    _check_kernel_inputs("flash_attention_bwd_dq", (q, k, v, do),
                         (lse, delta))
    B, S, H, hd = q.shape
    dq = torch.empty_like(q)
    err = kernel_function("flash_attention_bwd",
                          "flash_attention_bwd_dq_launch", _DQ_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, hd, scale,
        int(causal), DTYPE_CODES[q.dtype], _stream(q))
    check_launch("flash_attention_bwd_dq", err)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


# --------------------------------------------------------------------- #
# K3: dK, dV
# --------------------------------------------------------------------- #
def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of :func:`flash_attention_fwd` from the saved LSE and δ.

    Replaces ``_bwd_dkv_kernel``. On CUDA: ``csrc/flash_attention_bwd.cu``
    (bf16: TMA + wgmma, deterministic). Bound: operations, 8·hd flops per
    visible pair and head."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    return run_padded(_dkv_launch, (q, k, v, do), 2, lse, delta, causal,
                      scale)


def _dkv_launch(q, k, v, do, lse, delta, causal, scale):
    _check_kernel_inputs("flash_attention_bwd_dkv", (q, k, v, do),
                         (lse, delta))
    B, S, H, hd = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = kernel_function("flash_attention_bwd",
                          "flash_attention_bwd_dkv_launch", _DKV_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
        H, hd, scale, int(causal), DTYPE_CODES[q.dtype], _stream(q))
    check_launch("flash_attention_bwd_dkv", err)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# --------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------- #
class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_bhsd`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()                          # [B, H, S]
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[B, S, H, hd]`` inputs (GQA: k and v may
    have fewer heads, a divisor of H), differentiable → ``[B, S, H, hd]``.
    """
    H, KV = q.shape[2], k.shape[2]
    if H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads "
                         f"{KV}")
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _scale(q, scale))
