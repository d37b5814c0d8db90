"""Fused RMSNorm + matmul for the PyTorch port (counterpart of the
``rmsnorm_matmul`` part of
``deepspeed_tpu/kernels/fused_collective_matmul.py``).

:func:`rmsnorm_matmul` computes ``rms_norm(x, scale, eps) @ w`` with the
normalised activations never written to device memory. Its forward is
the kernel ``csrc/rmsnorm_matmul.cu``, written by hand in CUDA C++ for
Hopper, replacing the Pallas ``_rmsnorm_matmul_kernel``. Its backward is
autograd of the reference composition
(:func:`rmsnorm_matmul_reference`), as the JAX package's custom VJP is,
so the cotangents are the unfused path's; the backward's products stay
``torch.matmul`` (cuBLAS), as the reference leaves them to XLA.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`rmsnorm_matmul_reference`, which the CPU tests hold
against the JAX kernel in interpret mode. ``rmsnorm_matmul_fwd.launches``
counts the kernel's launches. The shard-major and gathered-dequant
matmuls of the JAX module (K11, K12) are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from ..accelerator import get_accelerator
from ..ops.op_builder.builder import DTYPE_CODES, check_launch, kernel_function

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 accumulation, output in the promoted input
    dtype (the JAX ``matmul_reference``); bfloat16 products go to
    ``torch.matmul``, which accumulates in float32."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def _normalize(x: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``models/transformer.py rms_norm``: the variance in float32, the
    normaliser cast to x's dtype before the products."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rmsnorm_matmul_reference(x: torch.Tensor, scale: torch.Tensor,
                             w: torch.Tensor, eps: float) -> torch.Tensor:
    """The unfused composition (``rms_norm`` then the projection) the
    kernel is held against."""
    return matmul_reference(_normalize(x, scale, eps), w)


def rmsnorm_matmul_fwd(x2: torch.Tensor, scale: torch.Tensor,
                       w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's forward on ``x2 [M, D]``, ``scale [D]``, ``w [D, F]``
    → ``[M, F]``; the plain composition for CPU tensors.

    Replaces ``_rmsnorm_matmul_kernel``. Bound on the H100: operations,
    2·M·D·F flops at 989 TFLOP/s in bf16."""
    if x2.device.type == "cpu":
        return rmsnorm_matmul_reference(x2, scale, w, eps)
    M, D = x2.shape
    F = w.shape[1]
    name = "rmsnorm_matmul"
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not "
                         f"{x2.device}")
    for t in (scale, w):
        if t.device != x2.device or t.dtype != x2.dtype:
            raise ValueError(f"{name}: x, scale and w must share device and "
                             f"dtype")
    if x2.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: float32 or bfloat16, not {x2.dtype}")
    if tuple(scale.shape) != (D,) or w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"{name}: x [M, {D}], scale [{D}], w [{D}, F]; got "
                         f"{tuple(scale.shape)}, {tuple(w.shape)}")
    if D % 8 or F % 8:
        raise ValueError(f"{name}: the kernel needs D and F multiples of 8, "
                         f"got {D}, {F}")
    for t in (x2, scale, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             f"aligned")
    y = torch.empty(M, F, dtype=x2.dtype, device=x2.device)
    err = kernel_function(name, "rmsnorm_matmul_launch", _ARGS)(
        x2.data_ptr(), scale.data_ptr(), w.data_ptr(), y.data_ptr(), M, D, F,
        float(eps), DTYPE_CODES[x2.dtype],
        get_accelerator().current_stream(x2.device).cuda_stream)
    check_launch(name, err)
    rmsnorm_matmul_fwd.launches += 1
    return y


rmsnorm_matmul_fwd.launches = 0


class _RMSNormMatmul(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the reference
    composition (the JAX ``_rmsnorm_matmul_bwd``), with the projection's
    two products written out so that its unused forward product is not
    recomputed."""

    @staticmethod
    def forward(ctx, x2, scale, w, eps):
        ctx.save_for_backward(x2, scale, w)
        ctx.eps = eps
        return rmsnorm_matmul_fwd(x2, scale, w, eps)

    @staticmethod
    def backward(ctx, g):
        x2, scale, w = ctx.saved_tensors
        with torch.enable_grad():
            xs = x2.detach().requires_grad_()
            ss = scale.detach().requires_grad_()
            h = _normalize(xs, ss, ctx.eps)
        dw = matmul_reference(h.detach().t(), g) \
            if ctx.needs_input_grad[2] else None
        dx, ds = torch.autograd.grad(h, (xs, ss), matmul_reference(g, w.t()))
        return dx, ds, dw, None


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``rms_norm(x, scale, eps) @ w`` in one kernel, differentiable.

    ``x`` may carry leading batch dims; its last dim contracts with
    ``w [D, F]``. → ``[..., F]``."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    out = _RMSNormMatmul.apply(x.reshape(-1, D).contiguous(),
                               scale.reshape(D).contiguous(), w.contiguous(),
                               float(eps))
    return out.reshape(*lead, w.shape[1])
