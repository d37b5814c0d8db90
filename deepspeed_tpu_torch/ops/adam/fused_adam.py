"""Fused Adam/AdamW, Lion and Adagrad for the PyTorch port (counterpart of
``deepspeed_tpu/ops/adam/fused_adam.py``).

Three kernels, written by hand in CUDA C++ for Hopper
(``csrc/fused_optimizers.cu``), replace the JAX package's Pallas kernels:

  * :func:`fused_adam_update` — K5, replacing ``_adam_kernel``;
  * :func:`fused_lion_update` — K14, replacing ``_lion_kernel``;
  * :func:`fused_adagrad_update` — K15, replacing ``_adagrad_kernel``.

Each updates one float32 leaf in one pass over device memory, in place
(the JAX functions return new arrays; the port writes ``new_p`` where the
reference's optax wrapper returns ``new_p - p`` for the engine to add
back, so the two can differ by an ulp of ``p``). On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
PyTorch version beside it (``*_reference``), which the CPU tests hold
against the Pallas kernels in interpret mode and ``chip_smoke.py`` holds
against the kernel on the card. Each wrapper counts its launches in
``<wrapper>.launches``.

The plain versions follow the Pallas bodies' order with every operation
rounded once, as the kernels round (no FMA contraction): scalars are
multiplied, added and divided one at a time, and the bias corrections
divide through float32 device tensors, because PyTorch divides by a CPU
scalar through its reciprocal. The bias corrections ``1 - beta**t`` are
computed in float32 with ``t = step + 1``, as the reference computes them.

:func:`multi_tensor_apply` is the multi-tensor entry: it updates every
leaf of a model with one launch per leaf.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Mapping, Sequence

import torch

from ...accelerator import get_accelerator
from ..op_builder.builder import check_launch, kernel_function

_LIB = "fused_optimizers"
_P, _F, _N = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
ARGTYPES = {
    "fused_adam_launch": [_P] * 4 + [_N] + [_F] * 9 + [ctypes.c_int, _P],
    "fused_lamb_launch": [_P] * 5 + [_N] + [_F] * 8 + [_P],
    "fused_lion_launch": [_P] * 3 + [_N] + [_F] * 6 + [_P],
    "fused_adagrad_launch": [_P] * 3 + [_N] + [_F] * 3 + [_P],
}


def launcher(fn: str):
    """The ``extern "C"`` launcher ``fn`` of ``csrc/fused_optimizers.cu``,
    built on first use."""
    return kernel_function(_LIB, fn, ARGTYPES[fn])


def bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** (step + 1)`` in float32 (the reference's
    ``t = step.astype(f32) + 1``; ``1.0 - beta ** t``)."""
    t = torch.tensor(float(step), dtype=torch.float32) + 1.0
    return float(1.0 - torch.tensor(beta, dtype=torch.float32) ** t)


def device_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 0-dim tensor on ``like``'s device (a divisor that
    PyTorch divides by exactly, not through its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def check_leaf(name: str, p: torch.Tensor, *others: torch.Tensor):
    """Raise unless ``p`` and ``others`` are float32 CUDA tensors of one
    shape, contiguous and 16-byte aligned. → the current CUDA stream."""
    if p.device.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not "
                         f"{p.device}")
    for t in (p, *others):
        if t.device != p.device or t.dtype != torch.float32 \
                or t.shape != p.shape:
            raise ValueError(f"{name}: every array must be float32 on "
                             f"{p.device} with shape {tuple(p.shape)}; got "
                             f"{t.dtype} on {t.device}, {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: arrays must be contiguous and 16-byte "
                             f"aligned")
    return get_accelerator().current_stream(p.device).cuda_stream


# --------------------------------------------------------------------- #
# K5: Adam / AdamW
# --------------------------------------------------------------------- #
def fused_adam_update_reference(p, g, m, v, step, lr=1e-3, beta1=0.9,
                                beta2=0.999, eps=1e-8, weight_decay=0.0,
                                adam_w_mode=True):
    """Plain version of K5 in ``_adam_kernel``'s order; p, m, v in place.
    → (p, m, v)."""
    bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
    if weight_decay and not adam_w_mode:
        g = g + p * weight_decay
    m_new = m * beta1 + g * (1.0 - beta1)
    v_new = v * beta2 + g * (1.0 - beta2) * g
    u = (m_new / device_scalar(bc1, p)) / (
        (v_new / device_scalar(bc2, p)).sqrt() + eps)
    if weight_decay and adam_w_mode:
        u = u + p * weight_decay
    p.sub_(u * lr)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def fused_adam_update(p, g, m, v, step, lr=1e-3, beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=0.0, adam_w_mode=True):
    """One Adam (``adam_w_mode=False``: L2 decay added to g) or AdamW step
    on one float32 leaf, in place; ``step`` is the update count from 0.
    → (p, m, v).

    Replaces ``_adam_kernel`` (K5). Bound on the H100: bytes, 28 per
    element at 3.35 TB/s."""
    if p.device.type == "cpu":
        return fused_adam_update_reference(
            p, g, m, v, step, lr, beta1, beta2, eps, weight_decay,
            adam_w_mode)
    stream = check_leaf("fused_adam", p, g, m, v)
    bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
    err = launcher("fused_adam_launch")(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps, weight_decay, lr, bc1,
        bc2, int(bool(adam_w_mode)), stream)
    check_launch("fused_adam", err)
    fused_adam_update.launches += 1
    return p, m, v


fused_adam_update.launches = 0


# --------------------------------------------------------------------- #
# K14: Lion
# --------------------------------------------------------------------- #
def fused_lion_update_reference(p, g, m, lr=1e-4, beta1=0.9, beta2=0.99,
                                weight_decay=0.0):
    """Plain version of K14 in ``_lion_kernel``'s order; p, m in place.
    → (p, m)."""
    u = (m * beta1 + g * (1.0 - beta1)).sign() + p * weight_decay
    m_new = m * beta2 + g * (1.0 - beta2)
    p.sub_(u * lr)
    m.copy_(m_new)
    return p, m


def fused_lion_update(p, g, m, lr=1e-4, beta1=0.9, beta2=0.99,
                      weight_decay=0.0):
    """One Lion step on one float32 leaf, in place. → (p, m).

    Replaces ``_lion_kernel`` (K14). Bound on the H100: bytes, 20 per
    element at 3.35 TB/s."""
    if p.device.type == "cpu":
        return fused_lion_update_reference(p, g, m, lr, beta1, beta2,
                                           weight_decay)
    stream = check_leaf("fused_lion", p, g, m)
    err = launcher("fused_lion_launch")(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), p.numel(), beta1, beta2,
        1.0 - beta1, 1.0 - beta2, weight_decay, lr, stream)
    check_launch("fused_lion", err)
    fused_lion_update.launches += 1
    return p, m


fused_lion_update.launches = 0


# --------------------------------------------------------------------- #
# K15: Adagrad
# --------------------------------------------------------------------- #
def fused_adagrad_update_reference(p, g, a, lr=1e-2, eps=1e-10,
                                   weight_decay=0.0):
    """Plain version of K15 in ``_adagrad_kernel``'s order; p, a in place.
    → (p, a)."""
    if weight_decay:
        g = g + p * weight_decay
    a.add_(g * g)
    p.sub_((g * lr) / (a.sqrt() + eps))
    return p, a


def fused_adagrad_update(p, g, a, lr=1e-2, eps=1e-10, weight_decay=0.0):
    """One Adagrad step on one float32 leaf (accumulator ``a`` from 0, L2
    decay folded into g), in place. → (p, a).

    Replaces ``_adagrad_kernel`` (K15). Bound on the H100: bytes, 20 per
    element at 3.35 TB/s."""
    if p.device.type == "cpu":
        return fused_adagrad_update_reference(p, g, a, lr, eps, weight_decay)
    stream = check_leaf("fused_adagrad", p, g, a)
    err = launcher("fused_adagrad_launch")(
        p.data_ptr(), g.data_ptr(), a.data_ptr(), p.numel(), eps,
        weight_decay, lr, stream)
    check_launch("fused_adagrad", err)
    fused_adagrad_update.launches += 1
    return p, a


fused_adagrad_update.launches = 0


# --------------------------------------------------------------------- #
# Multi-tensor entry
# --------------------------------------------------------------------- #
def multi_tensor_apply(update: Callable, params: Mapping[str, torch.Tensor],
                       grads: Mapping[str, torch.Tensor],
                       states: Mapping[str, Sequence[torch.Tensor]],
                       **kwargs) -> None:
    """``update(p, g, *state, **kwargs)`` on every leaf of a model, in the
    order of ``params``: one kernel launch per leaf (the reference's optax
    wrapper maps its kernel over the leaves the same way)."""
    for name, p in params.items():
        update(p, grads[name], *states[name], **kwargs)

