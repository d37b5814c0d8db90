"""Fused LAMB for the PyTorch port (counterpart of
``deepspeed_tpu/ops/lamb/fused_lamb.py``).

The streaming pass — Adam-style moments and the raw update
``u = m̂/(√v̂ + eps) + wd·p`` — is the kernel ``fused_lamb_launch`` in
``csrc/fused_optimizers.cu`` (K13), written by hand in CUDA C++ for
Hopper, replacing the Pallas ``_lamb_raw_kernel``. As in the reference,
the two norms ‖p‖ and ‖u‖ over the whole leaf (a stacked ``[L, …]``
tensor is one leaf), the trust ratio ``‖p‖/max(‖u‖, 1e-12)`` (1 where
either norm is 0) clipped to ``[min_trust, max_trust]``, and
``p − lr·trust·u`` come after the kernel; here they are PyTorch
reductions and elementwise ops on the device, with no host sync. ``u`` is
scratch as large as the leaf.

On a CUDA tensor :func:`fused_lamb_update` launches the kernel or raises;
on a CPU tensor it runs the plain raw pass :func:`lamb_raw_reference`.
:func:`fused_lamb_update_reference` is the whole plain update.
``fused_lamb_update.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from ..adam.fused_adam import (bias_correction, check_leaf, device_scalar,
                               launcher)
from ..op_builder.builder import check_launch


def lamb_raw_reference(p, g, m, v, u, bc1, bc2, beta1=0.9, beta2=0.999,
                       eps=1e-6, weight_decay=0.0):
    """Plain version of K13 in ``_lamb_raw_kernel``'s order: m, v in
    place, the raw update into ``u``."""
    m.mul_(beta1).add_(g * (1.0 - beta1))
    v.mul_(beta2).add_(g * (1.0 - beta2) * g)
    u.copy_((m / device_scalar(bc1, p)) / (
        (v / device_scalar(bc2, p)).sqrt() + eps))
    if weight_decay:
        u.add_(p * weight_decay)
    return u


def _trust_update(p, u, lr, min_trust, max_trust):
    """``p −= lr·trust·u`` with the leaf's trust ratio; ``u`` is
    overwritten (the reference's ``fused_lamb.py:65-71``)."""
    p_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    trust = torch.where((p_norm > 0) & (u_norm > 0),
                        p_norm / torch.clamp(u_norm, min=1e-12),
                        torch.ones_like(p_norm))
    trust = torch.clamp(trust, min_trust, max_trust)
    p.sub_(u.mul_(trust * lr))


def fused_lamb_update_reference(p, g, m, v, step, lr=1e-3, beta1=0.9,
                                beta2=0.999, eps=1e-6, weight_decay=0.0,
                                min_trust=0.01, max_trust=10.0):
    """The whole LAMB step on one leaf with the plain raw pass; p, m, v in
    place. → (p, m, v)."""
    u = torch.empty_like(p)
    lamb_raw_reference(p, g, m, v, u, bias_correction(beta1, step),
                       bias_correction(beta2, step), beta1, beta2, eps,
                       weight_decay)
    _trust_update(p, u, lr, min_trust, max_trust)
    return p, m, v


def fused_lamb_update(p, g, m, v, step, lr=1e-3, beta1=0.9, beta2=0.999,
                      eps=1e-6, weight_decay=0.0, min_trust=0.01,
                      max_trust=10.0):
    """One LAMB step on one float32 leaf, in place; ``step`` is the update
    count from 0. → (p, m, v).

    Replaces ``_lamb_raw_kernel`` (K13). Bound on the H100: bytes, 28 per
    element for the kernel (reads p, g, m, v; writes u, m, v) plus 12 for
    the norms and the write of p (reads p and u; writes p), at 3.35 TB/s."""
    bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
    if p.device.type == "cpu":
        u = torch.empty_like(p)
        lamb_raw_reference(p, g, m, v, u, bc1, bc2, beta1, beta2, eps,
                           weight_decay)
    else:
        stream = check_leaf("fused_lamb", p, g, m, v)
        u = torch.empty_like(p)
        err = launcher("fused_lamb_launch")(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            u.data_ptr(), p.numel(), beta1, beta2, 1.0 - beta1, 1.0 - beta2,
            eps, weight_decay, bc1, bc2, stream)
        check_launch("fused_lamb", err)
        fused_lamb_update.launches += 1
    _trust_update(p, u, lr, min_trust, max_trust)
    return p, m, v


fused_lamb_update.launches = 0
