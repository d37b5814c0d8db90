"""Optimizers for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/optimizer.py``, which maps DeepSpeed optimizer
names onto optax transforms).

``Adam`` (with ``adam_w_mode``), ``AdamW`` and ``SGD`` are written out in
optax's order, one parameter at a time, in place under ``no_grad``:

  * adamw: ``u = m̂/(√v̂ + eps) + wd·p``, ``p -= lr·u``
    (``optax.adamw``: scale_by_adam, add_decayed_weights,
    scale_by_learning_rate);
  * adam with L2 decay (``adam_w_mode: false``): ``g += wd·p`` first;
  * sgd: ``g += wd·p``; momentum ``t = g + μ·t`` (Nesterov: ``g + μ·t``).

``lr`` for an update is ``schedule(count)``, ``count`` being the updates
taken so far (from 0), as optax's ``scale_by_schedule`` reads it; the
engine calls :meth:`step` only for updates it applies, so a step skipped
on overflow does not advance it. One parameter at a time keeps the
scratch to the largest tensor instead of the whole model.

Names not offered yet raise ``NotImplementedError`` naming their
``ROADMAP.md`` item: the ``Fused*`` names run on kernels K5 and K13–K15,
which are not ported; LAMB, Lion, Adagrad, Muon and the 1-bit optimizers
wait for their items.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

_NOT_OFFERED = {
    "fusedadam": "K5, Queue 1 M3 remainder",
    "fusedlamb": "K13, Queue 2",
    "fusedlion": "K14, Queue 2",
    "fusedadagrad": "K15, Queue 2",
    "lamb": "Queue 1 M3 remainder",
    "lion": "Queue 1 M3 remainder",
    "adagrad": "Queue 1 M3 remainder",
    "muon": "Queue 1 M3 remainder",
    "onebitadam": "Queue 1 M8",
    "onebitlamb": "Queue 1 M8",
    "zerooneadam": "Queue 1 M8",
}


class _Optimizer:
    """Per-parameter state, an update count, and an lr schedule."""

    def __init__(self, lr: Callable[[int], float], weight_decay: float):
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.state: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        self.state = {name: self._init_one(p) for name, p in params.items()}

    def _init_one(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def current_lr(self) -> float:
        return float(self.lr(self.count))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """One update, in place, with ``lr = schedule(count)``."""
        lr = self.current_lr()
        for name, p in params.items():
            self._update_one(p, grads[name], self.state[name], lr)
        self.count += 1


class AdamW(_Optimizer):
    """optax ``adamw`` (``decoupled=True``) or ``adam`` with L2 weight
    decay added to the gradient first (``decoupled=False``)."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 decoupled=True):
        super().__init__(lr, weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.decoupled = decoupled

    def _init_one(self, p):
        return torch.zeros_like(p), torch.zeros_like(p)

    def _update_one(self, p, g, state, lr):
        m, v = state
        wd = self.weight_decay
        if wd and not self.decoupled:
            g = g + wd * p
        m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        t = self.count + 1
        u = m / (1.0 - self.b1 ** t)
        u.div_((v / (1.0 - self.b2 ** t)).sqrt_().add_(self.eps))
        if wd and self.decoupled:
            u.add_(p, alpha=wd)
        p.add_(u, alpha=-lr)


class SGD(_Optimizer):
    """optax ``sgd`` (optional momentum, Nesterov) after L2 weight decay."""

    def __init__(self, lr, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(lr, weight_decay)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)

    def _init_one(self, p):
        return (torch.zeros_like(p),) if self.momentum else ()

    def _update_one(self, p, g, state, lr):
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum:
            (trace,) = state
            trace.mul_(self.momentum).add_(g)
            g = g + self.momentum * trace if self.nesterov else trace
        p.add_(g, alpha=-lr)


def build_optimizer(opt_type: str, params: Dict[str, Any],
                    learning_rate: Callable[[int], float]) -> _Optimizer:
    """The optimizer for a DeepSpeed config name, in optax's order;
    ``learning_rate`` is the schedule (``count -> lr``)."""
    name = opt_type.lower()
    lr = learning_rate
    betas = tuple(params.get("betas", (0.9, 0.999)))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    if name in _NOT_OFFERED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (ROADMAP "
            f"{_NOT_OFFERED[name]})")
    if name == "adam":
        decoupled = bool(params.get("adam_w_mode", True))
        return AdamW(lr, betas[0], betas[1], eps, wd, decoupled=decoupled)
    if name == "adamw":
        return AdamW(lr, betas[0], betas[1], eps, wd, decoupled=True)
    if name == "sgd":
        return SGD(lr, momentum=params.get("momentum", 0.0),
                   nesterov=params.get("nesterov", False), weight_decay=wd)
    raise ValueError(f"unknown optimizer {opt_type!r}; supported: adam, "
                     f"adamw, sgd")
