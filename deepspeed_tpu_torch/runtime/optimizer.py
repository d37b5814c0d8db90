"""Optimizers for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/optimizer.py``, which maps DeepSpeed optimizer
names onto optax transforms and the Pallas fused kernels).

The names the JAX factory builds from optax are written out in optax's
order, one parameter at a time, in place under ``no_grad``:

  * adamw: ``u = m̂/(√v̂ + eps) + wd·p``, ``p -= lr·u``
    (``optax.adamw``: scale_by_adam, add_decayed_weights,
    scale_by_learning_rate);
  * adam with L2 decay (``adam_w_mode: false``): ``g += wd·p`` first;
  * sgd: ``g += wd·p``; momentum ``t = g + μ·t`` (Nesterov: ``g + μ·t``);
  * lamb (``optax.lamb``): adam's ``u``, ``+ wd·p``, times the leaf's
    trust ratio ‖p‖/‖u‖ (1 where either norm is 0, unclipped);
  * lion (``optax.lion``): ``u = sign((1−b1)·g + b1·m) + wd·p``,
    ``m = (1−b2)·g + b2·m``;
  * adagrad (``optax.adagrad``): the sum of squares starts at 0.1,
    ``u = g·rsqrt(s + eps)`` where ``s > 0``; weight decay is ignored, as
    the JAX factory ignores it.

The ``Fused*`` names run the port's kernels over every leaf
(``ops/adam/fused_adam.py`` K5, K14, K15; ``ops/lamb/fused_lamb.py`` K13)
with the reference kernels' own semantics, which differ from the optax
names: FusedLamb clips the trust ratio to [0.01, 10]; FusedAdagrad starts
its accumulator at 0, divides by ``√a + eps`` and folds L2 decay into g.
Defaults are the JAX factory's: eps 1e-8 (FusedLamb too; FusedAdagrad
1e-10), betas (0.9, 0.999), Lion's and FusedLion's (0.9, 0.99) unless the
config spells them out.

``lr`` for an update is ``schedule(count)``, ``count`` being the updates
taken so far (from 0), as optax's ``scale_by_schedule`` reads it; the
engine calls :meth:`step` only for updates it applies, so a step skipped
on overflow does not advance it. Each optimizer names its per-parameter
state (``state_names``; ``named_state``) with the universal checkpoint
layout's names, which the engine's checkpoints read and write.

Muon and the 1-bit optimizers raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..ops.adam.fused_adam import (bias_correction, fused_adagrad_update,
                                   fused_adam_update, fused_lion_update,
                                   multi_tensor_apply)
from ..ops.lamb.fused_lamb import fused_lamb_update

_NOT_OFFERED = {
    "muon": "Queue 1 Muon (optax.contrib.muon)",
    "onebitadam": "Queue 1 M8",
    "onebitlamb": "Queue 1 M8",
    "zerooneadam": "Queue 1 M8",
}

_ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


class _Optimizer:
    """Per-parameter state, an update count, and an lr schedule."""

    #: names of one parameter's state tensors, in ``state[name]`` order:
    #: the leaf names of the universal checkpoint layout
    state_names: Tuple[str, ...] = ()

    def __init__(self, lr: Callable[[int], float], weight_decay: float):
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.state: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        self.state = {name: self._init_one(p) for name, p in params.items()}

    def _init_one(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.zeros_like(p) for _ in self.state_names)

    def named_state(self, name: str) -> Dict[str, torch.Tensor]:
        """Parameter ``name``'s state tensors by their layout names."""
        return dict(zip(self.state_names, self.state[name]))

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

    state_names = _ADAM_MOMENTS

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 decoupled=True):
        super().__init__(lr, weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.decoupled = decoupled

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


class Lamb(AdamW):
    """optax ``lamb``: the adam update plus decoupled weight decay, scaled
    by the leaf's trust ratio ‖p‖/‖u‖ (1 where either norm is 0)."""

    def _update_one(self, p, g, state, lr):
        m, v = state
        m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        u = m / bias_correction(self.b1, self.count)
        u.div_((v / bias_correction(self.b2, self.count)).sqrt_()
               .add_(self.eps))
        u.add_(p, alpha=self.weight_decay)
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
        trust = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        p.sub_(u.mul_(trust).mul_(lr))


class Lion(_Optimizer):
    """optax ``lion``."""

    state_names = ("exp_avg",)

    def __init__(self, lr, b1=0.9, b2=0.99, weight_decay=0.0):
        super().__init__(lr, weight_decay)
        self.b1, self.b2 = float(b1), float(b2)

    def _update_one(self, p, g, state, lr):
        (m,) = state
        u = (g * (1.0 - self.b1)).add_(m, alpha=self.b1).sign_()
        m.mul_(self.b2).add_(g, alpha=1.0 - self.b2)
        u.add_(p, alpha=self.weight_decay)
        p.add_(u, alpha=-lr)


class Adagrad(_Optimizer):
    """optax ``adagrad``: the sum of squares starts at 0.1; no weight
    decay (the JAX factory passes none)."""

    state_names = ("sum_of_squares",)
    initial_accumulator_value = 0.1

    def __init__(self, lr, eps=1e-8):
        super().__init__(lr, 0.0)
        self.eps = float(eps)

    def _init_one(self, p):
        return (torch.full_like(p, self.initial_accumulator_value),)

    def _update_one(self, p, g, state, lr):
        (s,) = state
        s.addcmul_(g, g)
        inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                          torch.zeros_like(s))
        p.add_(inv.mul_(g), alpha=-lr)


class SGD(_Optimizer):
    """optax ``sgd`` (optional momentum, Nesterov) after L2 weight decay."""

    def __init__(self, lr, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(lr, weight_decay)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)
        self.state_names = ("momentum_buffer",) if self.momentum else ()

    def _update_one(self, p, g, state, lr):
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum:
            (trace,) = state
            trace.mul_(self.momentum).add_(g)
            g = g + self.momentum * trace if self.nesterov else trace
        p.add_(g, alpha=-lr)


class _Fused(_Optimizer):
    """A ``Fused*`` name: its kernel over every leaf through
    ``multi_tensor_apply`` (one launch per leaf); ``update`` is the
    per-leaf wrapper, called as ``update(p, g, *state, **kwargs)``."""

    update: Callable = None

    def __init__(self, lr, weight_decay, **hyper):
        super().__init__(lr, weight_decay)
        self.hyper = dict(hyper, weight_decay=self.weight_decay)

    def _leaf_kwargs(self, lr: float) -> Dict[str, Any]:
        return dict(self.hyper, step=self.count, lr=lr)

    @torch.no_grad()
    def step(self, params, grads):
        multi_tensor_apply(type(self).update, params, grads, self.state,
                           **self._leaf_kwargs(self.current_lr()))
        self.count += 1


class FusedAdam(_Fused):
    """K5 (``adam_w_mode`` True: AdamW; False: L2 decay added to g)."""

    state_names = _ADAM_MOMENTS
    update = staticmethod(fused_adam_update)

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True):
        super().__init__(lr, weight_decay, beta1=float(b1), beta2=float(b2),
                         eps=float(eps), adam_w_mode=bool(adam_w_mode))


class FusedLamb(_Fused):
    """K13 plus the trust ratio clipped to [0.01, 10]."""

    state_names = _ADAM_MOMENTS
    update = staticmethod(fused_lamb_update)

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        super().__init__(lr, weight_decay, beta1=float(b1), beta2=float(b2),
                         eps=float(eps))


class FusedLion(_Fused):
    """K14."""

    state_names = ("exp_avg",)
    update = staticmethod(fused_lion_update)

    def __init__(self, lr, b1=0.9, b2=0.99, weight_decay=0.0):
        super().__init__(lr, weight_decay, beta1=float(b1), beta2=float(b2))

    def _leaf_kwargs(self, lr):
        return dict(self.hyper, lr=lr)


class FusedAdagrad(_Fused):
    """K15 (accumulator from 0, ``√a + eps``, L2 decay folded into g)."""

    state_names = ("sum_of_squares",)
    update = staticmethod(fused_adagrad_update)

    def __init__(self, lr, eps=1e-10, weight_decay=0.0):
        super().__init__(lr, weight_decay, eps=float(eps))

    def _leaf_kwargs(self, lr):
        return dict(self.hyper, lr=lr)


def build_optimizer(opt_type: str, params: Dict[str, Any],
                    learning_rate: Callable[[int], float]) -> _Optimizer:
    """The optimizer for a DeepSpeed config name, with the JAX factory's
    defaults; ``learning_rate`` is the schedule (``count -> lr``)."""
    name = opt_type.lower()
    lr = learning_rate
    b1, b2 = tuple(params.get("betas", (0.9, 0.999)))
    eps = params.get("eps", 1e-8)
    wd = params.get("weight_decay", 0.0)
    if name in _NOT_OFFERED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (ROADMAP "
            f"{_NOT_OFFERED[name]})")
    # Lion's default b2 is 0.99: only betas the config spells out override it
    lion_b1, lion_b2 = tuple(params.get("betas", (0.9, 0.99)))
    constructors = {
        "adam": lambda: AdamW(lr, b1, b2, eps, wd, decoupled=bool(
            params.get("adam_w_mode", True))),
        "adamw": lambda: AdamW(lr, b1, b2, eps, wd, decoupled=True),
        "sgd": lambda: SGD(lr, momentum=params.get("momentum", 0.0),
                           nesterov=params.get("nesterov", False),
                           weight_decay=wd),
        "lamb": lambda: Lamb(lr, b1, b2, eps, wd),
        "lion": lambda: Lion(lr, lion_b1, lion_b2, wd),
        "adagrad": lambda: Adagrad(lr, eps),
        "fusedadam": lambda: FusedAdam(
            lr, b1, b2, eps, wd, adam_w_mode=params.get("adam_w_mode", True)),
        "fusedlamb": lambda: FusedLamb(lr, b1, b2, eps, wd),
        "fusedlion": lambda: FusedLion(lr, lion_b1, lion_b2, wd),
        "fusedadagrad": lambda: FusedAdagrad(
            lr, params.get("eps", 1e-10), wd),
    }
    if name not in constructors:
        raise ValueError(f"unknown optimizer {opt_type!r}; supported: "
                         f"{sorted(constructors)}")
    return constructors[name]()
