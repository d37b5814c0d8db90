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

``"Muon"`` is ``optax.contrib.muon(lr)`` as the JAX factory builds it
(:class:`Muon`). A client ``torch.optim.Optimizer`` runs through
:class:`ClientOptimizer`. The 1-bit optimizers raise
``NotImplementedError`` naming ROADMAP M8.

Each optimizer updates one leaf at a time through :meth:`update_leaf`
with the step's arguments from :meth:`step_hyper`, so that the streamed
update of an offloaded state (``runtime/swap_tensor/streamed_update.py``)
runs the same arithmetic on the same values wherever its operands live;
:meth:`elementwise` says whether a leaf's update may run on a slice of it
(no reduction over the leaf).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Set, Tuple

import torch

from ..ops.adam.fused_adam import (bias_correction, fused_adagrad_update,
                                   fused_adam_update, fused_lion_update,
                                   multi_tensor_apply)
from ..ops.lamb.fused_lamb import fused_lamb_update

_NOT_OFFERED = {
    "onebitadam": "Queue 1 M8",
    "onebitlamb": "Queue 1 M8",
    "zerooneadam": "Queue 1 M8",
}

_ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


def check_state_shape(name: str, sname: str, value: torch.Tensor,
                      shape) -> None:
    """Raise unless a checkpoint's state leaf has its parameter's shape
    (a JAX Twin-Flow tag's export holds half-leaves: ROADMAP's
    divergences of the reference)."""
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"checkpoint state {sname!r} of {name!r} has shape "
                         f"{tuple(value.shape)}, the parameter "
                         f"{tuple(shape)}")


class _Optimizer:
    """Per-parameter state, an update count, and an lr schedule."""

    #: names of one parameter's state tensors, in ``state[name]`` order:
    #: the leaf names of the universal checkpoint layout
    state_names: Tuple[str, ...] = ()
    #: the value every state tensor starts from
    initial_state_value = 0.0

    def __init__(self, lr: Callable[[int], float], weight_decay: float):
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.state: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}

    def plan(self, params: Dict[str, torch.Tensor]) -> None:
        """Record the parameters' shapes (what the per-leaf rules read)
        without allocating any state."""
        self.shapes = {name: tuple(p.shape) for name, p in params.items()}

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        self.plan(params)
        self.state = {name: self._init_one(name, p)
                      for name, p in params.items()}

    def _init_one(self, name: str, p: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.full_like(p, self.initial_state_value)
                     for _ in self.leaf_state_names(name))

    def leaf_state_names(self, name: str) -> Tuple[str, ...]:
        """Parameter ``name``'s state names (after :meth:`plan`)."""
        return self.state_names

    def elementwise(self, name: str) -> bool:
        """Whether parameter ``name``'s update is elementwise, so that it
        may run on any slice of the leaf (no norm over the leaf)."""
        return True

    def named_state(self, name: str) -> Dict[str, torch.Tensor]:
        """Parameter ``name``'s state tensors by their layout names."""
        return dict(zip(self.leaf_state_names(name), self.state[name]))

    def load_named_state(self, name: str, rec: Dict[str, Any]) -> Set[str]:
        """Copy a checkpoint record's state leaves into parameter
        ``name``'s state. → the state names the record lacks."""
        absent = set()
        for sname, buf in self.named_state(name).items():
            if sname in rec:
                check_state_shape(name, sname, rec[sname], buf.shape)
                buf.copy_(rec[sname])
            else:
                absent.add(sname)
        return absent

    def current_lr(self) -> float:
        return float(self.lr(self.count))

    def step_hyper(self) -> Any:
        """The arguments every :meth:`update_leaf` of this step takes."""
        return self.current_lr()

    def update_leaf(self, p: torch.Tensor, g: torch.Tensor,
                    state: Tuple[torch.Tensor, ...], hyper: Any) -> None:
        """Update ``p`` (a leaf, or a slice of one where
        :meth:`elementwise`) and its state in place."""
        self._update_one(p, g, state, hyper)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """One update, in place, with ``lr = schedule(count)``."""
        hyper = self.step_hyper()
        for name, p in params.items():
            self.update_leaf(p, grads[name], self.state[name], hyper)
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

    def elementwise(self, name):
        return False

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
    initial_state_value = 0.1

    def __init__(self, lr, eps=1e-8):
        super().__init__(lr, 0.0)
        self.eps = float(eps)

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

    def step_hyper(self):
        return self._leaf_kwargs(self.current_lr())

    def update_leaf(self, p, g, state, hyper):
        type(self).update(p, g, *state, **hyper)

    @torch.no_grad()
    def step(self, params, grads):
        multi_tensor_apply(type(self).update, params, grads, self.state,
                           **self.step_hyper())
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

    def elementwise(self, name):
        return False

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

# --------------------------------------------------------------------- #
# Muon (optax.contrib.muon)
# --------------------------------------------------------------------- #
NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5


def _f32(x: float) -> float:
    """``x`` rounded to float32 (optax holds its coefficients there)."""
    return float(torch.tensor(x, dtype=torch.float32))


def orthogonalize_via_newton_schulz(x: torch.Tensor,
                                    coeffs=NS_COEFFS, steps: int = NS_STEPS,
                                    eps: float = 1e-8) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` of one float32 matrix:
    a tall matrix is transposed first; ``x / (‖x‖_F + eps)``, then
    ``steps`` quintic iterations ``c0·x + (c1·A + (c2·A) @ A) @ x`` with
    ``A = x @ xᵀ``, in optax's order, through ``torch.matmul`` (cuBLAS on
    the card: the JAX package computes these in XLA dots). → a new
    tensor of ``x``'s shape."""
    c0, c1, c2 = (_f32(c) for c in coeffs)
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


def _corrected(t: torch.Tensor, beta: float, count: int) -> torch.Tensor:
    """optax ``bias_correction``: ``t / (1 - beta**count)``, the divisor
    in float32."""
    bc = 1.0 - torch.tensor(beta, dtype=torch.float32) ** count
    return t / bc.to(t.device)


class Muon(_Optimizer):
    """``optax.contrib.muon(lr)`` with optax 0.2.6's defaults, as the JAX
    factory builds it (only ``lr`` is passed): optax's label rule sends a
    leaf with ``ndim == 2`` to Muon (β 0.95, Nesterov, Newton–Schulz
    ``NS_COEFFS`` × ``NS_STEPS``, eps 1e-8, the update scaled by
    ``sqrt(max(1, cols/rows))``) and every other leaf to ``adamw(b1 0.9,
    b2 0.999, eps 1e-8, weight_decay 0, nesterov=True)``; weight decay 0
    on both. In the stacked layout the ``[L, D, F]`` kernels are 3-D and
    take the Adam branch, while the ``[L, D]`` norm scales, ``embed`` and
    ``lm_head`` are 2-D and are orthogonalised as whole matrices (the
    reference's rule; upstream Muon orthogonalises each layer's
    matrices). State names: Muon's momentum is ``exp_avg``; the Adam
    branch keeps ``exp_avg`` and ``exp_avg_sq``, the names the universal
    layout gives optax's ``mu``/``nu``."""

    def __init__(self, lr, beta=0.95, eps=1e-8, b1=0.9, b2=0.999,
                 coeffs=NS_COEFFS, steps=NS_STEPS):
        super().__init__(lr, 0.0)
        self.beta, self.eps = float(beta), float(eps)
        self.b1, self.b2 = float(b1), float(b2)
        self.coeffs, self.steps = tuple(coeffs), int(steps)

    def is_matrix(self, name: str) -> bool:
        return len(self.shapes[name]) == 2

    def leaf_state_names(self, name):
        return ("exp_avg",) if self.is_matrix(name) else _ADAM_MOMENTS

    def elementwise(self, name):
        return not self.is_matrix(name)

    def update_leaf(self, p, g, state, lr):
        t = self.count + 1
        if p.ndim == 2:
            (m,) = state
            b = self.beta
            m.copy_((1.0 - b) * g + b * m)
            m_hat = b * _corrected(m, b, t + 1) + \
                (1.0 - b) * _corrected(g, b, t)
            u = orthogonalize_via_newton_schulz(m_hat, self.coeffs,
                                                self.steps, self.eps)
            factor = torch.tensor(max(1.0, p.shape[1] / p.shape[0]),
                                  dtype=torch.float32)
            u = float(factor.sqrt()) * u
        else:
            m, v = state
            b1, b2 = self.b1, self.b2
            m.copy_((1.0 - b1) * g + b1 * m)
            v.copy_((1.0 - b2) * (g * g) + b2 * v)
            m_hat = b1 * _corrected(m, b1, t + 1) + \
                (1.0 - b1) * _corrected(g, b1, t)
            u = m_hat / (_corrected(v, b2, t).sqrt() + self.eps)
        p.add_(u, alpha=-lr)


# --------------------------------------------------------------------- #
# A client torch.optim optimizer
# --------------------------------------------------------------------- #
class ClientOptimizer:
    """A client's ``torch.optim.Optimizer``, built by its factory
    ``factory(masters) -> Optimizer`` over the engine's float32 masters
    (a list in parameter order): an optimizer built over the model's own
    tensors would update copies the engine never reads.

    :meth:`step` sets each master's ``.grad`` to the engine's unscaled,
    clipped and cleaned gradient and calls ``optimizer.step()``; with a
    ``schedule`` (the config's scheduler) every param group's ``lr`` is
    ``schedule(count)`` first, else the client's own lr stands. Its state
    is torch.optim's per-parameter ``state``; :meth:`named_state` gives
    its tensors by their keys (``exp_avg``/``exp_avg_sq`` for the Adam
    family, the universal layout's names; other keys as torch.optim names
    them)."""

    def __init__(self, factory: Callable[[Iterable[torch.Tensor]], Any],
                 schedule: Optional[Callable[[int], float]] = None):
        if isinstance(factory, torch.optim.Optimizer) or not callable(factory):
            raise TypeError(
                "a client optimizer is a factory f(params) -> "
                "torch.optim.Optimizer that the engine calls over its "
                "float32 masters, not an optimizer instance (one built "
                "over the model's tensors would update copies)")
        self.factory = factory
        self.schedule = schedule
        self.count = 0
        self.optimizer = None
        self.params: Dict[str, torch.Tensor] = {}

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        self.params = params
        self.optimizer = self.factory(list(params.values()))
        if not isinstance(self.optimizer, torch.optim.Optimizer):
            raise TypeError(f"the client factory returned "
                            f"{type(self.optimizer).__name__}, not a "
                            f"torch.optim.Optimizer")

    def current_lr(self) -> float:
        if self.schedule is not None:
            return float(self.schedule(self.count))
        return float(self.optimizer.param_groups[0]["lr"])

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            p.grad = grads[name]
        if self.schedule is not None:
            lr = self.current_lr()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def named_state(self, name: str) -> Dict[str, torch.Tensor]:
        state = self.optimizer.state.get(self.params[name], {})
        return {k: v for k, v in state.items()
                if isinstance(v, torch.Tensor)}

    def load_named_state(self, name: str, rec: Dict[str, Any]) -> Set[str]:
        """torch.optim's ``load_state_dict`` placement: ``step`` stays a
        float32 host tensor, every other leaf goes to the master's
        device. → nothing is absent (the record defines the state)."""
        p = self.params[name]
        state = self.optimizer.state[p]
        for key, value in rec.items():
            if key == "param":
                continue
            state[key] = value.to(torch.float32).clone() if key == "step" \
                else value.to(p.device).clone()
        return set()


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
        # optax.contrib.muon(lr): the JAX factory passes lr only
        "muon": lambda: Muon(lr),
    }
    if name not in constructors:
        raise ValueError(f"unknown optimizer {opt_type!r}; supported: "
                         f"{sorted(constructors)}")
    return constructors[name]()
