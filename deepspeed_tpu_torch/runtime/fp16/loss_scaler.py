"""Loss scaling for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``): the same static and
dynamic scalers and the same state machine (halve after ``hysteresis``
overflows, double after ``scale_window`` clean steps). The state is three
host numbers; the engine reads one overflow flag per step to drive it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class LossScalerState:
    scale: float
    good_steps: int
    hysteresis: int


class LossScaler:
    """Static (or disabled) loss scaling."""

    dynamic = False

    def __init__(self, scale: float = 1.0):
        self.initial_scale = float(scale)

    def init(self) -> LossScalerState:
        return LossScalerState(scale=self.initial_scale, good_steps=0,
                               hysteresis=1)

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScalerState) -> torch.Tensor:
        return loss * state.scale

    def unscale_grads(self, grads: Dict[str, torch.Tensor],
                      state: LossScalerState) -> None:
        """In place: ``g *= 1/scale`` (skipped at scale 1, an identity)."""
        inv = 1.0 / state.scale
        if inv != 1.0:
            for g in grads.values():
                g.mul_(inv)

    @staticmethod
    def check_overflow(grads: Dict[str, torch.Tensor]) -> bool:
        """True when any gradient holds an inf or NaN (one host sync)."""
        if not grads:
            return False
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()])
        return not bool(finite.all())

    def update(self, state: LossScalerState,
               overflow: bool) -> LossScalerState:
        return state  # a static scale never changes


class DynamicLossScaler(LossScaler):
    """Scale x2 after a clean window, x0.5 on overflow once hysteresis is
    exhausted (the JAX ``DynamicLossScaler``)."""

    dynamic = True

    def __init__(self, init_scale: float = 2 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 delayed_shift: int = 1, consecutive_hysteresis: bool = False):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init(self) -> LossScalerState:
        return LossScalerState(scale=self.initial_scale, good_steps=0,
                               hysteresis=self.delayed_shift)

    def update(self, state: LossScalerState,
               overflow: bool) -> LossScalerState:
        if overflow:
            hyst = state.hysteresis - 1
            scale = max(state.scale / self.scale_factor, self.min_scale) \
                if hyst <= 0 else state.scale
            return LossScalerState(scale=scale, good_steps=0,
                                   hysteresis=max(hyst, 0))
        good = state.good_steps + 1
        grow = good >= self.scale_window
        hyst = self.delayed_shift if self.consecutive_hysteresis \
            else state.hysteresis
        return LossScalerState(
            scale=state.scale * self.scale_factor if grow else state.scale,
            good_steps=0 if grow else good, hysteresis=hyst)


def create_loss_scaler(fp16_config=None, dtype=None) -> LossScaler:
    """From an ``FP16Config``; bf16 (or fp16 off) → a static scale of 1."""
    if fp16_config is None or not getattr(fp16_config, "enabled", False) \
            or dtype == torch.bfloat16:
        return LossScaler(1.0)
    if fp16_config.loss_scale and fp16_config.loss_scale > 0:
        return LossScaler(fp16_config.loss_scale)
    return DynamicLossScaler(
        init_scale=2.0 ** fp16_config.initial_scale_power,
        scale_window=fp16_config.loss_scale_window,
        min_scale=fp16_config.min_loss_scale,
        delayed_shift=fp16_config.hysteresis,
        consecutive_hysteresis=fp16_config.consecutive_hysteresis,
    )
