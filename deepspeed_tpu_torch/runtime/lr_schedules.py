"""LR schedules for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``): the same five schedules —
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR — as plain
``step -> lr`` functions built by :func:`get_schedule_fn`, with the JAX
package's parameter names and defaults, and as the reference's stateful
classes (``step``, ``get_lr``, ``get_last_lr``, ``state_dict``) built by
:func:`build_scheduler`. The optimizer reads ``schedule(count)``,
``count`` being the updates taken so far.

Note: log warm-up gives lr = warmup_min_lr at step 0 (log1p(0) = 0), so a
WarmupLR run's first update is a no-op when ``warmup_min_lr`` is 0.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _warmup_factor(step: float, warmup_num_steps: int,
                   warmup_type: str = "log") -> float:
    warmup_num_steps = max(warmup_num_steps, 1)
    s = min(float(step), warmup_num_steps)
    if warmup_type == "log":
        return math.log1p(s) / math.log(warmup_num_steps + 1)
    return s / warmup_num_steps


def get_schedule_fn(sched_type: str, params: Dict[str, Any],
                    base_lr: Optional[float] = None
                    ) -> Callable[[int], float]:
    """A ``step -> lr`` function for the given schedule config."""
    if sched_type == WARMUP_LR:
        lo = params.get("warmup_min_lr", 0.0)
        hi = params.get("warmup_max_lr", 0.001)
        n = params.get("warmup_num_steps", 1000)
        wt = params.get("warmup_type", "log")
        return lambda step: lo + (hi - lo) * _warmup_factor(step, n, wt)

    if sched_type == WARMUP_DECAY_LR:
        lo = params.get("warmup_min_lr", 0.0)
        hi = params.get("warmup_max_lr", 0.001)
        n = params.get("warmup_num_steps", 1000)
        total = params["total_num_steps"]
        wt = params.get("warmup_type", "log")

        def warmup_decay(step):
            step = float(step)
            if step < n:
                return lo + (hi - lo) * _warmup_factor(step, n, wt)
            return hi * _clip((total - step) / max(total - n, 1), 0.0, 1.0)

        return warmup_decay

    if sched_type == WARMUP_COSINE_LR:
        n = params.get("warmup_num_steps", 1000)
        total = params["total_num_steps"]
        ratio = params.get("cos_min_ratio", 0.0001)
        wmin_ratio = params.get("warmup_min_ratio", 0.0)
        peak = base_lr if base_lr is not None else params.get(
            "warmup_max_lr", 0.001)
        wt = params.get("warmup_type", "log")

        def warmup_cosine(step):
            step = float(step)
            if step < n:
                return peak * (wmin_ratio + (1 - wmin_ratio)
                               * _warmup_factor(step, n, wt))
            progress = _clip((step - n) / max(total - n, 1), 0.0, 1.0)
            return peak * (ratio + (1 - ratio) * 0.5
                           * (1 + math.cos(math.pi * progress)))

        return warmup_cosine

    if sched_type == LR_RANGE_TEST:
        lo = params.get("lr_range_test_min_lr", 1e-3)
        step_size = params.get("lr_range_test_step_size", 2000)
        step_rate = params.get("lr_range_test_step_rate", 1.0)
        staircase = params.get("lr_range_test_staircase", False)

        def lr_range_test(step):
            interval = step / step_size
            if staircase:
                interval = math.floor(interval)
            return lo * (1 + step_rate * interval)

        return lr_range_test

    if sched_type == ONE_CYCLE:
        first = params.get("cycle_first_step_size", 2000)
        second = params.get("cycle_second_step_size", first)
        lr_lo = params.get("cycle_min_lr", 1e-5)
        lr_hi = params.get("cycle_max_lr", 1e-3)
        decay_rate = params.get("decay_lr_rate", 0.0)
        decay_start = first + second

        def one_cycle(step):
            step = float(step)
            if step < first:
                return lr_lo + (lr_hi - lr_lo) * _clip(step / first, 0, 1)
            if step < decay_start:
                return lr_hi - (lr_hi - lr_lo) * _clip(
                    (step - first) / second, 0, 1)
            if decay_rate:
                return lr_lo / (1 + decay_rate * max(step - decay_start, 0.0))
            return lr_lo

        return one_cycle

    raise ValueError(f"unknown scheduler type {sched_type!r}; valid: "
                     f"{VALID_LR_SCHEDULES}")


class _ScheduleBase:
    """Stateful wrapper with the reference scheduler API."""

    def __init__(self, fn: Callable[[int], float],
                 last_batch_iteration: int = -1):
        self._fn = fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self._fn(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict[str, int]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_ScheduleBase):
    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        super().__init__(get_schedule_fn(WARMUP_LR, dict(
            warmup_min_lr=warmup_min_lr, warmup_max_lr=warmup_max_lr,
            warmup_num_steps=warmup_num_steps, warmup_type=warmup_type)),
            last_batch_iteration)


class WarmupDecayLR(_ScheduleBase):
    def __init__(self, optimizer=None, total_num_steps=10000,
                 warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        super().__init__(get_schedule_fn(WARMUP_DECAY_LR, dict(
            total_num_steps=total_num_steps, warmup_min_lr=warmup_min_lr,
            warmup_max_lr=warmup_max_lr, warmup_num_steps=warmup_num_steps,
            warmup_type=warmup_type)), last_batch_iteration)


class WarmupCosineLR(_ScheduleBase):
    def __init__(self, optimizer=None, total_num_steps=10000,
                 warmup_min_ratio=0.0, warmup_num_steps=1000,
                 cos_min_ratio=0.0001, warmup_type="log", peak_lr=0.001,
                 last_batch_iteration=-1):
        super().__init__(get_schedule_fn(WARMUP_COSINE_LR, dict(
            total_num_steps=total_num_steps,
            warmup_min_ratio=warmup_min_ratio,
            warmup_num_steps=warmup_num_steps, cos_min_ratio=cos_min_ratio,
            warmup_type=warmup_type), base_lr=peak_lr), last_batch_iteration)


class LRRangeTest(_ScheduleBase):
    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(get_schedule_fn(LR_RANGE_TEST, dict(
            lr_range_test_min_lr=lr_range_test_min_lr,
            lr_range_test_step_size=lr_range_test_step_size,
            lr_range_test_step_rate=lr_range_test_step_rate,
            lr_range_test_staircase=lr_range_test_staircase)),
            last_batch_iteration)


class OneCycle(_ScheduleBase):
    def __init__(self, optimizer=None, cycle_min_lr=1e-5, cycle_max_lr=1e-3,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 decay_lr_rate=0.0, last_batch_iteration=-1, **kwargs):
        super().__init__(get_schedule_fn(ONE_CYCLE, dict(
            cycle_min_lr=cycle_min_lr, cycle_max_lr=cycle_max_lr,
            cycle_first_step_size=cycle_first_step_size,
            cycle_second_step_size=(cycle_second_step_size
                                     or cycle_first_step_size),
            decay_lr_rate=decay_lr_rate)), last_batch_iteration)


_SCHED_CLASSES = {
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
}


def build_scheduler(sched_type: str, params: Dict[str, Any], optimizer=None):
    """The stateful scheduler class of ``sched_type`` over ``params``."""
    if sched_type not in _SCHED_CLASSES:
        raise ValueError(f"unknown scheduler {sched_type!r}")
    return _SCHED_CLASSES[sched_type](optimizer=optimizer, **params)
