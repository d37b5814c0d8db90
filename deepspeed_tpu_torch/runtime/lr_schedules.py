"""LR schedules for the PyTorch port (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``): the same five schedules —
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR — as plain
``step -> lr`` functions built by :func:`get_schedule_fn`, with the JAX
package's parameter names and defaults. The optimizer reads
``schedule(count)``, ``count`` being the updates taken so far.

Note: log warm-up gives lr = warmup_min_lr at step 0 (log1p(0) = 0), so a
WarmupLR run's first update is a no-op when ``warmup_min_lr`` is 0.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

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
