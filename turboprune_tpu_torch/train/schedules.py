"""Learning-rate schedules as pure ``step -> lr`` functions (port of
``turboprune_tpu/train/schedules.py``).

Each schedule maps the optimizer's step count (0-based, restarting at every
level) to a Python float; the harness sets it as the optimizer's lr before
each step. Same formulas as the JAX package, which evaluates them in
float32: values agree to float32 rounding.

  TriangularSchedule     piecewise-linear 0.2 -> 1 -> 0 peak at the warmup
                         boundary
  TrapezoidalSchedule    linear warmup, flat, linear cooldown
  ImageNetLRDropsWarmup  linear warmup over 10 epochs then x0.1 drops at
                         epochs 40 and 70
  MultiStepLRWarmup      linear warmup over warmup_fraction then x0.1 drops
                         at epochs 60 and 120
  OneCycleLR             optax's cosine one-cycle, written out
  ScheduleFree           constant lr
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def _interp(x: float, xp: Sequence[float], fp: Sequence[float]) -> float:
    """``np.interp`` for increasing ``xp``: clamps outside the knots."""
    if x <= xp[0]:
        return fp[0]
    for i in range(1, len(xp)):
        if x <= xp[i]:
            t = (x - xp[i - 1]) / (xp[i] - xp[i - 1])
            return fp[i - 1] + t * (fp[i] - fp[i - 1])
    return fp[-1]


def triangular_schedule(
    base_lr: float, total_steps: int, warmup_fraction: float = 0.2
) -> Schedule:
    """lr(step) = base_lr * interp(step; [0, warmup, total] -> [0.2, 1, 0])."""
    warmup_steps = max(int(total_steps * warmup_fraction), 1)
    knots = (0.0, float(warmup_steps), float(total_steps))

    def schedule(step: int) -> float:
        return base_lr * _interp(float(step), knots, (0.2, 1.0, 0.0))

    return schedule


def trapezoidal_schedule(
    base_lr: float, total_steps: int, warmup_steps: int, cooldown_steps: int
) -> Schedule:
    """Linear warmup to base_lr, flat plateau, linear cooldown to 0."""

    def schedule(step: int) -> float:
        warm = (step + 1.0) / float(max(warmup_steps, 1))
        cool = (float(total_steps) - step) / float(max(cooldown_steps, 1))
        return base_lr * min(max(min(warm, cool), 0.0), 1.0)

    return schedule


def multistep_warmup_schedule(
    base_lr: float,
    steps_per_epoch: int,
    warmup_epochs: int,
    milestones_epochs: Sequence[int],
    gamma: float = 0.1,
) -> Schedule:
    """Linear warmup for ``warmup_epochs`` then multiplicative ``gamma``
    drops at each milestone epoch."""
    warmup_steps = max(warmup_epochs * steps_per_epoch, 1)
    boundaries = [float(m * steps_per_epoch) for m in milestones_epochs]

    def schedule(step: int) -> float:
        warm = min(max((step + 1.0) / warmup_steps, 0.0), 1.0)
        drops = gamma ** sum(step >= b for b in boundaries)
        return base_lr * warm * drops

    return schedule


def imagenet_lr_drops_warmup(base_lr: float, steps_per_epoch: int) -> Schedule:
    """10-epoch linear warmup, x0.1 drops at epochs 40 and 70."""
    return multistep_warmup_schedule(
        base_lr, steps_per_epoch, warmup_epochs=10, milestones_epochs=(40, 70)
    )


def onecycle_schedule(base_lr: float, total_steps: int) -> Schedule:
    """optax's ``cosine_onecycle_schedule`` with torch OneCycleLR's
    defaults (pct_start 0.3, div_factor 25, final_div_factor 1e4): cosine
    from base_lr/25 up to base_lr over the first 30% of the steps, then down
    to base_lr/(25 * 1e4), held after the last step."""
    div, final_div = 25.0, 1e4
    bounds = (0, int(0.3 * total_steps), int(total_steps))
    values = (base_lr / div, base_lr, base_lr / (div * final_div))

    def schedule(step: int) -> float:
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return schedule


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: base_lr


def create_schedule(
    scheduler_type: str,
    base_lr: float,
    epochs: int,
    steps_per_epoch: int,
    warmup_fraction: float = 0.2,
) -> Schedule:
    """Factory keyed by the config's ``scheduler_type``."""
    total_steps = max(epochs * steps_per_epoch, 1)
    if scheduler_type == "TriangularSchedule":
        return triangular_schedule(base_lr, total_steps, warmup_fraction)
    if scheduler_type == "TrapezoidalSchedule":
        warmup = int(total_steps * warmup_fraction)
        return trapezoidal_schedule(base_lr, total_steps, warmup, warmup)
    if scheduler_type == "ImageNetLRDropsWarmup":
        return imagenet_lr_drops_warmup(base_lr, steps_per_epoch)
    if scheduler_type == "MultiStepLRWarmup":
        return multistep_warmup_schedule(
            base_lr,
            steps_per_epoch,
            warmup_epochs=max(int(epochs * warmup_fraction), 1),
            milestones_epochs=(60, 120),
        )
    if scheduler_type == "OneCycleLR":
        return onecycle_schedule(base_lr, total_steps)
    if scheduler_type == "ScheduleFree":
        return constant_schedule(base_lr)
    raise ValueError(f"Unknown scheduler_type: {scheduler_type}")
