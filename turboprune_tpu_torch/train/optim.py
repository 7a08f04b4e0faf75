"""Optimizer factory (port of ``turboprune_tpu/train/optim.py``).

The JAX package builds optax chains in torch order; here they are the torch
optimizers themselves:

- ``SGD``: ``torch.optim.SGD(momentum, weight_decay)`` adds the decay to
  the gradient before the momentum trace and steps by ``lr * buf``, which
  is the optax chain ``add_decayed_weights -> trace -> scale_by_learning_rate``.
- ``AdamW``: ``torch.optim.AdamW`` is ``optax.adamw`` up to rounding
  (decoupled decay ``lr * wd * p`` from the pre-update params).
- ``ScheduleFreeSGD``: ``ScheduleFreeSGD`` below, written out to match
  ``optax.contrib.schedule_free(sgd(schedule, momentum=0, weight_decay),
  learning_rate=schedule, b1=momentum)``.

Decay hits every parameter, masked weights and LayerNorm scale and bias
included, as in the reference. The lr comes from the schedule: the train
step sets it (``set_lr``) before each update.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator, Optional

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
Schedule = Callable[[int], float]

# optax's schedule_free weights the averaging by max_lr ** 2 (its default
# weight_lr_power, which the JAX package keeps).
WEIGHT_LR_POWER = 2.0


class ScheduleFreeSGD(torch.optim.Optimizer):
    """Schedule-free SGD (Defazio et al.), as optax 0.2.6's
    ``contrib.schedule_free`` over plain SGD.

    The parameters are optax's ``y``; the state holds ``z`` per parameter
    and, per group (so they ride ``state_dict``), the averaging weights'
    ``weight_sum`` and ``max_lr`` and two counts: ``step_count`` (from 1),
    at which the averaging weight reads the schedule, and ``base_count``
    (from 0), the inner SGD's own count, at which its step reads it. One
    step, with ``b1`` the momentum and ``lr = schedule(step_count)``::

        max_lr = max(max_lr, lr);  ck = max_lr^2 / (weight_sum + max_lr^2)
        z'     = z - schedule(base_count) * (g + wd * y)
        x      = (1 - ck) * (y - (1 - b1) * z) / b1 + ck * z'
        y'     = b1 * x + (1 - b1) * z'

    Evaluation reads ``(y - (1 - b1) * z) / b1`` (``eval_weights``). The
    schedule comes from the train step (``set_lr``); a fresh optimizer
    starts both counts afresh, as the JAX package's per-level
    ``tx.init`` does."""

    def __init__(self, params: Iterable[torch.nn.Parameter], momentum: float = 0.9,
                 weight_decay: float = 0.0):
        if not momentum > 0.0:
            raise ValueError("ScheduleFreeSGD needs momentum (b1) > 0")
        defaults = dict(lr=0.0, momentum=momentum, weight_decay=weight_decay,
                        step_count=1, base_count=0, weight_sum=0.0, max_lr=0.0)
        super().__init__(params, defaults)
        self.schedule: Optional[Schedule] = None
        with torch.no_grad():
            for group in self.param_groups:
                for p in group["params"]:
                    self.state[p]["z"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduleFreeSGD takes no closure")
        if self.schedule is None:
            raise RuntimeError("ScheduleFreeSGD.step before set_lr gave it the schedule")
        for group in self.param_groups:
            b1, wd = group["momentum"], group["weight_decay"]
            lr = float(self.schedule(group["step_count"]))
            base_lr = float(self.schedule(group["base_count"]))
            max_lr = max(group["max_lr"], lr)
            weight = max_lr ** WEIGHT_LR_POWER
            total = group["weight_sum"] + weight
            ck = weight / total if total > 0.0 else 0.0
            group.update(lr=base_lr, max_lr=max_lr, weight_sum=total,
                         step_count=group["step_count"] + 1,
                         base_count=group["base_count"] + 1)
            for y in group["params"]:
                z = self.state[y]["z"]
                g = torch.zeros_like(y) if y.grad is None else y.grad
                x = (y - (1.0 - b1) * z) / b1
                z.add_((g + wd * y) * -base_lr)
                x.mul_(1.0 - ck).add_(z, alpha=ck)
                y.add_((b1 * x + (1.0 - b1) * z) - y)

    def eval_params(self) -> list[torch.Tensor]:
        """The averaged weights ``(y - (1 - b1) z) / b1`` to evaluate
        with, in parameter order."""
        return [(y - (1.0 - g["momentum"]) * self.state[y]["z"]) / g["momentum"]
                for g in self.param_groups for y in g["params"]]


def create_optimizer(
    optimizer_name: str,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
) -> OptimizerFactory:
    """Factory keyed by the config's ``optimizer_name``: returns a function
    of the parameters that builds a fresh optimizer (lr 0 until the first
    ``set_lr``)."""
    if optimizer_name == "SGD":
        return lambda params: torch.optim.SGD(
            params, lr=0.0, momentum=momentum, weight_decay=weight_decay
        )
    if optimizer_name == "AdamW":
        return lambda params: torch.optim.AdamW(
            params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
    if optimizer_name == "ScheduleFreeSGD":
        return lambda params: ScheduleFreeSGD(params, momentum=momentum,
                                              weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer_name: {optimizer_name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float,
           schedule: Optional[Schedule] = None) -> None:
    """Set every group's lr; a schedule-free optimizer also takes
    ``schedule``, which it reads at its own two counts."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    if isinstance(optimizer, ScheduleFreeSGD) and schedule is not None:
        optimizer.schedule = schedule


def restart_schedule(optimizer: torch.optim.Optimizer) -> None:
    """After a restored optimizer state (weight rewinding's
    ``rewind_optimizer``): the schedule restarts at the level's step 0.
    For schedule-free SGD that is the inner SGD's count only; the
    averaging weights and their count come back with ``z``, as the JAX
    package swaps only optax's ``ScaleByScheduleState`` for a fresh one."""
    if isinstance(optimizer, ScheduleFreeSGD):
        for group in optimizer.param_groups:
            group["base_count"] = 0


@contextlib.contextmanager
def eval_weights(optimizer: torch.optim.Optimizer) -> Iterator[None]:
    """Inside the block, the parameters' storage holds the weights to
    evaluate with: schedule-free SGD's averaged weights, copied in place
    (a compiled forward reads the storage), and ``y`` copied back exactly
    at the end; any other optimizer's parameters as they are."""
    if not isinstance(optimizer, ScheduleFreeSGD):
        yield
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        for p, e in zip(params, optimizer.eval_params()):
            p.copy_(e)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, y in zip(params, saved):
                p.copy_(y)
