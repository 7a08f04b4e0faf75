"""Optimizer factory (port of ``turboprune_tpu/train/optim.py``).

The JAX package builds optax chains in torch order; here they are the torch
optimizers themselves:

- ``SGD``: ``torch.optim.SGD(momentum, weight_decay)`` adds the decay to
  the gradient before the momentum trace and steps by ``lr * buf``, which
  is the optax chain ``add_decayed_weights -> trace -> scale_by_learning_rate``.
- ``AdamW``: ``torch.optim.AdamW`` is ``optax.adamw`` up to rounding
  (decoupled decay ``lr * wd * p`` from the pre-update params).

Decay hits every parameter, masked weights and LayerNorm scale and bias
included, as in the reference. The lr comes from the schedule: the train
step sets it (``set_lr``) before each update.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


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
        raise NotImplementedError(
            "optimizer_name=ScheduleFreeSGD is not yet ported to "
            "turboprune_tpu_torch (ROADMAP.md queue A, item 2: schedule-free "
            "SGD by hand, with its eval_params)"
        )
    raise ValueError(f"Unknown optimizer_name: {optimizer_name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
