"""Training state (port of ``turboprune_tpu/train/state.py``).

The JAX package keeps one immutable pytree per step. Here the raw fp32
params live in the model (an ``nn.Module``, updated in place by the
optimizer); the masks sit beside them as a dict keyed by flax path name, so
pruning stays plain dict math between levels and the train step multiplies
them into the weights inside the forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.masking import Masks, make_masks
from .optim import OptimizerFactory


@dataclass
class TrainState:
    model: nn.Module                     # raw (unmasked) fp32 params
    masks: Masks                         # bool per prunable kernel
    optimizer: torch.optim.Optimizer
    step: int = 0                        # optimizer steps this level

    def model_tree(self) -> dict:
        """The checkpoint tree of the model roles: params, masks and the
        (empty, for a ViT) batch statistics."""
        return {"params": self.model.state_dict(), "masks": self.masks, "batch_stats": {}}


def create_train_state(
    model: nn.Module,
    make_optimizer: OptimizerFactory,
    masks: Optional[Masks] = None,
) -> TrainState:
    """Fresh state around ``model``'s current weights: all-ones masks unless
    given, a fresh optimizer, step 0."""
    if masks is None:
        masks = make_masks(model)
    device = next(model.parameters()).device
    masks = {p: m.to(device) for p, m in masks.items()}
    return TrainState(model, masks, make_optimizer(model.parameters()))


def reset_optimizer(state: TrainState, make_optimizer: OptimizerFactory) -> TrainState:
    """Fresh optimizer and step counter for a new level, keeping params and
    masks (the reference rebuilds the optimizer each level)."""
    return TrainState(state.model, state.masks, make_optimizer(state.model.parameters()))
