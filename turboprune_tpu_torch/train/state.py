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
        """The checkpoint tree of the model roles, as the JAX package's:
        the parameters under ``params``, the masks, and the buffers (the
        BatchNorm running statistics; none for a ViT) under
        ``batch_stats``, each keyed by its ``state_dict`` name."""
        params = {k: v.detach() for k, v in self.model.named_parameters()}
        return {
            "params": params,
            "masks": self.masks,
            # The state_dict's buffers: not the N:M index maps, which are
            # buffers outside it.
            "batch_stats": {k: v.detach() for k, v in self.model.state_dict(keep_vars=True).items()
                            if k not in params},
        }


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
