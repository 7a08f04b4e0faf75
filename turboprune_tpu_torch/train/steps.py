"""Train and eval steps (port of ``turboprune_tpu/train/steps.py``).

The JAX package compiles ``(state, batch) -> (state, metrics)`` into one
program. Here a step is plain eager PyTorch, called from a Python loop:
forward with the masks multiplied into the weights inside it (so the
gradient is taken with respect to the RAW params: masked weights get zero
data-gradient but still move under weight decay and momentum, the
reference's semantics), summed cross entropy in fp32, backward, optimizer
update. Attention with ``attention_impl: flash`` runs K1 forward and K2/K3
backward on CUDA.

Metrics are SUMS (``loss_sum``, ``correct``, ``count``) kept on the device;
the harness adds them up over an epoch and reads them once at its end.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.masking import Masks, apply_masks
from .optim import set_lr
from .state import TrainState

Batch = tuple[torch.Tensor, torch.Tensor]  # (images NHWC, integer labels)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy in fp32 (the mean is taken over exact counts)."""
    return F.cross_entropy(logits.float(), labels, reduction="sum")


def masked_forward(model: nn.Module, masks: Masks, images: torch.Tensor) -> torch.Tensor:
    """Logits of ``model`` with ``w * m`` in place of every masked weight;
    differentiable in the raw params."""
    return functional_call(model, apply_masks(dict(model.named_parameters()), masks), (images,))


def make_train_step(
    schedule: Callable[[int], float],
) -> Callable[[TrainState, Batch], dict]:
    """The train step: updates ``state`` in place (params, optimizer, step)
    and returns the metric sums. ``schedule`` sets the lr from the step."""

    def train_step(state: TrainState, batch: Batch) -> dict:
        images, labels = batch
        set_lr(state.optimizer, schedule(state.step))
        state.model.train()
        logits = masked_forward(state.model, state.masks, images)
        loss_sum = cross_entropy_sum(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        (loss_sum / labels.shape[0]).backward()
        state.optimizer.step()
        state.step += 1
        correct = (logits.detach().argmax(dim=-1) == labels).sum().float()
        count = torch.tensor(float(labels.shape[0]), device=labels.device)
        return {"loss_sum": loss_sum.detach(), "correct": correct, "count": count}

    return train_step


@torch.no_grad()
def eval_step(model: nn.Module, masks: Masks, batch: Batch) -> dict:
    """Metric sums over one eval batch. Rows with label < 0 are padding
    (the loaders pad the last batch with label -1) and count nowhere."""
    images, labels = batch
    model.eval()
    logits = masked_forward(model, masks, images)
    valid = labels >= 0
    safe = labels.clamp_min(0)
    per_row = F.cross_entropy(logits.float(), safe, reduction="none")
    hit = logits.argmax(dim=-1) == safe
    return {
        "loss_sum": torch.where(valid, per_row, 0.0).sum(),
        "correct": (valid & hit).sum().float(),
        "count": valid.sum().float(),
    }


def add_sums(total: Optional[dict], sums: dict) -> dict:
    return dict(sums) if total is None else {k: total[k] + sums[k] for k in total}
