"""Dropout from the caller's noise (flax ``nn.Dropout`` semantics).

A model with dropout draws nothing itself. ``dropout_shapes(n)`` on the
model lists the uniforms a train forward of ``n`` images takes, in the
order the forward uses them; the caller draws them from an explicit
generator (``draw_dropout_noise``; the train step reseeds it from (seed,
step), the counterpart of the JAX package's ``fold_in(rng, step)``) and
hands them to the forward as a list of tensors. One route serves the eager
step and the compiled one, whose graph takes the noise as an input (dynamo
cannot take a ``torch.Generator``). A value is kept where its uniform is
below ``1 - rate`` and then scaled by ``1 / (1 - rate)``; the masks differ
from JAX's threefry bits, the rate and the scale do not.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` with flax's dropout at ``rate`` under the uniforms ``noise``
    (None, or a rate of 0: the identity, as a deterministic flax layer)."""
    if noise is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(noise < keep, x / keep, torch.zeros_like(x))


def forward_noise(model: nn.Module, noise: Optional[list]) -> Optional[list]:
    """The noise ``model``'s forward uses: none in eval mode; in training
    the caller's, which a model with a dropout rate requires."""
    if not model.training:
        return None
    if model.dropout_rate > 0 and noise is None:
        raise ValueError(
            f"{type(model).__name__} in training with dropout needs the caller's "
            "noise (models/dropout.py); it draws from no global generator")
    return noise


def dropout_shapes(model: nn.Module, n: int) -> list[tuple[int, ...]]:
    """The shapes of the uniforms ``model``'s train forward of ``n`` images
    takes; empty for a model without dropout."""
    shapes = getattr(model, "dropout_shapes", None)
    return shapes(n) if shapes is not None else []


def draw_dropout_noise(
    model: nn.Module, n: int, generator: torch.Generator
) -> Optional[list[torch.Tensor]]:
    """Uniforms in [0, 1) for a train forward of ``n`` images, from
    ``generator`` on its device; None when the model has no dropout."""
    shapes = dropout_shapes(model, n)
    if not shapes:
        return None
    return [torch.rand(s, generator=generator, device=generator.device) for s in shapes]
