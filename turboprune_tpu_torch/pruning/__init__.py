"""Pruning: criterion dispatch and density ladders (port of
``turboprune_tpu/pruning/__init__.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masking import Masks
from .criteria import (
    prune_er_balanced,
    prune_er_erk,
    prune_mag,
    prune_random_balanced,
    prune_random_erk,
    prune_snip,
    prune_synflow,
)
from .densities import (
    balanced_densities,
    erk_densities,
    generate_cyclical_schedule,
    generate_densities,
)

DATA_DRIVEN_METHODS = ("snip", "synflow")
RANDOM_METHODS = {
    "random_erk": prune_random_erk,
    "random_balanced": prune_random_balanced,
    "er_erk": prune_er_erk,
    "er_balanced": prune_er_balanced,
}
NOT_YET_PORTED = {"nm": "ROADMAP.md queue A, item 15"}


def prune_the_model(
    method: str,
    model: nn.Module,
    masks: Masks,
    density: float,
    generator: Optional[torch.Generator] = None,
    batch: Optional[tuple] = None,
) -> Masks:
    """Dispatch a pruning criterion on ``model``'s current weights; returns
    the new masks. The random criteria draw from ``generator``, and so
    does the dropout of snip's and synflow's forward; ``batch`` (images,
    labels) is required for snip (real data) and synflow (the shape and
    dtype of its all-ones input)."""
    if method == "just dont":
        return masks
    if method == "mag":
        return prune_mag(model.state_dict(), masks, density)
    if method in RANDOM_METHODS:
        if generator is None:
            raise ValueError(f"{method} pruning requires a generator")
        return RANDOM_METHODS[method](masks, density, generator)
    if method in DATA_DRIVEN_METHODS:
        if batch is None:
            raise ValueError(f"{method} pruning requires a data batch")
        if method == "snip":
            return prune_snip(model, masks, density, batch, generator)
        return prune_synflow(model, masks, density, batch[0], generator)
    if method in NOT_YET_PORTED:
        raise NotImplementedError(
            f"pruning method {method!r} is not yet ported to "
            f"turboprune_tpu_torch ({NOT_YET_PORTED[method]})"
        )
    raise ValueError(f"Unknown pruning method: {method}")


__all__ = [
    "DATA_DRIVEN_METHODS",
    "balanced_densities",
    "erk_densities",
    "generate_cyclical_schedule",
    "generate_densities",
    "prune_er_balanced",
    "prune_er_erk",
    "prune_mag",
    "prune_random_balanced",
    "prune_random_erk",
    "prune_snip",
    "prune_synflow",
    "prune_the_model",
]
