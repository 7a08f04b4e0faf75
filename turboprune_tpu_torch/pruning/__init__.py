"""Pruning: criterion dispatch and density ladders (port of
``turboprune_tpu/pruning/__init__.py``)."""

from __future__ import annotations

from typing import Mapping

import torch

from ..ops.masking import Masks
from .criteria import prune_mag
from .densities import generate_cyclical_schedule, generate_densities

NOT_YET_PORTED = {
    "random_erk": "ROADMAP.md queue A, item 9",
    "random_balanced": "ROADMAP.md queue A, item 9",
    "er_erk": "ROADMAP.md queue A, item 9",
    "er_balanced": "ROADMAP.md queue A, item 9",
    "snip": "ROADMAP.md queue A, item 9",
    "synflow": "ROADMAP.md queue A, item 9",
    "nm": "ROADMAP.md queue A, item 15",
}


def prune_the_model(
    method: str,
    params: Mapping[str, torch.Tensor],
    masks: Masks,
    density: float,
) -> Masks:
    """Dispatch a pruning criterion; returns the new masks."""
    if method == "just dont":
        return masks
    if method == "mag":
        return prune_mag(params, masks, density)
    if method in NOT_YET_PORTED:
        raise NotImplementedError(
            f"pruning method {method!r} is not yet ported to "
            f"turboprune_tpu_torch ({NOT_YET_PORTED[method]})"
        )
    raise ValueError(f"Unknown pruning method: {method}")


__all__ = [
    "prune_the_model",
    "prune_mag",
    "generate_densities",
    "generate_cyclical_schedule",
]
