"""Pruning criteria as functions ``(params, masks, ...) -> masks`` (port of
``turboprune_tpu/pruning/criteria.py``).

``params`` is a model ``state_dict``; masks are the flax-path-keyed bool
dicts of ``ops/masking.py``. Magnitude pruning is ported; the random,
ER, SNIP, SynFlow and N:M criteria come with a later slice.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ops.masking import Masks, global_threshold_mask, state_key


def prune_mag(params: Mapping[str, torch.Tensor], masks: Masks, density: float) -> Masks:
    """Global magnitude: score |w * m| (0 at already-pruned weights, so the
    ladder is monotone), keep the top ``density`` of all prunable weights."""
    scores = {
        path: (params[state_key(path)] * m.to(params[state_key(path)].dtype)).abs()
        for path, m in masks.items()
    }
    return global_threshold_mask(scores, masks, density)
