"""Mask dicts — the sparsity mechanism (port of
``turboprune_tpu/ops/masking.py``).

The JAX package keeps masks as a pytree mirroring the params, with a bool
array at every prunable leaf (conv / dense kernels) and ``None`` elsewhere.
Here masks are a flat dict keyed by the flax path name of the kernel they
mask (``block0/attn/query/kernel``, as ``path_name`` in the JAX module
spells it), each value a bool tensor in the torch layout of that weight
(``bridge.py`` maps the layouts). Non-prunable params have no entry.

A dict's order is torch's module order (``conv1``, ``bn1``, ``layer1_0``,
…, ``fc``); the JAX package walks its mask tree in flatten order, keys
sorted at every level (``conv1``, ``fc``, ``layer1_0``, …). Whatever
depends on the order of the layers (the balanced allocation, one random
stream drawn layer after layer) walks ``flax_order``.

``apply_masks`` multiplies the masks into a ``state_dict``; the serving
engine folds them once at load, so pruned weights are literal zeros.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch
from torch import nn

Masks = dict[str, torch.Tensor]


def path_name(module_name: str) -> str:
    """Mask key of a prunable module: its flax path plus ``/kernel``."""
    return module_name.replace(".", "/") + "/kernel"


def state_key(path: str) -> str:
    """The ``state_dict`` key of the weight a mask key names."""
    if not path.endswith("/kernel"):
        raise KeyError(f"{path!r} is not a kernel path")
    return path[: -len("/kernel")].replace("/", ".") + ".weight"


def prunable_modules(model: nn.Module) -> Iterator[tuple[str, nn.Module]]:
    """Conv and dense layers: the modules whose weight is a flax ``kernel``
    (the reference masks every Conv2d and Linear, the heads included)."""
    for name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            yield name, module


def make_masks(model: nn.Module) -> Masks:
    """Dense (all-ones) masks for every prunable weight of ``model``."""
    return {
        path_name(name): torch.ones_like(module.weight, dtype=torch.bool)
        for name, module in prunable_modules(model)
    }


def apply_masks(
    state_dict: Mapping[str, torch.Tensor], masks: Masks
) -> dict[str, torch.Tensor]:
    """``w * m`` at masked weights; every other entry passes through."""
    out = dict(state_dict)
    for path, m in masks.items():
        key = state_key(path)
        w = out[key]
        out[key] = w * m.to(device=w.device, dtype=w.dtype)
    return out


def flax_order(masks: Masks) -> list[tuple[str, torch.Tensor]]:
    """(path, mask) in the JAX mask tree's flatten order: dict keys sorted
    at every level of the path."""
    return sorted(masks.items(), key=lambda item: tuple(item[0].split("/")))


def num_prunable(masks: Masks) -> int:
    return sum(int(m.numel()) for m in masks.values())


def overall_sparsity(masks: Masks) -> float:
    """Percent of prunable weights masked out (the reference's
    ``get_overall_sparsity`` returns percent too)."""
    total = 0
    zeros = 0
    for m in masks.values():
        total += int(m.numel())
        zeros += int(m.numel() - int(m.sum()))
    return (zeros / total) * 100.0 if total else 0.0


def overall_density(masks: Masks) -> float:
    return 1.0 - overall_sparsity(masks) / 100.0


def global_threshold_mask(scores: Masks, masks: Masks, density: float) -> Masks:
    """Global magnitude-style masking: keep weights whose score exceeds the
    k-th smallest score, k = (1 - density) * N over ALL prunable weights.

    Scores at already-pruned positions must be 0 (callers multiply by the
    mask) so pruning is monotone across levels. When k < 1 the masks are
    returned untouched, as in the reference. ``torch.kthvalue`` compares
    the fp32 values exactly, so the masks are bit-identical to the JAX
    package's ``lax.top_k`` selection on the same scores."""
    flat = torch.cat([s.reshape(-1) for s in scores.values()]).float()
    n = flat.shape[0]
    k = int((1.0 - density) * n)
    if k < 1:
        return masks
    threshold = torch.kthvalue(flat.cpu(), k).values
    return {p: s.float() > threshold.to(s.device) for p, s in scores.items()}


def per_layer_threshold_mask(scores: Masks, densities: dict[str, float]) -> Masks:
    """Per-layer masking (random_erk / random_balanced): in each layer keep
    the scores above its k-th smallest, k = int((1 - density) * n). At
    k <= 0 keep every position with a positive score: scores at pruned
    positions are exactly 0, so a density-1 layer keeps its mask rather
    than resurrecting pruned weights (the JAX package's rule)."""
    out = {}
    for path, s in scores.items():
        n = s.numel()
        k = int((1.0 - densities[path]) * n)
        if k <= 0:
            out[path] = s > 0.0
            continue
        threshold = torch.kthvalue(s.reshape(-1).float().cpu(), k).values
        out[path] = s.float() > threshold.to(s.device)
    return out
