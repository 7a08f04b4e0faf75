"""Pruning criteria as functions ``(…, masks, density, …) -> masks`` (port
of ``turboprune_tpu/pruning/criteria.py``).

Masks are the flax-path-keyed bool dicts of ``ops/masking.py``;
``prune_mag`` scores a model ``state_dict``, SNIP and SynFlow the model. Randomness comes from an explicit
``torch.Generator``, drawn layer after layer in the JAX mask tree's order;
it gives other numbers than ``jax.random``, so the random criteria match
the JAX package in their per-layer densities and kept counts, not in
which weights they keep.

SNIP and SynFlow differentiate a train-mode forward: BatchNorm normalises
with the scoring batch's statistics. The JAX package drops the statistics
that forward updates; here the forward is handed copies of the BatchNorm
buffers, so the model's own stay bit for bit as they were. A model with
dropout (VGG) applies it in that forward, as the JAX package's does, with
uniforms from the criterion's generator (``models/dropout.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.dropout import draw_dropout_noise
from ..ops.masking import (
    Masks,
    apply_masks,
    flax_order,
    global_threshold_mask,
    per_layer_threshold_mask,
    state_key,
)
from .densities import balanced_densities, erk_densities


def _random_normal_scores(masks: Masks, generator: torch.Generator) -> Masks:
    """|N(0, 1)| at unmasked positions, 0 at masked ones (a pruned weight
    never wins a per-layer threshold)."""
    return {
        path: m.float() * torch.randn(
            m.shape, generator=generator, device=generator.device
        ).to(m.device).abs()
        for path, m in flax_order(masks)
    }


def _bernoulli_masks(
    masks: Masks, densities: dict[str, float], generator: torch.Generator
) -> Masks:
    """Each layer's mask ~ Bernoulli(its density)."""
    return {
        path: (torch.rand(m.shape, generator=generator, device=generator.device)
               < densities[path]).to(m.device)
        for path, m in flax_order(masks)
    }


def prune_mag(params: Mapping[str, torch.Tensor], masks: Masks, density: float) -> Masks:
    """Global magnitude: score |w * m| (0 at already-pruned weights, so the
    ladder is monotone), keep the top ``density`` of all prunable weights."""
    scores = {
        path: (params[state_key(path)] * m.to(params[state_key(path)].dtype)).abs()
        for path, m in masks.items()
    }
    return global_threshold_mask(scores, masks, density)


def prune_random_erk(masks: Masks, density: float, generator: torch.Generator) -> Masks:
    return per_layer_threshold_mask(
        _random_normal_scores(masks, generator), erk_densities(masks, density))


def prune_random_balanced(masks: Masks, density: float, generator: torch.Generator) -> Masks:
    return per_layer_threshold_mask(
        _random_normal_scores(masks, generator), balanced_densities(masks, density))


def prune_er_erk(masks: Masks, density: float, generator: torch.Generator) -> Masks:
    return _bernoulli_masks(masks, erk_densities(masks, density), generator)


def prune_er_balanced(masks: Masks, density: float, generator: torch.Generator) -> Masks:
    return _bernoulli_masks(masks, balanced_densities(masks, density), generator)


def _scoring_grads(
    model: nn.Module,
    params: dict[str, torch.Tensor],
    buffers: dict[str, torch.Tensor],
    masks: Masks,
    images: torch.Tensor,
    loss_fn,
    generator: Optional[torch.Generator] = None,
) -> dict[str, torch.Tensor]:
    """Gradients of ``loss_fn(logits)`` with respect to the (raw) kernels
    of ``params``, from a train-mode forward of ``model`` on ``params``
    with ``w * m`` at every masked weight and on ``buffers``, copies of
    the model's own: the BatchNorm statistics the forward updates are
    thrown away. Dropout draws its uniforms from ``generator``."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    noise = None if generator is None else draw_dropout_noise(model, images.shape[0], generator)
    args = (images,) if noise is None else (images, noise)
    was_training = model.training
    model.train()
    try:
        with torch.enable_grad():
            logits = functional_call(
                model, {**apply_masks(leaves, masks), **buffers}, args)
            keys = [state_key(path) for path in masks]
            grads = torch.autograd.grad(loss_fn(logits), [leaves[k] for k in keys])
    finally:
        model.train(was_training)
    return dict(zip(keys, grads))


def snip_scores(model: nn.Module, masks: Masks, batch: tuple,
                generator: Optional[torch.Generator] = None) -> Masks:
    """SNIP saliency |dL/dw * w * m| on ONE batch (mean cross entropy in
    fp32). The gradient is taken with respect to the raw weights, so it
    already carries the mask factor."""
    images, labels = batch
    params = dict(model.named_parameters())
    buffers = {k: v.detach().clone() for k, v in model.named_buffers()}
    grads = _scoring_grads(
        model, params, buffers, masks, images,
        lambda logits: F.cross_entropy(logits.float(), labels, reduction="sum")
        / logits.shape[0],
        generator,
    )
    scores = {}
    for path, m in masks.items():
        w = params[state_key(path)].detach()
        scores[path] = (grads[state_key(path)] * w * m.to(w.dtype)).abs().float()
    return scores


def prune_snip(model: nn.Module, masks: Masks, density: float, batch: tuple,
               generator: Optional[torch.Generator] = None) -> Masks:
    """SNIP: keep the top ``density`` of ``snip_scores``, globally."""
    return global_threshold_mask(snip_scores(model, masks, batch, generator), masks, density)


def synflow_scores(model: nn.Module, masks: Masks, ones_like: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Masks:
    """SynFlow saliency: R = sum(f_|theta|(1)) on an all-ones input of one
    image (shaped and typed as one row of ``ones_like``); score
    m * |dR/dw * |w|| in fp32. Every variable is taken by its absolute
    value, the BatchNorm statistics included; the real params are never
    touched."""
    abs_params = {k: v.detach().abs() for k, v in model.named_parameters()}
    abs_buffers = {k: v.detach().abs() for k, v in model.named_buffers()}
    ones = torch.ones((1,) + tuple(ones_like.shape[1:]), dtype=ones_like.dtype,
                      device=ones_like.device)
    grads = _scoring_grads(model, abs_params, abs_buffers, masks, ones,
                           lambda logits: logits.sum(), generator)
    scores = {}
    for path, m in masks.items():
        g = grads[state_key(path)].float()
        scores[path] = m.float() * (g * abs_params[state_key(path)].float()).abs()
    return scores


def prune_synflow(
    model: nn.Module, masks: Masks, density: float, ones_like: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Masks:
    """SynFlow: keep the top ``density`` of ``synflow_scores``, globally."""
    return global_threshold_mask(
        synflow_scores(model, masks, ones_like, generator), masks, density)
