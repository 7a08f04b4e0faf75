"""Model registry (port of ``turboprune_tpu/models/__init__.py``).

The DeiT family is ported. The CNN names of the JAX registry are listed so
that asking for one says it is not yet ported (ROADMAP.md, queue A) instead
of claiming the name is unknown.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from . import vit
from .vit import VisionTransformer

MODEL_REGISTRY: dict[str, Callable] = {
    "deit_tiny_patch16_224": vit.deit_tiny_patch16_224,
    "deit_small_patch16_224": vit.deit_small_patch16_224,
    "deit_base_patch16_224": vit.deit_base_patch16_224,
    "deit_base_patch16_384": vit.deit_base_patch16_384,
    "deit_tiny_distilled_patch16_224": vit.deit_tiny_distilled_patch16_224,
    "deit_small_distilled_patch16_224": vit.deit_small_distilled_patch16_224,
    "deit_base_distilled_patch16_224": vit.deit_base_distilled_patch16_224,
    "deit_base_distilled_patch16_384": vit.deit_base_distilled_patch16_384,
}

NOT_YET_PORTED = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "densenet121", "densenet169",
    "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn",
    "vgg19", "vgg19_bn",
)


def create_model(
    model_name: str,
    num_classes: int,
    dataset_name: str = "CIFAR10",
    compute_dtype: Any = torch.float32,
    attention_impl: str = "dense",
    image_size: int = 224,
    width_overrides: Any = None,
    nm_overrides: Any = None,
) -> VisionTransformer:
    """Build a registered model. ``image_size`` fixes the DeiT patch grid,
    which flax infers from the first batch instead."""
    if model_name in NOT_YET_PORTED:
        raise ValueError(
            f"model {model_name!r} is not yet ported to turboprune_tpu_torch "
            "(the CNN zoo is ROADMAP.md queue A); ported: "
            f"{sorted(MODEL_REGISTRY)}"
        )
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"Model {model_name!r} not in registry: {sorted(MODEL_REGISTRY)}"
        )
    cifar_stem = dataset_name.lower() in ("cifar10", "cifar100")
    return MODEL_REGISTRY[model_name](
        num_classes,
        cifar_stem=cifar_stem,
        dtype=compute_dtype,
        attention_impl=attention_impl,
        image_size=image_size,
        width_overrides=width_overrides,
        nm_overrides=nm_overrides,
    )


__all__ = ["MODEL_REGISTRY", "NOT_YET_PORTED", "VisionTransformer", "create_model"]
