"""Model registry (port of ``turboprune_tpu/models/__init__.py``): every
model of the JAX package's registry, the ResNets, DenseNets, VGGs and
DeiTs."""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from . import densenet, resnet, vgg, vit
from .densenet import DenseNet
from .resnet import ResNet
from .vgg import VGG
from .vit import VisionTransformer

MODEL_REGISTRY: dict[str, Callable] = {
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
    "densenet121": densenet.densenet121,
    "densenet169": densenet.densenet169,
    "vgg11": vgg.vgg11,
    "vgg11_bn": vgg.vgg11_bn,
    "vgg13": vgg.vgg13,
    "vgg13_bn": vgg.vgg13_bn,
    "vgg16": vgg.vgg16,
    "vgg16_bn": vgg.vgg16_bn,
    "vgg19": vgg.vgg19,
    "vgg19_bn": vgg.vgg19_bn,
    "deit_tiny_patch16_224": vit.deit_tiny_patch16_224,
    "deit_small_patch16_224": vit.deit_small_patch16_224,
    "deit_base_patch16_224": vit.deit_base_patch16_224,
    "deit_base_patch16_384": vit.deit_base_patch16_384,
    "deit_tiny_distilled_patch16_224": vit.deit_tiny_distilled_patch16_224,
    "deit_small_distilled_patch16_224": vit.deit_small_distilled_patch16_224,
    "deit_base_distilled_patch16_224": vit.deit_base_distilled_patch16_224,
    "deit_base_distilled_patch16_384": vit.deit_base_distilled_patch16_384,
}

# Every model of the JAX package's registry is ported.
NOT_YET_PORTED: tuple[str, ...] = ()


def create_model(
    model_name: str,
    num_classes: int,
    dataset_name: str = "CIFAR10",
    compute_dtype: Any = torch.float32,
    attention_impl: str = "dense",
    image_size: int = 224,
    width_overrides: Any = None,
    nm_overrides: Any = None,
) -> nn.Module:
    """Build a registered model. CIFAR datasets get the CIFAR stem.
    ``attention_impl`` and ``image_size`` are the DeiTs' (``image_size``
    fixes the patch grid, which flax infers from the first batch instead);
    a CNN takes neither and refuses an attention other than dense."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"Model {model_name!r} not in registry: {sorted(MODEL_REGISTRY)}"
        )
    cifar_stem = dataset_name.lower() in ("cifar10", "cifar100")
    kwargs = {}
    if model_name.startswith("deit"):
        kwargs = {"attention_impl": attention_impl, "image_size": image_size}
    elif attention_impl != "dense":
        raise ValueError(
            f"attention_impl={attention_impl!r} requires a ViT model "
            f"(got {model_name!r})"
        )
    return MODEL_REGISTRY[model_name](
        num_classes,
        cifar_stem=cifar_stem,
        dtype=compute_dtype,
        width_overrides=width_overrides,
        nm_overrides=nm_overrides,
        **kwargs,
    )


__all__ = [
    "MODEL_REGISTRY",
    "NOT_YET_PORTED",
    "VGG",
    "DenseNet",
    "ResNet",
    "VisionTransformer",
    "create_model",
]
