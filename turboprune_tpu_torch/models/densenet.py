"""DenseNet in torch.nn (port of ``turboprune_tpu/models/densenet.py``).

torchvision's layout: dense blocks of BN-ReLU-Conv1x1(4k) ->
BN-ReLU-Conv3x3(k) layers whose outputs concatenate onto the running
feature map, BN-ReLU-Conv1x1 transitions at 0.5 compression with a VALID
2x2 average pool, then ``norm_final``, ReLU, the global mean and an fp32
``classifier``. The ImageNet stem is a 7x7 stride-2 conv with an explicit
3-pixel pad and a 3x3 stride-2 max pool padded (1, 1); the CIFAR stem a
3x3 conv and no pool.

Module names follow the flax param paths (``conv0``, ``norm0``,
``denseblock{i}_layer{j}`` with ``norm1``/``conv1``/``norm2``/``conv2``,
``transition{i}`` with ``norm``/``conv``, ``norm_final``, ``classifier``),
so ``bridge.py`` maps checkpoints mechanically and mask keys are the flax
path names. The convolutions are ``resnet.Conv`` (flax's SAME padding, no
bias, cast to the compute dtype), the norms ``resnet.FlaxBatchNorm2d``.
Images come in NHWC; the activations are an NCHW view with
``channels_last`` strides.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv, FlaxBatchNorm2d

_SPARSE_SLICE = (
    "is part of the sparse-execution slice of the port (ROADMAP.md, queue A, "
    "item 15: compaction, N:M and the planner), not yet ported"
)


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, conv, norm,
                 bottleneck_width: int = 4):
        super().__init__()
        inner = bottleneck_width * growth_rate
        self.norm1 = norm(in_features)
        self.conv1 = conv(in_features, inner, 1)
        self.norm2 = norm(inner)
        self.conv2 = conv(inner, growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_features: int, out_features: int, conv, norm):
        super().__init__()
        self.norm = norm(in_features)
        self.conv = conv(in_features, out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    def __init__(
        self,
        block_sizes: Sequence[int],
        num_classes: int,
        growth_rate: int = 32,
        init_features: int = 64,
        cifar_stem: bool = False,
        dtype: Any = torch.float32,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        width_overrides: Optional[Any] = None,
        nm_overrides: Optional[Any] = None,
    ):
        super().__init__()
        if width_overrides:
            raise NotImplementedError(f"width_overrides (compaction) {_SPARSE_SLICE}")
        if nm_overrides:
            raise NotImplementedError(f"nm_overrides (N:M execution) {_SPARSE_SLICE}")
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.dtype = dtype

        def conv(cin, cout, k, stride=1, padding=None):
            return Conv(cin, cout, k, stride, padding, dtype=dtype)

        def norm(features):
            return FlaxBatchNorm2d(features, bn_momentum, bn_epsilon, dtype)

        if cifar_stem:
            self.conv0 = conv(3, init_features, 3)
        else:
            self.conv0 = conv(3, init_features, 7, 2, padding=3)
        self.norm0 = norm(init_features)
        features = init_features
        self.layer_names: list[str] = []
        for i, layers in enumerate(block_sizes):
            for j in range(layers):
                name = f"denseblock{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(features + j * growth_rate, growth_rate,
                                                 conv, norm))
                self.layer_names.append(name)
            features += layers * growth_rate
            if i + 1 < len(block_sizes):
                name = f"transition{i + 1}"
                self.add_module(name, Transition(features, features // 2, conv, norm))
                self.layer_names.append(name)
                features //= 2  # torchvision's 0.5 compression
        self.norm_final = norm(features)
        self.classifier = nn.Linear(features, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DenseNet":
        """flax's initializers from an explicit generator: convs
        ``variance_scaling(2.0, "fan_out", "normal")`` (an untruncated
        normal of variance 2 / (out * kh * kw)), the classifier
        lecun_normal (a truncated normal whose std after the +-2 sigma cut
        is sqrt(1 / fan_in)) with a zero bias, BatchNorm scale 1 and bias
        0, running mean 0 and variance 1."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                fan_out = module.weight.shape[0] * module.weight[0, 0].numel()
                nn.init.normal_(module.weight, 0.0, math.sqrt(2.0 / fan_out),
                                generator=generator)
            elif isinstance(module, nn.Linear):
                std = math.sqrt(1.0 / module.weight.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2.0 * std, b=2.0 * std,
                                      generator=generator)
                module.bias.zero_()
            elif isinstance(module, FlaxBatchNorm2d):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view with channels_last strides (no copy).
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.norm0(self.conv0(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.layer_names:
            x = self._modules[name](x)
        x = F.relu(self.norm_final(x))
        # jnp.mean of a bf16 tensor: fp32 sum, result rounded to bf16.
        x = x.float().mean((2, 3)).to(self.dtype).float()
        return self.classifier(x)


def densenet121(num_classes: int, cifar_stem: bool = False, **kw) -> DenseNet:
    return DenseNet([6, 12, 24, 16], num_classes, cifar_stem=cifar_stem, **kw)


def densenet169(num_classes: int, cifar_stem: bool = False, **kw) -> DenseNet:
    return DenseNet([6, 12, 32, 32], num_classes, cifar_stem=cifar_stem, **kw)
