"""ResNet family in torch.nn (port of ``turboprune_tpu/models/resnet.py``).

Module names follow the flax param paths (``conv1``, ``bn1``,
``layer{i}_{j}`` with ``Conv_k``/``BatchNorm_k``/``downsample_conv``/
``downsample_bn`` inside, ``fc``), so ``bridge.py`` maps checkpoints
mechanically and mask keys are the flax path names.

Images come in NHWC ``[n, H, W, C]`` as in the JAX package. The model
permutes once to NCHW; on a contiguous NHWC tensor that view is already
``channels_last``, the layout cuDNN's 16-bit convolutions want, and every
later activation keeps it.

What has to match flax op by op:

- convolutions pad as flax's ``SAME``: a stride-2 3x3 conv pads (0, 1) on
  an even input and (1, 1) on an odd one (torch's ``padding=1`` is right
  only on odd sizes). The ImageNet stem keeps its explicit (3, 3) and the
  max-pool its (1, 1);
- BatchNorm is flax's (``FlaxBatchNorm2d``), not torch's;
- params stay fp32; each conv casts its input and (masked) weight to the
  compute dtype; the global mean pool sums in fp32 and rounds to the
  compute dtype, as ``jnp.mean`` of a bf16 tensor does; ``fc`` runs in
  fp32.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_SPARSE_SLICE = (
    "is part of the sparse-execution slice of the port (ROADMAP.md, queue A, "
    "item 15: compaction, N:M and the planner), not yet ported"
)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of one spatial axis under flax's ``SAME``:
    out = ceil(in / stride), total = max((out - 1) * stride + k - in, 0),
    low = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv(use_bias=False)`` in ``dtype``: ``SAME`` padding
    unless ``padding`` is given, input and weight cast to ``dtype``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: int,
        stride: int = 1,
        padding: Optional[int] = None,
        dtype: Any = torch.float32,
    ):
        super().__init__(in_channels, out_channels, kernel, stride, bias=False)
        self.explicit_padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        if self.explicit_padding is not None:
            return F.conv2d(x, w, None, s, self.explicit_padding)
        ph = same_padding(x.shape[2], k, s)
        pw = same_padding(x.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, None, s, (ph[0], pw[0]))
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, None, s)


class FlaxBatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW activations (features on dim 1).

    - Training: batch mean and variance in at least fp32 (flax promotes
      the reductions), the variance as E[x^2] - E[x]^2 clamped at 0 (flax's
      fast variance, biased); the running statistics move as
      ``momentum * old + (1 - momentum) * batch`` (flax's 0.9 on the old
      value is torch's 0.1 on the new one), the variance taking the
      biased batch variance, where torch takes the unbiased.
    - Eval: the running statistics.
    - Normalise in that precision, scale and shift, then cast to
      ``dtype``.

    Buffers ``mean`` and ``var`` are named after flax's ``batch_stats``
    leaves; there is no ``num_batches_tracked``. The running update is in
    place, so a ``functional_call`` handed other ``mean``/``var`` tensors
    updates those and leaves the module's own untouched."""

    def __init__(
        self,
        features: int,
        momentum: float = 0.9,
        epsilon: float = 1e-5,
        dtype: Any = torch.float32,
    ):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, filters: int, stride: int, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_planes, filters, 3, stride)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters)
        self.has_downsample = stride != 1 or in_planes != filters * self.expansion
        if self.has_downsample:
            self.downsample_conv = conv(in_planes, filters * self.expansion, 1, stride)
            self.downsample_bn = norm(filters * self.expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """ResNet v1.5: the stride sits on the 3x3 ``Conv_1``. Wide variants
    multiply the inner width; the block output stays ``filters * 4``."""

    expansion = 4

    def __init__(
        self,
        in_planes: int,
        filters: int,
        stride: int,
        conv,
        norm,
        inner_multiplier: float = 1.0,
    ):
        super().__init__()
        inner = int(filters * inner_multiplier)
        out = filters * self.expansion
        self.Conv_0 = conv(in_planes, inner, 1)
        self.BatchNorm_0 = norm(inner)
        self.Conv_1 = conv(inner, inner, 3, stride)
        self.BatchNorm_1 = norm(inner)
        self.Conv_2 = conv(inner, out, 1)
        self.BatchNorm_2 = norm(out)
        self.has_downsample = stride != 1 or in_planes != out
        if self.has_downsample:
            self.downsample_conv = conv(in_planes, out, 1, stride)
            self.downsample_bn = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """torchvision topology; ``cifar_stem`` is the reference's CIFAR
    surgery (3x3 stride-1 ``conv1``, no max-pool)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        num_classes: int,
        cifar_stem: bool = False,
        width: int = 64,
        inner_multiplier: float = 1.0,
        dtype: Any = torch.float32,
        width_overrides: Optional[Any] = None,
        nm_overrides: Optional[Any] = None,
    ):
        super().__init__()
        if width_overrides:
            raise NotImplementedError(f"width_overrides (compaction) {_SPARSE_SLICE}")
        if nm_overrides:
            raise NotImplementedError(f"nm_overrides (N:M execution) {_SPARSE_SLICE}")
        if inner_multiplier != 1.0 and block_cls is not Bottleneck:
            raise ValueError("inner_multiplier needs Bottleneck blocks")
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.dtype = dtype

        def conv(cin, cout, k, stride=1, padding=None):
            return Conv(cin, cout, k, stride, padding, dtype=dtype)

        def norm(features):
            return FlaxBatchNorm2d(features, dtype=dtype)

        if cifar_stem:
            self.conv1 = conv(3, width, 3)
        else:
            self.conv1 = conv(3, width, 7, 2, padding=3)
        self.bn1 = norm(width)
        block_kw = {"inner_multiplier": inner_multiplier} if inner_multiplier != 1.0 else {}
        in_planes = width
        self.block_names: list[str] = []
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"layer{i + 1}_{j}"
                block = block_cls(in_planes, width * 2**i, stride, conv, norm, **block_kw)
                self.add_module(name, block)
                self.block_names.append(name)
                in_planes = width * 2**i * block_cls.expansion
        self.fc = nn.Linear(in_planes, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """flax's initializers from an explicit generator: convs
        ``variance_scaling(2.0, "fan_out", "normal")`` (an untruncated
        normal of variance 2 / (out * kh * kw)), ``fc`` lecun_normal
        (a truncated normal whose std after the +-2 sigma cut is
        sqrt(1 / fan_in)) with a zero bias, BatchNorm scale 1 and bias 0,
        running mean 0 and variance 1."""
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
        x = F.relu(self.bn1(self.conv1(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = self._modules[name](x)
        # jnp.mean of a bf16 tensor: fp32 sum, result rounded to bf16.
        x = x.float().mean((2, 3)).to(self.dtype).float()
        return self.fc(x)


def resnet18(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, cifar_stem, **kw)


def resnet34(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, cifar_stem, **kw)


def resnet50(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes, cifar_stem, **kw)


def resnet101(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, num_classes, cifar_stem, **kw)


def resnet152(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([3, 8, 36, 3], Bottleneck, num_classes, cifar_stem, **kw)


def wide_resnet50_2(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    """torchvision wide_resnet50_2: bottleneck inner width x2."""
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes, cifar_stem,
                  inner_multiplier=2.0, **kw)


def wide_resnet101_2(num_classes: int, cifar_stem: bool = False, **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, num_classes, cifar_stem,
                  inner_multiplier=2.0, **kw)
