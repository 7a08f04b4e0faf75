"""VGG in torch.nn (port of ``turboprune_tpu/models/vgg.py``).

torchvision's topology with the BatchNorm variants: 3x3 convolutions
(padding 1, with bias), each followed by flax's BatchNorm
(``resnet.FlaxBatchNorm2d``, momentum 0.9, eps 1e-5) in the ``_bn``
variants and a ReLU, 2x2 max pools, the adaptive average pool to 7x7,
then ``fc0``/``fc1`` (ReLU, dropout 0.5) and ``fc2`` in fp32.

Module names follow the flax param paths (``conv{k}``, ``bn{k}``,
``fc0``/``fc1``/``fc2``), so ``bridge.py`` maps checkpoints mechanically
and mask keys are the flax path names. Images come in NHWC; the
activations are an NCHW view with ``channels_last`` strides, so the
flatten before ``fc0`` takes them in (H, W, C) order, as flax's reshape of
its NHWC tensor does: ``fc0``'s rows keep the JAX package's order and the
bridge needs no permutation.

Dropout (after ``fc0`` and ``fc1``) draws nothing itself: in training the
caller hands the forward the uniforms of ``dropout_shapes(n)``
(``models/dropout.py``), at the widths this model was built with.

``width_overrides`` ("conv{k}" / "fc0" / "fc1" -> kept channels) builds
the model at compacted widths and ``nm_overrides`` ("fc0" | "fc1" | "fc2"
-> (kept_in, kept_out) index maps) puts ``sparse.nm_execute.NMDense`` in
those layers (sparse/); module names stay the same.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout, forward_noise
from .resnet import FlaxBatchNorm2d

# torchvision cfgs: D = vgg16, E = vgg19 ("M" = maxpool)
VGG_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

def adaptive_avg_pool(x: torch.Tensor, out_hw: int = 7) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` bins on NCHW ``x``, as the JAX package
    pools: the identity at ``out_hw``, a broadcast from 1x1, otherwise bin
    i over [floor(i*H/out), ceil((i+1)*H/out)), rows first, then columns,
    each mean summed in fp32 and rounded to ``x``'s dtype."""
    n, c, h, w = x.shape
    if h == out_hw and w == out_hw:
        return x
    if h == 1 and w == 1:
        return x.expand(n, c, out_hw, out_hw)
    x = F.adaptive_avg_pool2d(x.float(), (out_hw, w)).to(x.dtype)
    return F.adaptive_avg_pool2d(x.float(), (out_hw, out_hw)).to(x.dtype)


class ConvBias(nn.Conv2d):
    """flax ``nn.Conv(features, (3, 3), padding=1, use_bias=True)`` in
    ``dtype``: input and weight cast to ``dtype``, the product, then the
    bias added in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, dtype: Any = torch.float32):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, 1, 1)
        return y + self.bias.to(self.dtype)[:, None, None]


class VGG(nn.Module):
    def __init__(
        self,
        cfg: Sequence,
        num_classes: int,
        batch_norm: bool = True,
        dtype: Any = torch.float32,
        dropout_rate: float = 0.5,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        fc_features: Sequence[int] = (4096, 4096),
        width_overrides: Optional[Any] = None,
        nm_overrides: Optional[Any] = None,
    ):
        super().__init__()
        self.cfg = list(cfg)
        self.num_classes = num_classes
        self.batch_norm = batch_norm
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.bn_epsilon = bn_epsilon
        self.fc_features = tuple(fc_features)
        ov = dict(width_overrides or {})
        nv = dict(nm_overrides or {})
        cin, k = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            v = ov.get(f"conv{k}", v)
            self.add_module(f"conv{k}", ConvBias(cin, v, dtype))
            if batch_norm:
                self.add_module(f"bn{k}", FlaxBatchNorm2d(v, bn_momentum, bn_epsilon, dtype))
            cin, k = v, k + 1
        self.num_convs = k

        def fc(name: str, cin: int, cout: int) -> nn.Linear:
            hook = nv.get(name)
            if hook is None:
                return nn.Linear(cin, cout)
            from ..sparse.nm_execute import NMDense

            return NMDense(cin, cout, *hook)

        width0 = ov.get("fc0", self.fc_features[0])
        width1 = ov.get("fc1", self.fc_features[1])
        self.fc0 = fc("fc0", cin * 49, width0)
        self.fc1 = fc("fc1", width0, width1)
        self.fc2 = fc("fc2", width1, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VGG":
        """flax's defaults from an explicit generator: conv and dense
        kernels lecun_normal (a truncated normal whose std after the +-2
        sigma cut is sqrt(1 / fan_in)), zero biases, BatchNorm scale 1 and
        bias 0, running mean 0 and variance 1."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / module.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2.0 * std, b=2.0 * std,
                                      generator=generator)
                module.bias.zero_()
            elif isinstance(module, FlaxBatchNorm2d):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
        return self

    def dropout_shapes(self, n: int) -> list[tuple[int, ...]]:
        """Shapes of the uniforms a train forward of ``n`` images takes (in
        the order it uses them); empty when the rate is 0."""
        if self.dropout_rate == 0.0:
            return []
        return [(n, self.fc0.out_features), (n, self.fc1.out_features)]

    def forward(self, x: torch.Tensor, noise: Optional[list] = None) -> torch.Tensor:
        if x.shape[1] < 32 or x.shape[2] < 32:
            # 5 stride-2 max pools: under 32 px the features collapse to
            # nothing and the classifier would emit bias-only logits.
            raise ValueError(f"VGG needs inputs >= 32x32, got {x.shape[1]}x{x.shape[2]}")
        noise = forward_noise(self, noise)
        noise0, noise1 = noise if noise else (None, None)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        k = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = self._modules[f"conv{k}"](x)
            if self.batch_norm:
                x = self._modules[f"bn{k}"](x)
            x = F.relu(x)
            k += 1
        x = adaptive_avg_pool(x, 7)
        # (H, W, C) order, as flax flattens NHWC; a view under channels_last.
        # The classifier runs in fp32 (float64 in a float64 model).
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = x.to(torch.promote_types(self.dtype, torch.float32))
        x = dropout(F.relu(self.fc0(x)), self.dropout_rate, noise0)
        x = dropout(F.relu(self.fc1(x)), self.dropout_rate, noise1)
        return self.fc2(x)


def _make(name: str, batch_norm: bool):
    def ctor(num_classes: int, cifar_stem: bool = False, **kw) -> VGG:
        # No CIFAR surgery: the adaptive pool takes 32 px inputs.
        del cifar_stem
        return VGG(VGG_CFGS[name], num_classes, batch_norm=batch_norm, **kw)

    return ctor


vgg11 = _make("vgg11", False)
vgg11_bn = _make("vgg11", True)
vgg13 = _make("vgg13", False)
vgg13_bn = _make("vgg13", True)
vgg16 = _make("vgg16", False)
vgg16_bn = _make("vgg16", True)
vgg19 = _make("vgg19", False)
vgg19_bn = _make("vgg19", True)
