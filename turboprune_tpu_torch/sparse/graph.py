"""Mask-structure analysis: channel spaces and per-architecture propagation
(port of ``turboprune_tpu/sparse/graph.py``).

High-sparsity lottery tickets grow dead fan-out slices: whole output
channels or neurons whose mask is all zero. Those can be cashed in by
physically shrinking tensors along channel axes, but only if every tensor
sharing the axis shrinks together: the kernel's out-slice, its bias entry,
the BatchNorm scale/bias/mean/var entries, and the matching in-slice of
every consumer kernel downstream. This module builds that sharing
structure as a *propagation graph*:

  Space     one compactable channel axis: the out-axis of one producer
            kernel, the per-channel leaves riding on it (conv/dense bias,
            BatchNorm params and statistics), and an optional ``post`` op
            chain applied before the space's value reaches consumers
            (DenseNet's stem norm).
  Consumer  a kernel whose in-axis is built from one or more spaces
            (concatenation order kept), with the per-channel ``gate`` op
            chain between the raw space value and the consumer's input
            (BN -> ReLU for CNNs, GELU for ViT MLPs), and a ``repeat``
            factor for flatten boundaries (VGG's 7x7xC -> fc0).

Spaces are only created where compaction is provably local: VGG's conv and
hidden fc out-spaces (a chain), ResNet's block-internal spaces (propagation
stops at residual joins), DenseNet's concat-aware segments, bottlenecks and
transitions, and ViT's MLP hidden axis.

The port walks flat dicts keyed by flax path (``conv0/kernel``,
``bn0/scale``, ``bn0/mean``: the names ``bridge.py`` gives;
``model_leaves`` reads them off a model) whose values are in the torch
layout: every kernel's out-axis is 0 and its in-axis 1 (Linear
``[out, in]``, conv ``[out, in, kh, kw]``), and VGG's ``fc0`` takes its
inputs in flax's (H, W, C) order, so the 49-fold repeat is flax's.
Whether a dead channel may be removed is a numeric question on top of this
structure (compact.py); this module is shape and topology only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

import torch
from torch import nn

# A leaf's flax path name, "layer1_0/Conv_0/kernel".
PathT = str
# Per-channel op between a space's raw value and a consumer's input:
#   ("bn", module_path, eps)  BatchNorm with params {module}/scale, /bias
#                             and batch_stats {module}/mean, /var
#   ("relu",)                 max(x, 0)
#   ("gelu",)                 exact (erf) GELU
GateOp = tuple


class CompactionError(ValueError):
    """Raised when a model/mask pair cannot be compacted as requested."""


@dataclass(frozen=True)
class Producer:
    kernel: PathT                 # path of the kernel leaf in params
    bias: Optional[PathT] = None  # conv/dense bias leaf (None: no bias)


@dataclass(frozen=True)
class Consumer:
    kernel: PathT                 # kernel whose in-axis (1) is sliced
    segments: tuple[str, ...]     # space names composing the in-axis, in order
    gate: tuple[GateOp, ...] = ()
    # Flatten factor: the in-axis is ``repeat * sum(segment channels)`` laid
    # out channel-fastest (VGG's [7, 7, C] -> 49*C).
    repeat: int = 1
    # Per-channel leaves on the consumer side of the edge: a BatchNorm that
    # normalises the (possibly concatenated) input before this kernel
    # (DenseNet's norm1 / transition norm / norm_final), sliced by the
    # concatenated in-keep vector (before the repeat).
    attached_params: tuple[PathT, ...] = ()
    attached_stats: tuple[PathT, ...] = ()


@dataclass
class Space:
    name: str
    channels: int
    producer: Producer
    attached_params: list[PathT] = field(default_factory=list)
    attached_stats: list[PathT] = field(default_factory=list)
    # Op chain on the raw producer output before the value joins any
    # consumer's input (DenseNet stem: conv0 -> norm0 -> relu -> concat).
    post: tuple[GateOp, ...] = ()
    # Key of the compacted width in the model's ``width_overrides``: the
    # kernel path without "/kernel".
    override_key: str = ""


@dataclass
class PropagationGraph:
    arch: str
    spaces: dict[str, Space]
    consumers: list[Consumer]


# --------------------------------------------------------------------- util
def flax_path(state_key: str, ndim: int) -> PathT:
    """The flax path of a ``state_dict`` entry: ``weight`` is a kernel (2-D
    and up) or a norm's ``scale`` (1-D); ``bias``, ``mean``, ``var`` and
    the token/position leaves keep their names."""
    parts = state_key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim >= 2 else "scale"
    return "/".join(parts)


def state_key(path: PathT) -> str:
    """Inverse of ``flax_path``."""
    parts = path.split("/")
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def model_leaves(model: nn.Module) -> tuple[dict[PathT, torch.Tensor], dict[PathT, torch.Tensor]]:
    """(params, batch_stats) of ``model`` as flat dicts keyed by flax path,
    the values the model's own tensors (detached, not copied). Buffers
    outside the ``state_dict`` (the N:M index maps) are not statistics."""
    params = {flax_path(k, p.dim()): p.detach() for k, p in model.named_parameters()}
    names = set(dict(model.named_parameters()))
    stats = {
        flax_path(k, v.dim()): v.detach()
        for k, v in model.state_dict(keep_vars=True).items()
        if k not in names
    }
    return params, stats


def _get(tree: Mapping, path: PathT):
    try:
        return tree[path]
    except KeyError as e:
        raise CompactionError(
            f"param path {path} not found while building the propagation "
            f"graph — model/params mismatch? ({e!r})"
        ) from e


def _out_channels(params: Mapping, kernel: PathT) -> int:
    return int(_get(params, kernel).shape[0])


def _key_of(kernel: PathT) -> str:
    return kernel[: -len("/kernel")]


# ------------------------------------------------------------ per-arch build
def _resnet_graph(model, params) -> PropagationGraph:
    from ..models.resnet import Bottleneck

    eps = float(model.bn_epsilon)
    inner = 2 if issubclass(model.block_cls, Bottleneck) else 1
    spaces: dict[str, Space] = {}
    consumers: list[Consumer] = []
    for i, count in enumerate(model.stage_sizes):
        for j in range(count):
            block = f"layer{i + 1}_{j}"
            for k in range(inner):
                bn = f"{block}/BatchNorm_{k}"
                kernel = f"{block}/Conv_{k}/kernel"
                name = _key_of(kernel)
                spaces[name] = Space(
                    name=name,
                    channels=_out_channels(params, kernel),
                    producer=Producer(kernel),
                    attached_params=[f"{bn}/scale", f"{bn}/bias"],
                    attached_stats=[f"{bn}/mean", f"{bn}/var"],
                    override_key=name,
                )
                consumers.append(
                    Consumer(
                        kernel=f"{block}/Conv_{k + 1}/kernel",
                        segments=(name,),
                        gate=(("bn", bn, eps), ("relu",)),
                    )
                )
    return PropagationGraph("resnet", spaces, consumers)


def _vgg_graph(model, params) -> PropagationGraph:
    eps = float(model.bn_epsilon)
    n_convs = sum(1 for v in model.cfg if v != "M")
    spaces: dict[str, Space] = {}
    consumers: list[Consumer] = []
    for k in range(n_convs):
        conv = f"conv{k}"
        attached_p: list[PathT] = []
        attached_s: list[PathT] = []
        gate: list[GateOp] = []
        if model.batch_norm:
            bn = f"bn{k}"
            attached_p += [f"{bn}/scale", f"{bn}/bias"]
            attached_s += [f"{bn}/mean", f"{bn}/var"]
            gate.append(("bn", bn, eps))
        gate.append(("relu",))
        spaces[conv] = Space(
            name=conv,
            channels=_out_channels(params, f"{conv}/kernel"),
            producer=Producer(f"{conv}/kernel", bias=f"{conv}/bias"),
            attached_params=attached_p,
            attached_stats=attached_s,
            override_key=conv,
        )
        if k + 1 < n_convs:
            consumers.append(
                Consumer(kernel=f"conv{k + 1}/kernel", segments=(conv,), gate=tuple(gate))
            )
        else:
            # features -> classifier: adaptive pool to 7x7 (channelwise),
            # then the (H, W, C) flatten, channel-fastest.
            consumers.append(
                Consumer(kernel="fc0/kernel", segments=(conv,), gate=tuple(gate), repeat=49)
            )
    for fc, nxt in (("fc0", "fc1"), ("fc1", "fc2")):
        spaces[fc] = Space(
            name=fc,
            channels=_out_channels(params, f"{fc}/kernel"),
            producer=Producer(f"{fc}/kernel", bias=f"{fc}/bias"),
            override_key=fc,
        )
        consumers.append(Consumer(kernel=f"{nxt}/kernel", segments=(fc,), gate=(("relu",),)))
    return PropagationGraph("vgg", spaces, consumers)


def _bn_leaves(module: str) -> tuple[tuple[PathT, PathT], tuple[PathT, PathT]]:
    return (f"{module}/scale", f"{module}/bias"), (f"{module}/mean", f"{module}/var")


def _densenet_graph(model, params) -> PropagationGraph:
    eps = float(model.bn_epsilon)
    spaces: dict[str, Space] = {}
    consumers: list[Consumer] = []
    # Stem segment: conv0 -> norm0 -> relu [-> maxpool] feeds the concat
    # stream already normalised, so its normalisation is a space-level
    # ``post`` chain (every other segment is normalised per consumer).
    p0, s0 = _bn_leaves("norm0")
    spaces["conv0"] = Space(
        name="conv0",
        channels=_out_channels(params, "conv0/kernel"),
        producer=Producer("conv0/kernel"),
        attached_params=list(p0),
        attached_stats=list(s0),
        post=(("bn", "norm0", eps), ("relu",)),
        override_key="conv0",
    )
    segs: list[str] = ["conv0"]
    for i, layers in enumerate(model.block_sizes):
        for j in range(layers):
            layer = f"denseblock{i + 1}_layer{j + 1}"
            # norm1(+relu) over the whole running concat, then conv1: the
            # norm's per-channel leaves span the concat and slice with it.
            p1, s1 = _bn_leaves(f"{layer}/norm1")
            consumers.append(
                Consumer(
                    kernel=f"{layer}/conv1/kernel",
                    segments=tuple(segs),
                    gate=(("bn", f"{layer}/norm1", eps), ("relu",)),
                    attached_params=p1,
                    attached_stats=s1,
                )
            )
            mid = f"{layer}/conv1"
            p2, s2 = _bn_leaves(f"{layer}/norm2")
            spaces[mid] = Space(
                name=mid,
                channels=_out_channels(params, f"{mid}/kernel"),
                producer=Producer(f"{mid}/kernel"),
                attached_params=list(p2),
                attached_stats=list(s2),
                override_key=mid,
            )
            consumers.append(
                Consumer(
                    kernel=f"{layer}/conv2/kernel",
                    segments=(mid,),
                    gate=(("bn", f"{layer}/norm2", eps), ("relu",)),
                )
            )
            seg = f"{layer}/conv2"
            spaces[seg] = Space(
                name=seg,
                channels=_out_channels(params, f"{seg}/kernel"),
                producer=Producer(f"{seg}/kernel"),
                override_key=seg,
            )
            segs.append(seg)
        if i + 1 < len(model.block_sizes):
            tr = f"transition{i + 1}"
            pt, st = _bn_leaves(f"{tr}/norm")
            consumers.append(
                Consumer(
                    kernel=f"{tr}/conv/kernel",
                    segments=tuple(segs),
                    gate=(("bn", f"{tr}/norm", eps), ("relu",)),
                    attached_params=pt,
                    attached_stats=st,
                )
            )
            name = f"{tr}/conv"
            spaces[name] = Space(
                name=name,
                channels=_out_channels(params, f"{name}/kernel"),
                producer=Producer(f"{name}/kernel"),
                override_key=name,
            )
            segs = [name]
    pf, sf = _bn_leaves("norm_final")
    consumers.append(
        Consumer(
            kernel="classifier/kernel",
            segments=tuple(segs),
            gate=(("bn", "norm_final", eps), ("relu",)),
            attached_params=pf,
            attached_stats=sf,
        )
    )
    return PropagationGraph("densenet", spaces, consumers)


def _vit_graph(model, params) -> PropagationGraph:
    spaces: dict[str, Space] = {}
    consumers: list[Consumer] = []
    for i in range(model.depth):
        name = f"block{i}/mlp/fc1"
        spaces[name] = Space(
            name=name,
            channels=_out_channels(params, f"{name}/kernel"),
            producer=Producer(f"{name}/kernel", bias=f"{name}/bias"),
            override_key=name,
        )
        consumers.append(
            Consumer(kernel=f"block{i}/mlp/fc2/kernel", segments=(name,), gate=(("gelu",),))
        )
    return PropagationGraph("vit", spaces, consumers)


def build_graph(model: nn.Module, params: Mapping) -> PropagationGraph:
    """Propagation graph for a supported model, with channel counts read
    from the flat ``params`` dict (so width-overridden models analyse
    correctly too). Raises CompactionError for other architectures."""
    from ..models.densenet import DenseNet
    from ..models.resnet import ResNet
    from ..models.vgg import VGG
    from ..models.vit import VisionTransformer

    if isinstance(model, ResNet):
        return _resnet_graph(model, params)
    if isinstance(model, VGG):
        return _vgg_graph(model, params)
    if isinstance(model, DenseNet):
        return _densenet_graph(model, params)
    if isinstance(model, VisionTransformer):
        return _vit_graph(model, params)
    raise CompactionError(
        f"no propagation graph for model type {type(model).__name__} — "
        "compaction supports ResNet, VGG, DenseNet and ViT (MLP blocks)"
    )
