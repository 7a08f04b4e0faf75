"""Gathered N:M execution — run projected masks at reduced GEMM width (port
of ``turboprune_tpu/sparse/nm_execute.py``).

For a layer whose mask is ``keep_in ⊗ keep_out`` separable (what
``project_masks`` produces), the kept weights of each M-block gather into
dense ``[.., K·N/M]`` tensors through an index map. The maps are int64
buffers of the module, on its device (not in its ``state_dict``), so a
step makes no host copy.

``nm_matmul`` is a ``torch.autograd.Function`` with the JAX package's
custom VJP unchanged:

  y  = gather(x) @ gather(w) + b — the reduced GEMM; outputs outside
       ``kept_out`` are their bias, as in masked-dense;
  dx = scatter(dyg @ wgᵀ) into [B, I] — reduced by both axes;
  dw = xᵀ @ dy — the FULL GEMM, masked-dense's dw expression. The true
       gradient of the gathered forward is zero outside keep_in ⊗
       keep_out; the mask product outside the module (``apply_masks``)
       zeroes exactly those entries, so the gradient that reaches the
       optimizer is masked-dense's;
  db = Σ dy.

The modules keep their dense counterparts' parameter names and order:
``NMDense`` is an ``nn.Linear`` (the port's attention projections are
Linear weights already, so it also stands for the JAX ``NMDenseGeneral``),
``NMConv1x1`` a 1x1 ``resnet.Conv`` run on the channels_last activation as
a (N·H·W, C) matmul, ``NMSelfAttention`` the dense ``SelfAttention`` with
gathered projections. So masks, checkpoints and the bridge stay keyed the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.resnet import Conv
from ..models.vit import SelfAttention
from ..ops.masking import Masks
from .nm import _matrix_view, eligible_layers, matrix

# Route a layer through the gathered path only when the index map drops at
# least this fraction of the contraction axis — below that the gather
# overhead eats the reduced-GEMM win. Any projected N:M pattern clears it
# (N/M <= 1/2); dense level-0 masks never route.
MIN_AXIS_SAVINGS = 0.25


# ------------------------------------------------------------- the matmul


class _NMMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w2, b, ki, ko):
        xg = x2.index_select(1, ki)
        wg = w2.index_select(0, ki)
        if ko is None:
            y = xg @ wg + b
        else:
            z = xg @ wg.index_select(1, ko) + b.index_select(0, ko)
            y = b.expand(x2.shape[0], -1).index_copy(1, ko, z)
        ctx.save_for_backward(x2, w2, ki, ko)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w2, ki, ko = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            wg = w2.index_select(0, ki)
            dyg = dy
            if ko is not None:
                wg = wg.index_select(1, ko)
                dyg = dy.index_select(1, ko)
            # Rows outside ki are all-zero in the mask, so masked-dense's dx
            # is zero there too.
            dx = x2.new_zeros(x2.shape).index_copy(1, ki, (dyg @ wg.T).to(x2.dtype))
        # dw: the full GEMM, deliberately not the gathered forward's literal
        # gradient (see the module docstring).
        dw = (x2.T @ dy).to(w2.dtype)
        db = dy.sum(0).to(dy.dtype)
        return dx, dw, db, None, None


def nm_matmul(ki, ko, x2: torch.Tensor, w2: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = x2 @ w2 + b at reduced width: ``ki``/``ko`` index the live rows
    and columns of the (already mask-multiplied) kernel ``w2[I, O]``
    (int64 tensors, or sequences of ints); ``ko=None``: the output axis is
    full. Dropped output columns produce their bias, as masked-dense."""
    ki = torch.as_tensor(ki, dtype=torch.long, device=x2.device)
    if ko is not None:
        ko = torch.as_tensor(ko, dtype=torch.long, device=x2.device)
    return _NMMatmul.apply(x2, w2, b, ki, ko)


def _index_buffer(module: nn.Module, name: str, index: Optional[Sequence[int]]) -> None:
    value = None if index is None else torch.as_tensor(tuple(index), dtype=torch.long)
    module.register_buffer(name, value, persistent=False)


# -------------------------------------------------------------- the layers


class NMDense(nn.Linear):
    """``nn.Linear`` (flax ``Dense``) with gathered N:M execution: the same
    parameters; input, weight and bias cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, kept_in: Sequence[int],
                 kept_out: Optional[Sequence[int]] = None, dtype: Any = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        _index_buffer(self, "kept_in", kept_in)
        _index_buffer(self, "kept_out", kept_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = nm_matmul(
            self.kept_in, self.kept_out, x.reshape(-1, self.in_features).to(dt),
            self.weight.to(dt).T, self.bias.to(dt),
        )
        return y.reshape(*x.shape[:-1], self.out_features)


class NMConv1x1(Conv):
    """A 1x1 ``resnet.Conv`` (no bias) as a gathered matmul over channels:
    the channels_last activation viewed as (N·H·W, C); a stride subsamples
    first (VALID 1x1 semantics). The JAX op's zero bias is kept: its
    gradient is dropped."""

    def __init__(self, in_channels: int, out_channels: int, kept_in: Sequence[int],
                 kept_out: Optional[Sequence[int]] = None, stride: int = 1,
                 dtype: Any = torch.float32):
        super().__init__(in_channels, out_channels, 1, stride, dtype=dtype)
        _index_buffer(self, "kept_in", kept_in)
        _index_buffer(self, "kept_out", kept_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        if s != 1:
            x = x[:, :, ::s, ::s]
        n, c, h, w = x.shape
        x2 = x.to(self.dtype).permute(0, 2, 3, 1).reshape(-1, c)
        w2 = self.weight.to(self.dtype).reshape(self.out_channels, c).T
        y = nm_matmul(self.kept_in, self.kept_out, x2, w2, x2.new_zeros(self.out_channels))
        return y.reshape(n, h, w, self.out_channels).permute(0, 3, 1, 2)


class NMSelfAttention(SelfAttention):
    """Dense self-attention with gathered query/key/value/out projections
    where ``nm`` hooks them ({"query": (kept_in, kept_out), ...}); the
    others stay ``Dense`` under the same name."""

    def __init__(self, dim: int, num_heads: int, dtype, nm: dict):
        super().__init__(dim, num_heads, dtype, "dense")
        for name, (ki, ko) in nm.items():
            setattr(self, name, NMDense(dim, dim, ki, ko, dtype))


# ------------------------------------------------------------ plan builder


@dataclasses.dataclass
class NMExecPlan:
    """Which layers run gathered at this level, with which index maps. A
    pure function of the masks and the model family."""

    # model-hook key -> (kept_in tuple, kept_out tuple | None)
    overrides: dict
    report: dict

    def as_override_tuple(self) -> tuple:
        """Hashable form for step-cache keys."""
        return tuple(sorted(self.overrides.items()))


def _hook_key(model, name: str, shape: tuple) -> Optional[str]:
    """The model's ``nm_overrides`` key of a mask path; None = the layer
    has no gathered hook (it stays masked-dense, counted as unrouted)."""
    from ..models.densenet import DenseNet
    from ..models.resnet import Bottleneck, ResNet
    from ..models.vgg import VGG
    from ..models.vit import VisionTransformer

    key = name[: -len("/kernel")] if name.endswith("/kernel") else name
    if isinstance(model, VisionTransformer):
        parts = key.split("/")
        if key in ("head", "head_dist"):
            return key
        if len(parts) == 3 and parts[1] == "mlp" and parts[2] in ("fc1", "fc2"):
            return key
        if (
            len(parts) == 3
            and parts[1] == "attn"
            and parts[2] in ("query", "key", "value", "out")
            # Only dense attention takes projection hooks; flash keeps its
            # projections dense and attention on the flash kernels.
            and model.attention_impl == "dense"
        ):
            return key
        return None
    if isinstance(model, VGG):
        return key if key in ("fc0", "fc1", "fc2") else None
    if isinstance(model, ResNet):
        if key == "fc":
            return key
        # Bottleneck's leading 1x1 conv (non-residual, stride 1). The
        # expansion 1x1 and downsample convs feed the residual stream and
        # stay masked-dense.
        if model.block_cls is Bottleneck and key.endswith("/Conv_0") and len(shape) == 4:
            return key
        return None
    if isinstance(model, DenseNet):
        return key if key == "classifier" else None
    return None


def build_nm_plan(model, masks: Masks, min_axis_savings: float = MIN_AXIS_SAVINGS) -> NMExecPlan:
    """The gathered-execution plan from the live masks. Live rows and
    columns (any surviving weight), not the projected pattern: after a
    compaction slices channels out, block alignment is gone but liveness
    is still exact, which is what lets the two backends compose."""
    overrides: dict = {}
    layers: dict = {}
    eligible_params = 0
    routed_params = 0
    for name, shape, s in eligible_layers(masks):
        i, o = _matrix_view(shape, s)
        numel = int(np.prod(shape))
        eligible_params += numel
        key = _hook_key(model, name, shape)
        m2 = matrix(masks[name])
        live_in = torch.nonzero(m2.any(dim=1)).flatten().cpu().tolist()
        live_out = torch.nonzero(m2.any(dim=0)).flatten().cpu().tolist()
        routed = key is not None and len(live_in) <= i * (1.0 - min_axis_savings)
        if routed:
            kept_out = tuple(live_out) if len(live_out) < o else None
            overrides[key] = (tuple(live_in), kept_out)
            routed_params += numel
        layers[name] = {
            "numel": numel,
            "routed": routed,
            "hookable": key is not None,
            "kept_in_frac": len(live_in) / i,
            "kept_out_frac": len(live_out) / o,
        }
    report = {
        "eligible_params": eligible_params,
        "routed_params": routed_params,
        "coverage_frac": routed_params / eligible_params if eligible_params else 0.0,
        "layers": layers,
    }
    return NMExecPlan(overrides=overrides, report=report)
