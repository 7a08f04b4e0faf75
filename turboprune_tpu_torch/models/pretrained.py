"""Pretrained DeiT checkpoints: a timm state_dict onto the port's ViT (port
of ``turboprune_tpu/models/pretrained.py``).

``model_params.pretrained_path`` names a local torch checkpoint, either a
raw timm ``VisionTransformer`` state_dict or the ``{"model": state_dict}``
wrapper of the DeiT release files. The port's ViT keeps flax's module
names (``models/vit.py``) with torch's ``(out, in)`` layout, so the map is
one of names, with no transposition:

  cls_token / dist_token                  -> as they are, (1, 1, D)
  pos_embed                               -> as it is, or the patch grid
                                             resized as ``jax.image.resize``
                                             bicubic does when the model's
                                             token count differs
  patch_embed.proj.{weight,bias}          -> patch_embed.{weight,bias}
  blocks.i.norm{1,2}.{weight,bias}        -> block{i}.norm{1,2}.{weight,bias}
  blocks.i.attn.qkv.weight (3D, D)        -> block{i}.attn.{query,key,value}
                                             .weight (D, D): row blocks 0, 1, 2
  blocks.i.attn.qkv.bias (3D,)            -> the same row blocks of the bias
  blocks.i.attn.proj.{weight,bias}        -> block{i}.attn.out.{weight,bias}
  blocks.i.mlp.fc{1,2}.{weight,bias}      -> block{i}.mlp.fc{1,2}.{weight,bias}
  norm.{weight,bias}                      -> norm.{weight,bias}
  head(_dist)?.{weight,bias}              -> head(_dist)?.{weight,bias}

(The JAX package's flax leaves are the transposes: ``query.kernel`` is
``w_q.T`` reshaped to (D, H, D/H); ``bridge.py`` maps one onto the other.)
The classifier heads stay at their random init, and are listed, when
``num_classes`` differs from the checkpoint's: the fine-tuning posture.
Every converted tensor takes the parameter's dtype (fp32).

There is no download path: the checkpoint is a file the user stages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch
from torch import nn


class PretrainedFormatError(ValueError):
    pass


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a torch checkpoint file into {name: float32 tensor} on the CPU.
    Accepts the raw state_dict or the DeiT release's ``{"model": sd}``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob and isinstance(blob["model"], dict):
        blob = blob["model"]
    if not isinstance(blob, dict) or not blob:
        raise PretrainedFormatError(f"{path}: not a state_dict-shaped checkpoint")
    return {k: torch.as_tensor(v).detach().to(torch.float32) for k, v in blob.items()}


def _split_qkv(w: torch.Tensor, b: torch.Tensor) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """timm's fused qkv, weight (3D, D) and bias (3D,), into the port's
    ``query``/``key``/``value`` Linears: row block i of the weight (out
    rows, in columns, as torch stores a Linear) and of the bias."""
    three_d, d = w.shape
    if three_d != 3 * d:
        raise PretrainedFormatError(f"qkv weight shape {tuple(w.shape)} is not (3D, D)")
    return {name: (w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
            for i, name in enumerate(("query", "key", "value"))}


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at |x| (jax.image's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """The (n_in, n_out) fp32 weight matrix of ``jax.image.resize``'s
    bicubic along one axis (``compute_weight_mat`` with antialias on):
    half-pixel sample centres, the kernel widened by the scale when
    shrinking, each column renormalised to sum 1, and a column whose
    centre falls outside the input zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _interpolate_pos_embed(pe: torch.Tensor, target_tokens: int, n_prefix: int) -> torch.Tensor:
    """timm's ``resample_abs_pos_embed`` as the JAX package does it: the
    cls/dist prefix tokens kept, the square patch grid resized to the
    model's grid by ``jax.image.resize(..., "bicubic")``'s separable
    weights (two fp32 products; ``F.interpolate``'s bicubic is another
    kernel, a = -0.75, clamped at the edges)."""
    src_grid = pe.shape[1] - n_prefix
    dst_grid = target_tokens - n_prefix
    if src_grid == dst_grid:
        return pe
    s = int(round(src_grid ** 0.5))
    d = int(round(dst_grid ** 0.5))
    if s * s != src_grid or d * d != dst_grid:
        raise PretrainedFormatError(
            f"pos_embed grid not square: checkpoint {src_grid} patches, "
            f"model {dst_grid} patches (prefix {n_prefix}) — cannot "
            "interpolate a non-square token grid"
        )
    w = _resize_weights(s, d)  # the same matrix for rows and columns
    grid = pe[0, n_prefix:].reshape(s, s, pe.shape[-1]).float()
    grid = torch.einsum("hwc,hi->iwc", grid, w)
    grid = torch.einsum("iwc,wj->ijc", grid, w)
    return torch.cat([pe[:, :n_prefix].float(), grid.reshape(1, d * d, pe.shape[-1])], dim=1)


def convert_deit_state_dict(
    sd: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor], num_heads: int
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Map a timm DeiT/ViT state_dict onto the port's ViT parameters.

    ``params`` (``dict(model.named_parameters())`` of the fresh model)
    gives the target names, shapes and dtypes and is not modified. Returns
    (new, skipped): ``new`` a new tensor for every converted parameter,
    ``skipped`` the heads kept at their init because the checkpoint's
    class count differs. ``num_heads`` is the JAX converter's argument;
    the port's layout needs it only to check the split."""
    new: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()
    skipped: list[str] = []

    def take(name: str) -> torch.Tensor:
        if name not in sd:
            raise PretrainedFormatError(
                f"checkpoint missing tensor {name!r} — not a timm "
                "VisionTransformer/DeiT state_dict?"
            )
        consumed.add(name)
        return sd[name]

    def put(name: str, value: torch.Tensor) -> None:
        target = params[name]
        if tuple(value.shape) != tuple(target.shape):
            raise PretrainedFormatError(
                f"{name}: checkpoint shape {tuple(value.shape)} != "
                f"model shape {tuple(target.shape)}"
            )
        new[name] = value.detach().to(dtype=target.dtype, copy=True).contiguous()

    put("cls_token", take("cls_token"))
    distilled = "dist_token" in params
    n_prefix = 2 if distilled else 1
    pe = take("pos_embed")
    target_tokens = int(params["pos_embed"].shape[1])
    if pe.shape[1] != target_tokens:
        pe = _interpolate_pos_embed(pe, target_tokens, n_prefix)
        print(
            f"[pretrained] interpolated pos_embed to {pe.shape[1]} tokens "
            "(checkpoint grid bicubic-resized to model grid)",
            flush=True,
        )
    put("pos_embed", pe)
    if distilled:
        put("dist_token", take("dist_token"))
    put("patch_embed.weight", take("patch_embed.proj.weight"))
    put("patch_embed.bias", take("patch_embed.proj.bias"))

    depth = len({k.split(".")[0] for k in params if k.startswith("block")})
    for i in range(depth):
        t, f = f"blocks.{i}", f"block{i}"
        for norm in ("norm1", "norm2"):
            put(f"{f}.{norm}.weight", take(f"{t}.{norm}.weight"))
            put(f"{f}.{norm}.bias", take(f"{t}.{norm}.bias"))
        qkv = _split_qkv(take(f"{t}.attn.qkv.weight"), take(f"{t}.attn.qkv.bias"))
        for name, (w, b) in qkv.items():
            if w.shape[0] % num_heads:
                raise PretrainedFormatError(f"{t}.attn.qkv: width {w.shape[0]} "
                                            f"does not split into {num_heads} heads")
            put(f"{f}.attn.{name}.weight", w)
            put(f"{f}.attn.{name}.bias", b)
        put(f"{f}.attn.out.weight", take(f"{t}.attn.proj.weight"))
        put(f"{f}.attn.out.bias", take(f"{t}.attn.proj.bias"))
        for fc in ("fc1", "fc2"):
            put(f"{f}.mlp.{fc}.weight", take(f"{t}.mlp.{fc}.weight"))
            put(f"{f}.mlp.{fc}.bias", take(f"{t}.mlp.{fc}.bias"))

    put("norm.weight", take("norm.weight"))
    put("norm.bias", take("norm.bias"))

    for head in ("head", "head_dist"):
        if f"{head}.weight" not in params:
            continue
        w = take(f"{head}.weight")
        if w.shape[0] != params[f"{head}.weight"].shape[0]:
            skipped.append(head)  # class-count mismatch: fine-tune from init
            consumed.add(f"{head}.bias")
            continue
        put(f"{head}.weight", w)
        put(f"{head}.bias", take(f"{head}.bias"))

    leftovers = set(sd) - consumed
    if leftovers:
        raise PretrainedFormatError(
            f"unconsumed checkpoint tensors {sorted(leftovers)[:8]} — "
            "architecture mismatch (wrong depth/variant?)"
        )
    return new, skipped


def load_pretrained(path: str | Path, model: nn.Module) -> list[str]:
    """Load a local timm DeiT checkpoint into ``model``'s parameters, in
    place. Every tensor is converted and checked before the first one is
    copied, so a failing checkpoint leaves the model as it was. Returns
    the heads kept at their init."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"model_params.pretrained_path={path} does not exist (this "
            "environment has no download path; stage the checkpoint locally)"
        )
    sd = load_torch_state_dict(path)
    params = dict(model.named_parameters())
    new, skipped = convert_deit_state_dict(sd, params, num_heads=model.block0.attn.num_heads)
    if skipped:
        print(
            f"[pretrained] kept randomly-initialized {skipped} (checkpoint "
            "class count differs from num_classes) — fine-tuning posture",
            flush=True,
        )
    with torch.no_grad():
        for name, value in new.items():
            params[name].copy_(value)
    return skipped
