"""Weights carried across: flax param trees <-> the port's ``state_dict``.

Works on numpy trees (what ``jax.device_get`` of a flax params dict
gives), so this module needs neither JAX nor flax. The torch modules are
named after the flax paths (models/vit.py), so the mapping is mechanical:

- conv kernel HWIO -> weight OIHW;
- ``DenseGeneral`` query/key/value kernel [D, H, hd] -> Linear weight
  [H*hd, D], bias [H, hd] -> [H*hd];
- ``out`` kernel [H, hd, D] -> Linear weight [D, H*hd];
- Dense kernel [in, out] -> Linear weight [out, in];
- LayerNorm and BatchNorm scale/bias -> weight/bias;
- ``cls_token``/``dist_token``/``pos_embed`` as they are;
- BatchNorm ``batch_stats`` ``{mean, var}`` -> the buffers ``mean``/``var``
  of ``models/resnet.py::FlaxBatchNorm2d``.

The CNNs map the same way: DenseNet's nested paths
(``denseblock1_layer1/norm1``, ``transition1/conv``) become dotted module
names, and VGG's ``fc0`` kernel needs no permutation of its rows, because
the port's VGG flattens its activations in flax's (H, W, C) order.

Masks take the same transforms as their kernels and are keyed by the flax
path name (``block0/attn/query/kernel``). Every transform is a transpose or
a reshape, so a round trip is bit-exact.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

_HEAD_SPLIT_IN = ("query", "key", "value")  # kernel [D, H, hd]
_HEAD_SPLIT_OUT = ("out",)  # kernel [H, hd, D]
_BATCH_STATS = ("mean", "var")  # BatchNorm buffers, flax's batch_stats leaves


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key in sorted(tree):
        value = tree[key]
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _kernel_to_torch(module: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # conv HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 3 and module in _HEAD_SPLIT_IN:
        return a.reshape(a.shape[0], -1).T
    if a.ndim == 3 and module in _HEAD_SPLIT_OUT:
        return a.reshape(-1, a.shape[-1]).T
    if a.ndim == 2:
        return a.T
    raise ValueError(f"no torch layout for {module!r} kernel of shape {a.shape}")


def _to_tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable C-order copy


def params_from_flax(
    params: Mapping,
    masks: Optional[Mapping] = None,
    batch_stats: Optional[Mapping] = None,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(state_dict, masks) for the port from a flax params tree, its
    optional mask tree (bool at kernels, None elsewhere) and its optional
    ``batch_stats`` tree, whose leaves become the BatchNorm buffers of the
    state_dict. Without a mask tree the mask dict is empty."""
    mask_leaves = dict(_leaves(masks)) if masks is not None else {}
    state: dict[str, torch.Tensor] = {}
    for path, a in _leaves(batch_stats or {}):
        if path[-1] not in _BATCH_STATS:
            raise KeyError(f"no torch buffer for flax batch_stats {'/'.join(path)}")
        state[".".join(path)] = _to_tensor(np.asarray(a))
    out_masks: dict[str, torch.Tensor] = {}
    for path, a in _leaves(params):
        a = np.asarray(a)
        leaf, module = path[-1], path[:-1]
        if not module:  # cls_token / dist_token / pos_embed
            state[leaf] = _to_tensor(a)
            continue
        name = ".".join(module)
        if leaf == "kernel":
            state[f"{name}.weight"] = _to_tensor(_kernel_to_torch(module[-1], a))
            m = mask_leaves.get(path)
            if m is not None:
                t = _kernel_to_torch(module[-1], np.asarray(m).astype(bool))
                out_masks["/".join(path)] = _to_tensor(t)
        elif leaf == "bias":
            state[f"{name}.bias"] = _to_tensor(a.reshape(-1) if a.ndim == 2 else a)
        elif leaf == "scale":
            state[f"{name}.weight"] = _to_tensor(a)
        else:
            raise KeyError(f"no torch name for flax param {'/'.join(path)}")
    return state, out_masks


def _kernel_to_flax(module: str, w: np.ndarray, num_heads: int) -> np.ndarray:
    if w.ndim == 4:  # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0)
    if module in _HEAD_SPLIT_IN:
        t = w.T  # [D, H*hd]
        return t.reshape(t.shape[0], num_heads, -1)
    if module in _HEAD_SPLIT_OUT:
        t = w.T  # [H*hd, D]
        return t.reshape(num_heads, -1, t.shape[-1])
    return w.T


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def params_to_flax(
    state_dict: Mapping[str, torch.Tensor],
    masks: Optional[Mapping[str, torch.Tensor]],
    num_heads: int,
) -> tuple[dict, Optional[dict]]:
    """Inverse of ``params_from_flax``: (flax params tree, flax mask tree
    or None) as numpy. ``num_heads`` splits the attention projections back
    into their [D, H, hd] / [H, hd, D] kernels. The mask tree mirrors the
    params tree with None at every non-kernel leaf. BatchNorm buffers are
    not params: ``batch_stats_to_flax`` takes them."""
    params: dict = {}
    mask_tree: Optional[dict] = {} if masks is not None else None
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        parts = tuple(key.split("."))
        if len(parts) > 1 and parts[-1] in _BATCH_STATS:
            continue
        if len(parts) == 1:
            _set(params, parts, a)
            if mask_tree is not None:
                _set(mask_tree, parts, None)
            continue
        module, leaf = parts[:-1], parts[-1]
        if leaf == "weight" and a.ndim == 1:  # LayerNorm
            path = module + ("scale",)
            value = a
        elif leaf == "weight":
            path = module + ("kernel",)
            value = _kernel_to_flax(module[-1], a, num_heads)
        elif leaf == "bias":
            path = module + ("bias",)
            if module[-1] in _HEAD_SPLIT_IN:
                value = a.reshape(num_heads, -1)
            else:
                value = a
        else:
            raise KeyError(f"no flax name for torch param {key}")
        _set(params, path, value)
        if mask_tree is not None:
            m = masks.get("/".join(path)) if path[-1] == "kernel" else None
            if m is not None:
                m = _kernel_to_flax(module[-1], m.detach().cpu().numpy(), num_heads)
            _set(mask_tree, path, m)
    return params, mask_tree


def batch_stats_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax ``batch_stats`` tree (numpy) of the BatchNorm buffers in
    ``state_dict``; empty for a model without BatchNorm."""
    tree: dict = {}
    for key, t in state_dict.items():
        parts = tuple(key.split("."))
        if len(parts) > 1 and parts[-1] in _BATCH_STATS:
            _set(tree, parts, t.detach().cpu().numpy())
    return tree
