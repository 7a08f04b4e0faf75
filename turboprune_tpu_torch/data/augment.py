"""Batched image augmentation on the device, NHWC (port of
``turboprune_tpu/data/augment.py``).

The whole training set is augmented at once per epoch, then batches are
slices. Randomness comes from explicit ``torch.Generator``s, which draw
other numbers than ``jax.random`` from the same seed: the tests compare the
deterministic parts exactly (normalisation, reflect padding, the crop at
given offsets, the altflip) and the random parts by their structure.

  - normalize once with dataset mean/std
  - ``flip``: one random per-image pre-flip at epoch 0, then flip the
    ENTIRE set on odd epochs (the reference's altflip)
  - ``translate=r``: reflect-pad by r then a random (sy, sx) crop per image

The JAX package's cutout and i.i.d. per-epoch flips (``altflip=False``)
have no caller in its loaders' configurations and are not ported.
"""

from __future__ import annotations

import torch

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR100_STD = (0.2675, 0.2565, 0.2761)


def normalize_uint8(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [0,255] NHWC -> normalized float32 (scale to [0,1] first)."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def batch_flip_lr(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Random horizontal flip per image."""
    flip = torch.rand(
        images.shape[0], generator=generator, device=images.device
    ) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source rows of an axis of length n reflect-padded by r (the edge row
    is not repeated, as numpy's and torch's 'reflect')."""
    return torch.cat([
        torch.arange(r, 0, -1, device=device),
        torch.arange(n, device=device),
        torch.arange(n - 2, n - 2 - r, -1, device=device),
    ])


def pad_reflect(images: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect-pad H and W of NHWC images by r. (``F.pad`` on an NHWC
    tensor would pad its last two dims, W and C.)"""
    _, h, w, _ = images.shape
    out = images.index_select(1, _reflect_index(h, r, images.device))
    return out.index_select(2, _reflect_index(w, r, images.device))


def crop_at(
    padded: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor, crop_size: int
) -> torch.Tensor:
    """Crop ``crop_size`` x ``crop_size`` from each padded image at its own
    offset (sy[i], sx[i]): one copy per distinct offset pair."""
    out = torch.empty(
        (padded.shape[0], crop_size, crop_size, padded.shape[3]),
        dtype=padded.dtype, device=padded.device,
    )
    r2 = padded.shape[1] - crop_size
    for y in range(r2 + 1):
        for x in range(r2 + 1):
            idx = ((sy == y) & (sx == x)).nonzero().squeeze(1)
            if idx.numel():
                out[idx] = padded[idx, y : y + crop_size, x : x + crop_size]
    return out


def batch_translate_crop(
    padded: torch.Tensor, generator: torch.Generator, crop_size: int
) -> torch.Tensor:
    """Random (sy, sx) crop of ``crop_size`` from padded images, one
    independent integer shift per image."""
    n = padded.shape[0]
    r2 = padded.shape[1] - crop_size
    sy = torch.randint(0, r2 + 1, (n,), generator=generator, device=padded.device)
    sx = torch.randint(0, r2 + 1, (n,), generator=generator, device=padded.device)
    return crop_at(padded, sy, sx, crop_size)


def augment_epoch(
    preflipped_padded: torch.Tensor,
    generator: torch.Generator,
    epoch: int,
    *,
    crop_size: int,
    flip: bool = True,
    translate: int = 2,
) -> torch.Tensor:
    """Augment the ENTIRE training set for one epoch. The input is the
    epoch-0 preprocessed set: normalized, pre-flipped (if ``flip``),
    reflect-padded (if ``translate``)."""
    images = preflipped_padded
    if translate > 0:
        images = batch_translate_crop(images, generator, crop_size)
    if flip and epoch % 2 == 1:
        images = images.flip(2)
    return images
