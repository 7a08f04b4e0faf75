"""The eval-batch padding contract (port of
``turboprune_tpu/data/padding.py``): eval loaders pad a partial batch to the
full batch size with zero images and label -1; the eval step masks those
rows out of every metric."""

from __future__ import annotations

import torch

PAD_LABEL = -1


def pad_eval_batch(images: torch.Tensor, labels: torch.Tensor, batch_size: int):
    """Pad (images, labels) up to ``batch_size`` rows; no-op when full."""
    pad = batch_size - images.shape[0]
    if pad <= 0:
        return images, labels
    return (
        torch.cat([images, images.new_zeros((pad,) + tuple(images.shape[1:]))]),
        torch.cat([labels, labels.new_full((pad,), PAD_LABEL)]),
    )
