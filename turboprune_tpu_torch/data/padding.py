"""The eval-batch padding contract (port of
``turboprune_tpu/data/padding.py``): eval loaders pad a partial batch to the
full batch size with zero images and label -1; the eval step masks those
rows out of every metric.

``pad_eval_batch`` pads device tensors (the device loaders);
``pad_eval_batch_host`` pads a decoded host batch in place (the .tpk loader,
which decodes into full-size host buffers and pads in the decode task)."""

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


def pad_eval_batch_host(images, labels, n_valid: int):
    """Pad a full-size host batch (numpy arrays or CPU tensors) whose first
    ``n_valid`` rows hold samples: the rows after them become zero images
    with label -1, in place. The same values as ``pad_eval_batch`` (and the
    JAX package's) on the batch of ``n_valid`` rows."""
    images[n_valid:] = 0
    labels[n_valid:] = PAD_LABEL
    return images, labels
