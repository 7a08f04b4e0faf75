"""Device-resident epoch loader (port of ``DeviceCifarLoader`` in
``turboprune_tpu/data/cifar.py``).

The whole dataset sits on the device; it is preprocessed once (normalize,
pre-flip, reflect-pad) and each training epoch is augmented and shuffled at
once, with ``torch.Generator``s derived from (seed, epoch), so the epoch
counter is the loader's whole random state, as in the JAX package.
Batches are slices. Reading CIFAR from disk is a later slice (ROADMAP.md
queue A, item 10); the synthetic loaders use this class.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, Optional

import numpy as np
import torch

from .augment import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    CIFAR100_MEAN,
    CIFAR100_STD,
    augment_epoch,
    batch_flip_lr,
    normalize_uint8,
    pad_reflect,
)
from .padding import pad_eval_batch

Batch = tuple[torch.Tensor, torch.Tensor]


def derived_generator(device: torch.device, *key) -> torch.Generator:
    """A generator on ``device`` seeded from ``key`` (ints and strings) by
    a hash, so that (seed, epoch, purpose) streams are independent and
    reproducible."""
    digest = hashlib.sha256(repr(key).encode()).digest()
    seed = int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


class DeviceCifarLoader:
    """Epoch iterator over device-resident, whole-epoch-augmented images.

    train => shuffle + drop_last + aug {flip (altflip), translate=2};
    test => in order, no aug, last partial batch padded with label -1."""

    def __init__(
        self,
        images: np.ndarray,  # uint8 NHWC
        labels: np.ndarray,
        batch_size: int,
        train: bool,
        dataset_name: str = "CIFAR10",
        aug: Optional[dict] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        mean, std = (
            (CIFAR10_MEAN, CIFAR10_STD)
            if dataset_name == "CIFAR10"
            else (CIFAR100_MEAN, CIFAR100_STD)
        )
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.train = train
        self.drop_last = train
        self.shuffle = train
        self.aug = dict(aug or {})
        unknown = set(self.aug) - {"flip", "translate"}
        if unknown:
            raise ValueError(f"Unrecognized aug keys: {sorted(unknown)}")
        self.epoch = 0
        self.seed = seed
        self.labels = torch.as_tensor(labels, dtype=torch.int64).to(self.device)
        self.image_size = images.shape[1]
        base = normalize_uint8(torch.from_numpy(images).to(self.device), mean, std)
        if self.aug.get("flip"):
            base = batch_flip_lr(base, derived_generator(self.device, seed, "preflip"))
        if self.aug.get("translate", 0) > 0:
            base = pad_reflect(base, int(self.aug["translate"]))
        self._base = base

    def __len__(self) -> int:
        n = self.labels.shape[0]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_data(self) -> Batch:
        """Augmented and shuffled tensors for one epoch (advances the epoch
        counter)."""
        epoch = self.epoch
        self.epoch += 1
        if self.aug:
            images = augment_epoch(
                self._base,
                derived_generator(self.device, self.seed, epoch, "augment"),
                epoch,
                crop_size=self.image_size,
                flip=bool(self.aug.get("flip", False)),
                translate=int(self.aug.get("translate", 0)),
            )
        else:
            images = self._base
        labels = self.labels
        if self.shuffle:
            perm = torch.randperm(
                labels.shape[0],
                generator=derived_generator(self.device, self.seed, epoch, "shuffle"),
                device=self.device,
            )
            images, labels = images[perm], labels[perm]
        return images, labels

    def __iter__(self) -> Iterator[Batch]:
        images, labels = self._epoch_data()
        n = labels.shape[0]
        for i in range(len(self)):
            lo = i * self.batch_size
            hi = min(lo + self.batch_size, n)
            if hi - lo < self.batch_size:
                yield pad_eval_batch(images[lo:hi], labels[lo:hi], self.batch_size)
            else:
                yield images[lo:hi], labels[lo:hi]
