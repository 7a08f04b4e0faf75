"""Device-resident CIFAR loaders (port of ``turboprune_tpu/data/cifar.py``).

The whole dataset sits on the device; it is preprocessed once (normalize,
pre-flip, reflect-pad) and each training epoch is augmented and shuffled at
once, with ``torch.Generator``s derived from (seed, epoch), so the epoch
counter is the loader's whole random state, as in the JAX package.
Batches are slices. The synthetic loaders use the same class.

The raw data is read from local files only: a cached ``cifar10.npz`` /
``cifar100.npz`` under ``data_root_dir``, or the python pickle batches
(``cifar-10-batches-py`` / ``cifar-100-python``). Nothing is downloaded.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path
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


def _load_pickle_batches(root: Path, dataset: str) -> Optional[tuple]:
    """Read the standard CIFAR python-pickle layout if present. The files
    are the dataset's own pickles of numpy arrays, read from local disk."""
    if dataset == "CIFAR10":
        d = root / "cifar-10-batches-py"
        train_files = [d / f"data_batch_{i}" for i in range(1, 6)]
        test_files = [d / "test_batch"]
        label_key = b"labels"
    else:
        d = root / "cifar-100-python"
        train_files = [d / "train"]
        test_files = [d / "test"]
        label_key = b"fine_labels"
    if not d.exists():
        return None

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                entry = pickle.load(fh, encoding="bytes")
            xs.append(
                np.asarray(entry[b"data"], np.uint8)
                .reshape(-1, 3, 32, 32)
                .transpose(0, 2, 3, 1)  # -> NHWC
            )
            ys.append(np.asarray(entry[label_key], np.int32))
        return np.concatenate(xs), np.concatenate(ys)

    return read(train_files), read(test_files)


def load_cifar_arrays(
    data_root_dir: str, dataset_name: str = "CIFAR10"
) -> tuple[tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """((train_x, train_y), (test_x, test_y)) as uint8 NHWC / int32: the
    npz cache (``cache_cifar_npz``) first, then the pickle batches."""
    root = Path(data_root_dir)
    npz = root / f"{dataset_name.lower()}.npz"
    if npz.exists():
        with np.load(npz) as z:
            return (z["train_x"], z["train_y"]), (z["test_x"], z["test_y"])
    loaded = _load_pickle_batches(root, dataset_name)
    if loaded is not None:
        return loaded
    raise FileNotFoundError(
        f"No {dataset_name} data under {root} (expected {npz.name} or the "
        "python pickle batches). The loader reads local files only and "
        "downloads nothing: stage the data there, or use "
        "dataloader_type: synthetic."
    )


def cache_cifar_npz(
    data_root_dir: str,
    dataset_name: str,
    train: tuple[np.ndarray, np.ndarray],
    test: tuple[np.ndarray, np.ndarray],
) -> Path:
    """Write the arrays as ``<data_root_dir>/<dataset>.npz``."""
    root = Path(data_root_dir)
    root.mkdir(parents=True, exist_ok=True)
    out = root / f"{dataset_name.lower()}.npz"
    np.savez(out, train_x=train[0], train_y=train[1], test_x=test[0], test_y=test[1])
    return out


def derived_generator(device: torch.device, *key) -> torch.Generator:
    """A generator on ``device`` seeded from ``key`` (ints and strings) by
    a hash, so that (seed, epoch, purpose) streams are independent and
    reproducible."""
    digest = hashlib.sha256(repr(key).encode()).digest()
    seed = int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


class DeviceCifarLoader:
    """Epoch iterator over device-resident, whole-epoch-augmented images.

    train => shuffle + drop_last + aug {flip, translate, cutout} (flips by
    the altflip unless ``altflip=False``); test => in order, no aug, last
    partial batch padded with label -1."""

    def __init__(
        self,
        images: np.ndarray,  # uint8 NHWC
        labels: np.ndarray,
        batch_size: int,
        train: bool,
        dataset_name: str = "CIFAR10",
        aug: Optional[dict] = None,
        altflip: bool = True,
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
        self.altflip = altflip
        self.aug = dict(aug or {})
        unknown = set(self.aug) - {"flip", "translate", "cutout"}
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
                cutout=int(self.aug.get("cutout", 0)),
                altflip=self.altflip,
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


class CifarLoaders:
    """Train/test pair with the reference's airbench recipe: train aug
    flip + translate 2 with the altflip; the test loader seeded seed + 1."""

    def __init__(
        self,
        data_root_dir: str,
        dataset_name: str,
        batch_size: int,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        (train_x, train_y), (test_x, test_y) = load_cifar_arrays(data_root_dir, dataset_name)
        self.num_classes = 10 if dataset_name == "CIFAR10" else 100
        self.train_loader = DeviceCifarLoader(
            train_x, train_y, batch_size, train=True, dataset_name=dataset_name,
            aug={"flip": True, "translate": 2}, altflip=True, seed=seed, device=device,
        )
        self.test_loader = DeviceCifarLoader(
            test_x, test_y, batch_size, train=False, dataset_name=dataset_name,
            seed=seed + 1, device=device,
        )
