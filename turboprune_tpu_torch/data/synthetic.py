"""Deterministic synthetic datasets (port of
``turboprune_tpu/data/synthetic.py``).

``synthetic_arrays`` is numpy and is copied as it is, so the port draws
byte-identical images and labels from the same seed. ``SyntheticLoaders``
puts them behind the device loader (``cifar.py``), as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .cifar import DeviceCifarLoader


def synthetic_arrays(
    num_samples: int,
    image_size: int,
    num_classes: int,
    seed: int = 0,
    class_seed: int = 12345,
    task: str = "easy",
    snr: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional uint8 images; class structure is drawn from
    ``class_seed`` ONLY, so train/test splits (different ``seed``) share it.

    task="easy": each class gets a distinct mean color (noise sigma 25).
    task="hard": all classes share the same mean gray; class c is a mixture
    of four low-amplitude sinusoidal gratings (distinct spatial frequency +
    color axis per variant, phase randomized per sample) buried in noise;
    ``snr`` scales the grating amplitude."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(num_samples,), dtype=np.int64)
    noise_sigma = 25.0
    noise = rng.normal(
        0.0, noise_sigma, size=(num_samples, image_size, image_size, 3)
    )
    if task == "easy":
        means = np.random.default_rng(class_seed).uniform(
            40.0, 215.0, size=(num_classes, 1, 1, 3)
        )
        images = np.clip(means[labels] + noise, 0, 255).astype(np.uint8)
        return images, labels.astype(np.int32)
    if task != "hard":
        raise ValueError(f"synthetic task {task!r} not in ('easy', 'hard')")
    variants = 4
    freqs, colors = _grating_signatures(num_classes, variants, image_size,
                                        class_seed)
    amp = 3.0 * snr * noise_sigma / np.sqrt(image_size * image_size / 2.0)
    which = rng.integers(0, variants, size=(num_samples,))
    phase = rng.uniform(0.0, 2 * np.pi, size=(num_samples,))
    xx, yy = np.meshgrid(np.arange(image_size), np.arange(image_size),
                         indexing="ij")
    fx = freqs[labels, which, 0, None, None]
    fy = freqs[labels, which, 1, None, None]
    wave = np.sin(
        2 * np.pi * (fx * xx[None] + fy * yy[None]) / image_size
        + phase[:, None, None]
    )
    signal = amp * wave[..., None] * colors[labels, which][:, None, None, :]
    images = np.clip(128.0 + signal + noise, 0, 255).astype(np.uint8)
    return images, labels.astype(np.int32)


def _grating_signatures(
    num_classes: int, variants: int, image_size: int, class_seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (fx, fy) integer spatial frequencies + unit color axes for
    every (class, variant) signature, drawn from ``class_seed`` only."""
    rng = np.random.default_rng(class_seed)
    fmax = max(2, image_size // 4)
    pairs = np.array(
        [(fx, fy) for fx in range(fmax) for fy in range(fmax) if fx or fy]
    )
    need = num_classes * variants
    if need > len(pairs):
        raise ValueError(
            f"hard synthetic task: {need} signatures exceed the "
            f"{len(pairs)} distinct frequency pairs at image_size={image_size}"
        )
    chosen = pairs[rng.choice(len(pairs), size=need, replace=False)]
    freqs = chosen.reshape(num_classes, variants, 2)
    colors = rng.normal(0.0, 1.0, size=(num_classes, variants, 3))
    colors /= np.linalg.norm(colors, axis=-1, keepdims=True)
    return freqs, colors


class SyntheticLoaders:
    """Train/test pair over synthetic data, resident on ``device`` (the
    CIFAR device loader, so augmentation and shuffle are the same)."""

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        image_size: int,
        num_classes: int,
        num_train: int = 2048,
        num_test: int = 512,
        seed: int = 0,
        task: str = "easy",
        snr: float = 1.0,
        device: str | torch.device = "cuda",
    ):
        self.num_classes = num_classes
        train_x, train_y = synthetic_arrays(
            num_train, image_size, num_classes, seed=seed, task=task, snr=snr
        )
        test_x, test_y = synthetic_arrays(
            num_test, image_size, num_classes, seed=seed + 1, task=task, snr=snr
        )
        cifar_name = "CIFAR100" if dataset_name == "CIFAR100" else "CIFAR10"
        self.train_loader = DeviceCifarLoader(
            train_x, train_y, batch_size, train=True, dataset_name=cifar_name,
            aug={"flip": True, "translate": 2}, seed=seed,
            device=device,
        )
        self.test_loader = DeviceCifarLoader(
            test_x, test_y, batch_size, train=False, dataset_name=cifar_name,
            seed=seed + 1, device=device,
        )
