"""Input pipelines (port of ``turboprune_tpu/data/__init__.py``).

``create_loaders`` builds the loader pair for a config on a device:

  device    whole dataset on the device, whole-epoch augmentation (CIFAR)
  tpk       the native loader: a memory-mapped packed file, multithreaded
            C++ decode and crop (``csrc/tpkdata.cpp``), batches streamed to
            the device by the prefetch engine (``native.py``, ``pipeline.py``)
  grain     an ImageFolder of JPEGs decoded by Pillow in DataLoader worker
            processes, in the order and with the crops of the JAX
            package's grain loader, without grain (``imagenet.py``)
  synthetic deterministic generated data
"""

from __future__ import annotations

from typing import Any

import torch

from .cifar import CifarLoaders, DeviceCifarLoader, cache_cifar_npz, load_cifar_arrays
from .imagenet import GrainImageLoader, ImageFolderLoader, ImageNetLoaders
from .native import TpkImageLoader, TpkLoaders
from .synthetic import SyntheticLoaders, synthetic_arrays


def create_loaders(cfg, device: str | torch.device = "cuda") -> Any:
    """Loader pair (``.train_loader``, ``.test_loader``) on ``device``."""
    dp = cfg.dataset_params
    if dp.dataloader_type == "synthetic":
        return SyntheticLoaders(
            dataset_name=dp.dataset_name,
            batch_size=dp.total_batch_size,
            image_size=dp.image_size,
            num_classes=dp.num_classes,
            num_train=dp.synthetic_num_train,
            num_test=dp.synthetic_num_test,
            seed=cfg.experiment_params.seed,
            task=dp.synthetic_task,
            snr=dp.synthetic_snr,
            device=device,
        )
    if dp.dataloader_type == "device":
        if dp.dataset_name not in ("CIFAR10", "CIFAR100"):
            raise ValueError("dataloader_type=device is for CIFAR")
        return CifarLoaders(
            data_root_dir=dp.data_root_dir,
            dataset_name=dp.dataset_name,
            batch_size=dp.total_batch_size,
            seed=cfg.experiment_params.seed,
            device=device,
        )
    if dp.dataloader_type == "tpk":
        return TpkLoaders(
            data_root_dir=dp.data_root_dir,
            total_batch_size=dp.total_batch_size,
            num_classes=dp.num_classes,
            image_size=dp.image_size,
            seed=cfg.experiment_params.seed,
            nthreads=dp.tpk_nthreads,
            prefetch_depth=dp.prefetch_depth,
            decode_workers=dp.decode_workers,
            train_path=dp.tpk_train_path,
            val_path=dp.tpk_val_path,
            auto_pack=dp.tpk_auto_pack,
            device=device,
        )
    if dp.dataloader_type == "grain":
        return ImageNetLoaders(
            data_root_dir=dp.data_root_dir,
            total_batch_size=dp.total_batch_size,
            num_workers=dp.num_workers,
            seed=cfg.experiment_params.seed,
            image_size=dp.image_size,
            prefetch_depth=dp.prefetch_depth,
            device=device,
        )
    raise ValueError(f"Unknown dataloader_type: {dp.dataloader_type}")


__all__ = [
    "CifarLoaders",
    "DeviceCifarLoader",
    "GrainImageLoader",
    "ImageFolderLoader",
    "ImageNetLoaders",
    "SyntheticLoaders",
    "TpkImageLoader",
    "TpkLoaders",
    "cache_cifar_npz",
    "create_loaders",
    "load_cifar_arrays",
    "synthetic_arrays",
]
