"""Input pipelines (port of ``turboprune_tpu/data/__init__.py``).

``create_loaders`` builds the loader pair for a config on a device. The
synthetic loaders and the device CIFAR loader (local files) are ported;
grain and the native .tpk loader come with a later slice and raise here.
"""

from __future__ import annotations

from typing import Any

import torch

from .cifar import CifarLoaders, DeviceCifarLoader, cache_cifar_npz, load_cifar_arrays
from .synthetic import SyntheticLoaders, synthetic_arrays

NOT_YET_PORTED = {
    "grain": "ROADMAP.md queue A, item 14",
    "tpk": "ROADMAP.md queue A, item 14",
}


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
    if dp.dataloader_type in NOT_YET_PORTED:
        raise NotImplementedError(
            f"dataloader_type={dp.dataloader_type!r} is not yet ported to "
            f"turboprune_tpu_torch ({NOT_YET_PORTED[dp.dataloader_type]}); "
            "use dataloader_type=synthetic"
        )
    raise ValueError(f"Unknown dataloader_type: {dp.dataloader_type}")


__all__ = [
    "CifarLoaders",
    "DeviceCifarLoader",
    "SyntheticLoaders",
    "cache_cifar_npz",
    "create_loaders",
    "load_cifar_arrays",
    "synthetic_arrays",
]
