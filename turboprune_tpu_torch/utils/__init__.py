from .checkpoint import (
    ExperimentCheckpoints,
    restore_model_tree,
    save_model_tree,
)
from .device import resolve_device
from .experiment import load_config, save_config

__all__ = [
    "ExperimentCheckpoints",
    "load_config",
    "resolve_device",
    "restore_model_tree",
    "save_config",
    "save_model_tree",
]
