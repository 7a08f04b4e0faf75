from .compose import compose, compose_dict, DEFAULT_CONFIG_PATH
from .schema import (
    ConfigError,
    CyclicTrainingConfig,
    DatasetConfig,
    ExperimentConfig,
    MainConfig,
    ModelConfig,
    OptimizerConfig,
    PruneConfig,
    ResumeExperimentConfig,
    config_from_dict,
    config_to_dict,
)

__all__ = [
    "compose",
    "compose_dict",
    "DEFAULT_CONFIG_PATH",
    "ConfigError",
    "MainConfig",
    "DatasetConfig",
    "ModelConfig",
    "PruneConfig",
    "ExperimentConfig",
    "OptimizerConfig",
    "CyclicTrainingConfig",
    "ResumeExperimentConfig",
    "config_from_dict",
    "config_to_dict",
]
