from .checkpoint import (
    MODEL_INIT,
    MODEL_REWIND,
    OPTIMIZER_INIT,
    OPTIMIZER_REWIND,
    ExperimentCheckpoints,
    model_state_dict,
    reset_weights,
    restore_model_tree,
    save_model_tree,
)
from .device import resolve_device
from .experiment import (
    MetricsLogger,
    display_training_info,
    expt_prefix,
    gen_expt_dir,
    load_config,
    resume_experiment,
    save_config,
    set_seed,
)

__all__ = [
    "MODEL_INIT",
    "MODEL_REWIND",
    "OPTIMIZER_INIT",
    "OPTIMIZER_REWIND",
    "ExperimentCheckpoints",
    "MetricsLogger",
    "display_training_info",
    "expt_prefix",
    "gen_expt_dir",
    "load_config",
    "model_state_dict",
    "reset_weights",
    "resolve_device",
    "restore_model_tree",
    "resume_experiment",
    "save_config",
    "save_model_tree",
    "set_seed",
]
