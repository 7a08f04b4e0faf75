"""Optional wandb channel (port of ``turboprune_tpu/utils/wandb_logging.py``).

With ``experiment_params.use_wandb`` set, the run's rank 0 opens a wandb
run (project ``experiment_params.wandb_project_name``, named after the
experiment's prefix, the whole config attached, files under the
experiment dir), logs every epoch row the harness writes to its CSV, and
closes it when the driver's level loop ends. Where ``wandb`` does not
import (neither this repo's test machine nor the card's has it) or its
``init`` fails, the run goes on without it and says so once:
``[wandb] disabled (...)``. The knob off, nothing is imported.
"""

from __future__ import annotations

from ..config.schema import MainConfig, config_to_dict
from ..parallel.multihost import is_primary


class WandbRun:
    """A no-op unless ``use_wandb`` is set, this is rank 0 and wandb
    imports and starts."""

    def __init__(self, cfg: MainConfig, prefix: str, expt_dir: str):
        self._run = None
        if not cfg.experiment_params.use_wandb or not is_primary():
            return
        try:
            import wandb

            self._run = wandb.init(
                project=cfg.experiment_params.wandb_project_name,
                name=prefix,
                config=config_to_dict(cfg),
                dir=expt_dir,
            )
        except Exception as e:  # no wandb, or no way to reach its service
            print(f"[wandb] disabled ({e})", flush=True)

    def log(self, metrics: dict) -> None:
        if self._run is not None:
            self._run.log(metrics)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None
