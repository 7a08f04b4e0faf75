"""Experiment config snapshots (port of ``save_config`` in
``turboprune_tpu/utils/experiment.py``).

An experiment dir carries ``expt_config.yaml``, the composed config it was
trained under; serving reads it back so a checkpoint is never paired with
the wrong architecture. The CSV metric channels and directory naming come
with the training slice.
"""

from __future__ import annotations

from pathlib import Path

import yaml

from ..config.schema import MainConfig, config_from_dict, config_to_dict

CONFIG_FILE = "expt_config.yaml"


def save_config(expt_dir: str | Path, cfg: MainConfig) -> Path:
    out = Path(expt_dir) / CONFIG_FILE
    with open(out, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)
    return out


def load_config(expt_dir: str | Path) -> MainConfig:
    path = Path(expt_dir) / CONFIG_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found — is {expt_dir} an experiment dir?"
        )
    return config_from_dict(yaml.safe_load(path.read_text()))
