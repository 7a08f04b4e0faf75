"""Experiment management: directories, seeds, config snapshots, metrics
(port of ``turboprune_tpu/utils/experiment.py``).

An experiment dir carries ``expt_config.yaml``, the composed config it was
trained under; serving reads it back so a checkpoint is never paired with
the wrong architecture. The metric channels are the reference's CSVs,
written with the ``csv`` module (no pandas on the card's machine).
``resume_experiment`` reopens an experiment dir at a level;
``config_fingerprint`` stamps the mid-level slot with the config it was
trained under (the same string as the JAX package's for the same config).
In a data-parallel run the driver calls ``gen_expt_dir``,
``resume_experiment`` and ``save_config`` on the primary only and
broadcasts the directory; ``MetricsLogger`` keeps its rows on every rank
(they hold the all-reduced global numbers) and writes on the primary.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import random
import uuid
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from ..config.schema import MainConfig, config_from_dict, config_to_dict
from ..parallel.multihost import is_primary

CONFIG_FILE = "expt_config.yaml"
SUBDIRS = ("checkpoints", "metrics", "metrics/level_wise_metrics", "artifacts")


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


def expt_prefix(cfg: MainConfig) -> str:
    """Config-encoding experiment name, as the JAX package spells it."""
    pp = cfg.pruning_params
    parts = [
        cfg.dataset_params.dataset_name.lower(),
        cfg.model_params.model_name,
        pp.prune_method.replace(" ", "_"),
        pp.training_type,
        f"sp{pp.target_sparsity:g}",
        f"seed{cfg.experiment_params.seed}",
    ]
    if cfg.cyclic_training.num_cycles > 1:
        parts.append(f"cyc{cfg.cyclic_training.num_cycles}")
    return "_".join(parts)


def gen_expt_dir(cfg: MainConfig) -> tuple[str, str]:
    """(prefix, expt_dir) under ``experiment_params.base_dir``; creates the
    fixed subdir layout."""
    prefix = expt_prefix(cfg)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    unique = f"{prefix}__{stamp}_{uuid.uuid4().hex[:8]}"
    expt_dir = Path(cfg.experiment_params.base_dir) / unique
    for sub in SUBDIRS:
        (expt_dir / sub).mkdir(parents=True, exist_ok=True)
    return prefix, str(expt_dir)


def resume_experiment(cfg: MainConfig) -> tuple[str, str, int]:
    """(prefix, expt_dir, resume_level) of the existing experiment dir
    ``experiment_params.resume_experiment_stuff.resume_expt_name`` under
    ``base_dir``; re-creates its subdirs. Training continues at
    ``resume_level`` from ``model_level_{resume_level - 1}``."""
    stuff = cfg.experiment_params.resume_experiment_stuff
    if stuff is None or not stuff.resume_expt_name:
        raise ValueError(
            "resume_experiment=true requires "
            "experiment_params.resume_experiment_stuff.resume_expt_name"
        )
    expt_dir = Path(cfg.experiment_params.base_dir) / stuff.resume_expt_name
    if not expt_dir.exists():
        raise FileNotFoundError(f"cannot resume: {expt_dir} does not exist")
    for sub in SUBDIRS:
        (expt_dir / sub).mkdir(parents=True, exist_ok=True)
    prefix = stuff.resume_expt_name.split("__")[0]
    return prefix, str(expt_dir), stuff.resume_level


def config_fingerprint(cfg: MainConfig) -> str:
    """16 hex digits of the sha256 of the training-relevant config (sorted
    JSON of ``config_to_dict``). The resume knobs and the serve group are
    left out: a resumed run flips ``resume_experiment`` and must still
    match its own slot, and serving knobs do not touch training."""
    d = config_to_dict(cfg)
    ep = d.get("experiment_params") or {}
    ep.pop("resume_experiment", None)
    ep.pop("resume_experiment_stuff", None)
    d.pop("serve", None)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness (init, shuffle, flip, crop) uses explicit generators; this
    covers anything else."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class MetricsLogger:
    """The reference's CSV metric channels: per-level
    ``metrics/level_wise_metrics/level_{L}_metrics.csv`` rows of
    epoch/train/test stats, plus an append-mode
    ``metrics/{prefix}_summary.csv`` with one row per level."""

    def __init__(self, expt_dir: str, prefix: str):
        self.expt_dir = Path(expt_dir)
        self.prefix = prefix
        self.level_rows: list[dict] = []

    def log_epoch(self, row: dict) -> None:
        self.level_rows.append(dict(row))

    def finish_level(self, level: int, summary_extra: Optional[dict] = None) -> dict:
        """Write the level CSV, append the summary row, reset the buffer;
        returns the summary (the last epoch's row, the level's best test
        accuracy, ``summary_extra``)."""
        rows = self.level_rows
        summary = dict(rows[-1]) if rows else {}
        if rows and "test_acc" in rows[0]:
            summary["max_test_acc"] = max(float(r["test_acc"]) for r in rows)
        summary["level"] = level
        summary.update(summary_extra or {})
        self.level_rows = []
        if is_primary():
            self._write(level, rows, summary)
        return summary

    def _write(self, level: int, rows: list, summary: dict) -> None:
        level_dir = self.expt_dir / "metrics" / "level_wise_metrics"
        level_dir.mkdir(parents=True, exist_ok=True)
        columns = list(dict.fromkeys(k for r in rows for k in r))
        with open(level_dir / f"level_{level}_metrics.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(rows)
        summary_path = self.expt_dir / "metrics" / f"{self.prefix}_summary.csv"
        new_file = not summary_path.exists()
        with open(summary_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(summary))
            if new_file:
                writer.writeheader()
            writer.writerow(summary)


def display_training_info(cfg: MainConfig, level: int, density: float) -> None:
    """The level's header and its config knobs, as plain prints (on the
    primary)."""
    if not is_primary():
        return
    print(f"[level {level}] density={density:.4f}", flush=True)
    for section in ("dataset_params", "model_params", "pruning_params", "optimizer_params"):
        knobs = config_to_dict(cfg)[section]
        print(f"  {section}: " + ", ".join(f"{k}={v}" for k, v in knobs.items()), flush=True)
