"""Experiment checkpoints with the reference's artifact roles (port of the
model roles of ``turboprune_tpu/utils/checkpoint.py``).

Layout under an experiment dir, as in the JAX package:

  checkpoints/model_init          level-0 starting weights
  checkpoints/model_rewind        weights at rewind_epoch of level 0
  checkpoints/model_level_{L}     end-of-level weights

A model checkpoint is the tree ``{"params": state_dict, "masks": {flax
path: bool tensor}, "batch_stats": {...}}``. The port's own format: each
role is a directory holding ``model.pt`` written by ``torch.save`` and read
with ``weights_only=True`` (tensors and plain containers only, nothing
unpickled that could run code). The JAX package's Orbax checkpoints are not
read here; ``bridge.py`` converts weights between the two.
The optimizer roles and the mid-level slot come with the training slice.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path

import torch

MODEL_FILE = "model.pt"

_LEVEL_RE = re.compile(r"^model_level_(\d+)$")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    return tree


def save_model_tree(path: str | Path, tree: dict) -> None:
    """Write ``tree`` (dicts of tensors) as ``<path>/model.pt``, atomically:
    a reader never sees a half-written file."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=path)
    os.close(fd)
    try:
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, path / MODEL_FILE)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_model_tree(path: str | Path) -> dict:
    """Read ``<path>/model.pt`` onto the CPU, tensors and containers only."""
    f = Path(path) / MODEL_FILE
    if not f.exists():
        raise FileNotFoundError(f"{f} does not exist (not a port checkpoint?)")
    return torch.load(f, map_location="cpu", weights_only=True)


class ExperimentCheckpoints:
    """Role-addressed checkpoints under an experiment directory."""

    def __init__(self, expt_dir: str | Path):
        self.expt_dir = Path(expt_dir)
        self.checkpoints_dir = self.expt_dir / "checkpoints"
        self.artifacts_dir = self.expt_dir / "artifacts"
        self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
        self.artifacts_dir.mkdir(parents=True, exist_ok=True)

    def model_path(self, role: str) -> Path:
        return self.checkpoints_dir / role

    def level_path(self, level: int) -> Path:
        return self.checkpoints_dir / f"model_level_{level}"

    def save_model(self, role: str, tree: dict) -> None:
        save_model_tree(self.model_path(role), tree)

    def save_level(self, level: int, tree: dict) -> None:
        save_model_tree(self.level_path(level), tree)

    def saved_levels(self) -> list[int]:
        out = []
        for p in self.checkpoints_dir.iterdir():
            m = _LEVEL_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)
