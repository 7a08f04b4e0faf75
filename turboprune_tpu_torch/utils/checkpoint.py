"""Experiment checkpoints with the reference's artifact roles (port of
``turboprune_tpu/utils/checkpoint.py``).

Layout under an experiment dir, as in the JAX package:

  checkpoints/model_init          level-0 starting weights (imp rewind target)
  checkpoints/model_rewind        weights at rewind_epoch of level 0 (wr target)
  artifacts/optimizer_init        optimizer state at level 0 start
  artifacts/optimizer_rewind      optimizer state at rewind_epoch
  checkpoints/model_level_{L}     end-of-level weights (next level's input)

A model checkpoint is the tree ``{"params": {name: parameter}, "masks":
{flax path: bool tensor}, "batch_stats": {name: buffer}}`` (the BatchNorm
running statistics are the buffers; ``model_state_dict`` joins the two); an optimizer checkpoint is the
torch optimizer's ``state_dict``. The port's own format: each role is a
directory holding ``model.pt`` or ``optimizer.pt`` written by ``torch.save``
and read with ``weights_only=True`` (tensors and plain containers only,
nothing unpickled that could run code). The JAX package's Orbax checkpoints
are not read here; ``bridge.py`` converts weights between the two. The
mid-level (epoch-granular) slot is a later slice (ROADMAP.md queue A,
item 6).

Rewind (``reset_weights``): imp -> params and batch_stats from
model_init, wr -> from model_rewind, lrr / at_init -> keep the trained
weights; masks are never restored, so the freshly pruned masks survive a
rewind.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path

import torch

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"

MODEL_INIT = "model_init"
MODEL_REWIND = "model_rewind"
OPTIMIZER_INIT = "optimizer_init"
OPTIMIZER_REWIND = "optimizer_rewind"

_LEVEL_RE = re.compile(r"^model_level_(\d+)$")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    return tree


def _save(path: Path, name: str, tree: dict) -> None:
    """Write ``tree`` as ``<path>/<name>``, atomically: a reader never sees
    a half-written file."""
    path.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=path)
    os.close(fd)
    try:
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, path / name)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _restore(path: Path, name: str) -> dict:
    f = path / name
    if not f.exists():
        raise FileNotFoundError(f"{f} does not exist (not a port checkpoint?)")
    return torch.load(f, map_location="cpu", weights_only=True)


def model_state_dict(tree: dict) -> dict:
    """The ``state_dict`` of a model checkpoint tree: its params and its
    batch_stats."""
    return {**tree["params"], **tree["batch_stats"]}


def save_model_tree(path: str | Path, tree: dict) -> None:
    """Write ``tree`` (dicts of tensors) as ``<path>/model.pt``."""
    _save(Path(path), MODEL_FILE, tree)


def restore_model_tree(path: str | Path) -> dict:
    """Read ``<path>/model.pt`` onto the CPU, tensors and containers only."""
    return _restore(Path(path), MODEL_FILE)


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

    def optimizer_path(self, role: str) -> Path:
        return self.artifacts_dir / role

    def level_path(self, level: int) -> Path:
        return self.checkpoints_dir / f"model_level_{level}"

    def save_model(self, role: str, tree: dict) -> None:
        save_model_tree(self.model_path(role), tree)

    def load_model(self, role: str) -> dict:
        return restore_model_tree(self.model_path(role))

    def has_model(self, role: str) -> bool:
        return (self.model_path(role) / MODEL_FILE).exists()

    def save_level(self, level: int, tree: dict) -> None:
        save_model_tree(self.level_path(level), tree)

    def load_level(self, level: int) -> dict:
        return restore_model_tree(self.level_path(level))

    def save_optimizer(self, role: str, optimizer: torch.optim.Optimizer) -> None:
        _save(self.optimizer_path(role), OPTIMIZER_FILE, optimizer.state_dict())

    def load_optimizer(self, role: str) -> dict:
        """The optimizer ``state_dict`` saved under ``role``, on the CPU
        (``Optimizer.load_state_dict`` moves it to the params' device)."""
        return _restore(self.optimizer_path(role), OPTIMIZER_FILE)

    def saved_levels(self) -> list[int]:
        out = []
        for p in self.checkpoints_dir.iterdir():
            m = _LEVEL_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)


def reset_weights(training_type: str, state, ckpts: ExperimentCheckpoints):
    """Post-prune rewind: restore the params and batch_stats of the role's
    checkpoint into ``state`` (a ``train.TrainState``) and KEEP its
    just-pruned masks.

      imp      -> model_init
      wr       -> model_rewind
      lrr      -> no-op (learning-rate rewinding keeps trained weights)
      at_init  -> no-op (PaI never rewinds)
    """
    role = {"imp": MODEL_INIT, "wr": MODEL_REWIND}.get(training_type)
    if role is not None:
        state.model.load_state_dict(model_state_dict(ckpts.load_model(role)))
    return state
