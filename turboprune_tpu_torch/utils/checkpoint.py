"""Experiment checkpoints with the reference's artifact roles (port of
``turboprune_tpu/utils/checkpoint.py``).

Layout under an experiment dir, as in the JAX package:

  checkpoints/model_init          level-0 starting weights (imp rewind target)
  checkpoints/model_rewind        weights at rewind_epoch of level 0 (wr target)
  artifacts/optimizer_init        optimizer state at level 0 start
  artifacts/optimizer_rewind      optimizer state at rewind_epoch
  checkpoints/model_level_{L}     end-of-level weights (next level's input)
  checkpoints/mid_level           the full train state at an epoch inside a
                                  level, and its header mid_level_meta.json
  checkpoints/mid_level_stream_P  process P's train-stream position at that
                                  save (stream-position loaders)

A model checkpoint is the tree ``{"params": {name: parameter}, "masks":
{flax path: bool tensor}, "batch_stats": {name: buffer}}`` (the BatchNorm
running statistics are the buffers; ``model_state_dict`` joins the two); an
optimizer checkpoint is the torch optimizer's ``state_dict``. The port's
own format: each role is a directory holding ``model.pt`` or
``optimizer.pt`` written by ``torch.save`` and read with
``weights_only=True`` (tensors and plain containers only, nothing
unpickled that could run code). The JAX package's Orbax checkpoints are not
read here; ``bridge.py`` converts weights between the two.

On disk the masks are bit-packed, as in the JAX package: each mask becomes
``{"bits": uint8[ceil(n/8)], "shape": int64[ndim]}`` under
``masks_packed``, 8x smaller than one byte per weight. Checkpoints written
with raw bool ``masks`` still load: the layout is read from the loaded
tree's keys.

In a data-parallel run the state is replicated: every write of
``ExperimentCheckpoints`` (model and level trees, optimizer state, the
mid-level slot and its header, clearing the slot) happens on the primary
only and is followed by ``sync_hosts``, so no rank reads before the file
is there; every rank reads. The one exception is a train stream's
position, which is each rank's own: every rank writes its
``mid_level_stream_<rank>``.

Rewind (``reset_weights``): imp -> params and batch_stats from
model_init, wr -> from model_rewind, lrr / at_init -> keep the trained
weights; masks are never restored, so the freshly pruned masks survive a
rewind.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..parallel.multihost import is_primary, sync_hosts

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"

MODEL_INIT = "model_init"
MODEL_REWIND = "model_rewind"
OPTIMIZER_INIT = "optimizer_init"
OPTIMIZER_REWIND = "optimizer_rewind"
MID_LEVEL = "mid_level"

MASKS_KEY = "masks"
MASKS_PACKED_KEY = "masks_packed"

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


def pack_mask_tree(masks: dict) -> dict:
    """bool masks -> ``{"bits": uint8[ceil(n/8)], "shape": int64[ndim]}``
    each, packed by ``np.packbits`` on the host (the JAX package's bytes)."""
    out = {}
    for path, m in masks.items():
        arr = m.detach().cpu().numpy().astype(bool)
        out[path] = {
            "bits": torch.from_numpy(np.packbits(arr.reshape(-1))),
            "shape": torch.tensor(arr.shape, dtype=torch.int64),
        }
    return out


def unpack_mask_tree(packed: dict) -> dict:
    """Inverse of ``pack_mask_tree``: bool tensors on the CPU."""
    out = {}
    for path, leaf in packed.items():
        shape = tuple(int(s) for s in leaf["shape"])
        n = int(np.prod(shape)) if shape else 1
        bits = np.unpackbits(leaf["bits"].numpy(), count=n)
        out[path] = torch.from_numpy(bits.astype(bool).reshape(shape))
    return out


def save_model_tree(path: str | Path, tree: dict) -> None:
    """Write ``tree`` (dicts of tensors, with ``masks``) as
    ``<path>/model.pt``, the masks bit-packed under ``masks_packed``."""
    out = dict(tree)
    out[MASKS_PACKED_KEY] = pack_mask_tree(out.pop(MASKS_KEY))
    _save(Path(path), MODEL_FILE, out)


def restore_model_tree(path: str | Path) -> dict:
    """Read ``<path>/model.pt`` onto the CPU, tensors and containers only,
    with the masks unpacked (or as written, in a raw-bool checkpoint)."""
    tree = _restore(Path(path), MODEL_FILE)
    if MASKS_PACKED_KEY in tree:
        tree[MASKS_KEY] = unpack_mask_tree(tree.pop(MASKS_PACKED_KEY))
    return tree


def _primary_writes(fn):
    """``fn`` on the primary only, then a barrier every rank meets."""

    def write(self, *args, **kwargs):
        if is_primary():
            fn(self, *args, **kwargs)
        sync_hosts(f"checkpoint:{fn.__name__}")

    write.__name__, write.__doc__ = fn.__name__, fn.__doc__
    return write


class ExperimentCheckpoints:
    """Role-addressed checkpoints under an experiment directory."""

    def __init__(self, expt_dir: str | Path):
        self.expt_dir = Path(expt_dir)
        self.checkpoints_dir = self.expt_dir / "checkpoints"
        self.artifacts_dir = self.expt_dir / "artifacts"
        self._make_dirs()

    @_primary_writes
    def _make_dirs(self) -> None:
        self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
        self.artifacts_dir.mkdir(parents=True, exist_ok=True)

    def model_path(self, role: str) -> Path:
        return self.checkpoints_dir / role

    def optimizer_path(self, role: str) -> Path:
        return self.artifacts_dir / role

    def level_path(self, level: int) -> Path:
        return self.checkpoints_dir / f"model_level_{level}"

    @_primary_writes
    def save_model(self, role: str, tree: dict) -> None:
        save_model_tree(self.model_path(role), tree)

    def load_model(self, role: str) -> dict:
        return restore_model_tree(self.model_path(role))

    def has_model(self, role: str) -> bool:
        return (self.model_path(role) / MODEL_FILE).exists()

    def has_level(self, level: int) -> bool:
        return (self.level_path(level) / MODEL_FILE).exists()

    @_primary_writes
    def save_level(self, level: int, tree: dict) -> None:
        save_model_tree(self.level_path(level), tree)

    def load_level(self, level: int) -> dict:
        return restore_model_tree(self.level_path(level))

    @_primary_writes
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

    # --- the mid-level slot -----------------------------------------------
    # One slot holds the full train state at the end of an epoch inside a
    # level (params, batch_stats, masks, the optimizer's state, the step
    # counter the schedule reads), and a small JSON header that is read
    # without loading the state. A preempted level re-enters at the next
    # epoch instead of replaying from its start.

    def mid_level_path(self) -> Path:
        return self.checkpoints_dir / MID_LEVEL

    def _mid_level_meta_path(self) -> Path:
        return self.checkpoints_dir / "mid_level_meta.json"

    @_primary_writes
    def save_mid_level(self, level: int, epoch: int, state, meta: dict) -> None:
        """Write the slot for (level, epoch) from ``state`` (a
        ``train.TrainState``), then its header {level, epoch, **meta}.
        The (level, epoch) tag goes into both, the tree first: a preemption
        between the two writes leaves them disagreeing, which
        ``load_mid_level`` detects."""
        tag = level * 1_000_000 + epoch
        save_model_tree(
            self.mid_level_path(),
            {
                **state.model_tree(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step,
                "tag": tag,
            },
        )
        p = self._mid_level_meta_path()
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps({"level": level, "epoch": epoch, **meta}))
        os.replace(tmp, p)

    def peek_mid_level(self) -> Optional[dict]:
        """The header, or None; loads no state. The header may be one save
        older than the tree: ``load_mid_level`` decides."""
        p = self._mid_level_meta_path()
        if not p.exists() or not (self.mid_level_path() / MODEL_FILE).exists():
            return None
        try:
            return json.loads(p.read_text())
        except (ValueError, OSError):
            return None

    def load_mid_level(self, expect_level: int, expect_epoch: int) -> Optional[dict]:
        """The slot's tree (params, masks, batch_stats, optimizer, step) on
        the CPU, or None when its tag is not (expect_level, expect_epoch):
        a torn save, after which the level is replayed from its start."""
        restored = restore_model_tree(self.mid_level_path())
        if int(restored.pop("tag")) != expect_level * 1_000_000 + expect_epoch:
            return None
        return restored

    # A stream-position loader's state (the ImageFolder loader) goes in a
    # file of its own per process, written by that process (no barrier:
    # the slot's save that follows has one), prefixed by an 8-byte (level, epoch)
    # tag: a preemption between the state's save and the stream's write
    # cannot pair a stale stream with a newer state (the tag disagrees and
    # the loader takes a fresh pass instead).

    def _mid_level_stream_path(self, pid: int) -> Path:
        return self.checkpoints_dir / f"mid_level_stream_{pid}"

    def save_mid_level_stream(self, level: int, epoch: int, blob: bytes, pid: int) -> None:
        tag = (level * 1_000_000 + epoch).to_bytes(8, "big")
        p = self._mid_level_stream_path(pid)
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(tag + blob)
        os.replace(tmp, p)

    def load_mid_level_stream(self, level: int, epoch: int, pid: int) -> Optional[bytes]:
        """The blob, or None when absent or tagged for another save."""
        p = self._mid_level_stream_path(pid)
        if not p.exists():
            return None
        raw = p.read_bytes()
        if len(raw) < 8 or int.from_bytes(raw[:8], "big") != level * 1_000_000 + epoch:
            return None
        return raw[8:]

    @_primary_writes
    def clear_mid_level(self) -> None:
        """Drop the slot and its stream files. Levels run in ascending
        order, so a slot of another level belongs to an abandoned
        trajectory."""
        self._mid_level_meta_path().unlink(missing_ok=True)
        if self.mid_level_path().exists():
            shutil.rmtree(self.mid_level_path())
        for p in self.checkpoints_dir.glob("mid_level_stream_*"):
            p.unlink(missing_ok=True)


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
