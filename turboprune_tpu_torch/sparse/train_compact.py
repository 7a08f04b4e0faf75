"""Compact-as-you-train: slice the whole train state, not just the params
(port of ``turboprune_tpu/sparse/train_compact.py``).

``compact_params`` (compact.py) serves evaluation: masks are folded and
there is no optimizer. Training a physically smaller model needs more:

  - params stay raw (they keep moving) and the sliced masks ride along, so
    the small step's masked forward pins scattered zeros inside kept
    channels exactly as the dense run does;
  - the optimizer's per-parameter state (SGD's ``momentum_buffer``, absent
    before the first step; AdamW's ``exp_avg``/``exp_avg_sq`` and its
    ``step``) is sliced with the same keep vectors. A small model has new
    ``Parameter`` objects, so the sliced state goes into a fresh optimizer
    over them (``Optimizer.load_state_dict``);
  - BatchNorm running statistics (the model's buffers) slice along
    stats_keep;
  - and the round trip is exact: ``expand_train_state`` scatters the
    trained small state back into full coordinates, so weight rewind, the
    next level's global magnitude threshold and checkpoints never learn
    that the level ran small.

An optimizer ``state_dict`` keys its state by parameter index, in
``named_parameters`` order, which a model built at other widths (or with
the N:M modules, which keep their dense counterparts' names) shares. A
tensor of that state whose sliced axes do not have the parameter's sizes
raises: an optimizer state this module does not understand is not sliced
blindly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..train.state import TrainState
from .compact import CompactionPlan, _expand_leaf, _slice_leaf, scatter_into
from .graph import PathT, flax_path, model_leaves, state_key


# The plan of an N:M-only level: every width kept, nothing sliced.
_IDENTITY = CompactionPlan({}, {}, {}, {}, {}, {})


def param_paths(model: nn.Module) -> list[PathT]:
    """The flax path of each parameter, in the optimizer's index order."""
    return [flax_path(k, p.dim()) for k, p in model.named_parameters()]


def _map_opt_state(opt_state: dict, plan: CompactionPlan, paths: list[PathT],
                   expand: bool) -> dict:
    """Slice (or expand with zeros) every parameter-shaped tensor of an
    optimizer ``state_dict``; everything else is copied as it is."""
    state = {}
    for idx, entry in opt_state["state"].items():
        path = paths[idx]
        ik, ok = plan.in_keep.get(path), plan.out_keep.get(path)
        new = {}
        for name, v in entry.items():
            if not isinstance(v, torch.Tensor) or v.dim() == 0 or (ik is None and ok is None):
                new[name] = v.clone() if isinstance(v, torch.Tensor) else v
                continue
            want_in = None if ik is None else (int(ik.sum()) if expand else ik.size)
            want_out = None if ok is None else (int(ok.sum()) if expand else ok.size)
            if (want_in is not None and (v.dim() < 2 or v.shape[1] != want_in)) or (
                want_out is not None and v.shape[0] != want_out
            ):
                raise ValueError(
                    f"optimizer state {name!r} of {path} has shape {tuple(v.shape)}, "
                    "not its parameter's — unrecognised optimizer state layout; "
                    "refusing to slice it blindly"
                )
            new[name] = _expand_leaf(v, ik, ok) if expand else _slice_leaf(v, ik, ok)
        state[idx] = new
    return {"state": state, "param_groups": opt_state["param_groups"]}


def slice_opt_state(opt_state: dict, plan: CompactionPlan, paths: list[PathT]) -> dict:
    """Slice momentum and Adam moments with the plan; scalars (Adam's
    ``step``) pass through. ``paths``: ``param_paths`` of the full model."""
    return _map_opt_state(opt_state, plan, paths, expand=False)


def expand_opt_state(opt_state: dict, plan: CompactionPlan, paths: list[PathT]) -> dict:
    """Inverse: removed coordinates come back as zero moments — what a
    fresh per-level optimizer gives them, and (with zero data gradient at
    fully masked coordinates) what the dense run holds when weight decay
    is off."""
    return _map_opt_state(opt_state, plan, paths, expand=True)


def compact_train_state(
    state: TrainState,
    plan: Optional[CompactionPlan],
    small_model: nn.Module,
    make_optimizer: Callable,
) -> TrainState:
    """The level's train state on ``small_model`` (built at the plan's
    widths, with or without N:M hooks): the sliced raw params and
    statistics copied into it, the sliced masks, a fresh optimizer over its
    parameters holding the sliced optimizer state, the same step. With
    ``plan`` None the widths are the full ones (an N:M-only plan swaps
    modules, not widths) and everything is copied as it is."""
    plan = plan or _IDENTITY
    params, stats = model_leaves(state.model)
    params = {p: _slice_leaf(t, plan.in_keep.get(p), plan.out_keep.get(p))
              for p, t in params.items()}
    stats = {p: _slice_leaf(t, None, plan.stats_keep.get(p)) for p, t in stats.items()}
    masks = {p: _slice_leaf(m, plan.in_keep.get(p), plan.out_keep.get(p))
             for p, m in state.masks.items()}
    opt_state = slice_opt_state(state.optimizer.state_dict(), plan, param_paths(state.model))
    small_model.load_state_dict({state_key(p): t for p, t in {**params, **stats}.items()})
    optimizer = make_optimizer(small_model.parameters())
    optimizer.load_state_dict(opt_state)
    return TrainState(small_model, masks, optimizer, state.step)


@torch.no_grad()
def expand_train_state(
    state: TrainState, plan: Optional[CompactionPlan], anchor: TrainState
) -> TrainState:
    """Scatter a trained small state back into ``anchor``, the full state
    the level entered with, in place:

      - params: kept coordinates take the trained values; removed ones
        keep the anchor's (a removed channel's consumer in-rows hold real
        magnitudes that the next level's global top-k must still see);
      - masks: the anchor's (masks never change inside a level);
      - batch_stats: kept entries trained, removed entries anchored (a
        removed channel's residue stays the zero it was proven to be);
      - optimizer: the anchor's optimizer takes the expanded state, zeros
        at removed coordinates (``expand_opt_state``).

    Returns the full TrainState (the anchor's model, masks and optimizer,
    the small state's step). Calling it again later in the level (for a
    checkpoint) and at the level's end gives the same full state."""
    small_params, small_stats = model_leaves(state.model)
    full_params, full_stats = model_leaves(anchor.model)
    plan = plan or _IDENTITY
    for path, dst in full_params.items():
        scatter_into(dst, small_params[path], plan.in_keep.get(path), plan.out_keep.get(path))
    for path, dst in full_stats.items():
        scatter_into(dst, small_stats[path], None, plan.stats_keep.get(path))
    anchor.optimizer.load_state_dict(
        expand_opt_state(state.optimizer.state_dict(), plan, param_paths(anchor.model)))
    return TrainState(anchor.model, anchor.masks, anchor.optimizer, state.step)


def width_signature(plan: CompactionPlan) -> list:
    """JSON-serialisable width signature."""
    return sorted([str(k), int(v)] for k, v in dict(plan.width_overrides).items())


__all__ = [
    "compact_train_state",
    "expand_opt_state",
    "expand_train_state",
    "param_paths",
    "slice_opt_state",
    "width_signature",
]
