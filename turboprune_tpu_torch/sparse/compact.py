"""Dead-channel compaction: flat param dicts -> smaller dicts, numerically
faithful (port of ``turboprune_tpu/sparse/compact.py``).

``compact_params`` takes the training representation (raw params and the
bool mask dict, both keyed by flax path, graph.py) and a propagation graph
and returns physically smaller tensors plus the per-space channel widths
that re-instantiate the model (``models.create_model(...,
width_overrides=...)``).

Equivalence with the masked-dense forward, up to fp reassociation:

  1. Masks are folded first (``w * m`` is exact), so scattered zeros inside
     kept channels stay zeros in the compacted tensors.
  2. A channel is removed only when (a) its producer's fan-out mask slice
     is all zero, and (b) its post-activation residue is exactly zero at
     every consumer. (b) matters because a dead conv channel still emits
     relu(bn(0)), a per-channel constant that is nonzero whenever the BN
     bias/statistics make it so: such a channel is kept and counted in the
     report (``blocked_residue``). Residues are evaluated in float64 from
     the fp32 leaves, as the JAX package does, so the decisions are equal.
  3. What remains is the same arithmetic with the zero terms of the
     reductions removed.

A space whose every channel is removable would re-instantiate as a
zero-width layer: CompactionError instead.

Keep vectors are numpy bools on the host; slicing and scattering run on
the tensors' own device (``index_select`` and indexed writes), in the
torch layout: in-axis 1, out-axis 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from .graph import CompactionError, PathT, PropagationGraph, _get

_ERF = np.vectorize(math.erf)

Tree = Mapping[PathT, Optional[torch.Tensor]]


@dataclass
class CompactionResult:
    params: dict                      # compacted, mask-folded params
    batch_stats: dict                 # compacted BatchNorm running stats
    width_overrides: dict             # space override_key -> kept channels
    report: dict

    def as_override_tuple(self) -> tuple:
        """Hashable form for cache keys."""
        return tuple(sorted(self.width_overrides.items()))


@dataclass
class CompactionPlan:
    """Which coordinates survive. Compact-as-you-train keeps one alive for
    a whole level so params, masks, batch_stats and optimizer moments are
    all sliced (and later expanded) with the same keep vectors, which is
    what makes the round trip exact."""

    keeps: dict[str, np.ndarray]              # space name -> channel keep
    out_keep: dict[PathT, np.ndarray]         # leaf path -> out-axis keep
    in_keep: dict[PathT, np.ndarray]          # kernel path -> in-axis keep
    stats_keep: dict[PathT, np.ndarray]       # BN stats leaf -> keep
    width_overrides: dict                     # override_key -> kept channels
    report: dict

    def as_override_tuple(self) -> tuple:
        """Hashable form for cache keys."""
        return tuple(sorted(self.width_overrides.items()))

    def savings(self) -> float:
        """Fraction of parameters removed by slicing (0 = identity)."""
        before = self.report["params_before"]
        return 1.0 - self.report["params_after"] / max(before, 1)


# ------------------------------------------------------------------ helpers
def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _apply_gate(gate, v: np.ndarray, params: Tree, batch_stats: Tree) -> np.ndarray:
    """Run a per-channel op chain on a float64 residue vector."""
    for op in gate:
        if op[0] == "bn":
            _, module, eps = op
            scale = _np64(_get(params, f"{module}/scale"))
            bias = _np64(_get(params, f"{module}/bias"))
            mean = _np64(_get(batch_stats, f"{module}/mean"))
            var = _np64(_get(batch_stats, f"{module}/var"))
            v = scale * (v - mean) / np.sqrt(var + eps) + bias
        elif op[0] == "relu":
            v = np.maximum(v, 0.0)
        elif op[0] == "gelu":
            v = 0.5 * v * (1.0 + _ERF(v / math.sqrt(2.0)))
        else:  # pragma: no cover - the graph builders emit only these three
            raise CompactionError(f"unknown gate op {op!r}")
    return v


def _index(keep: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.flatnonzero(keep)).to(device)


def _slice_leaf(t: torch.Tensor, ik, ok) -> torch.Tensor:
    if ik is not None:
        t = t.index_select(1, _index(ik, t.device))
    if ok is not None:
        t = t.index_select(0, _index(ok, t.device))
    return t


def scatter_into(dst: torch.Tensor, src: torch.Tensor, ik, ok) -> None:
    """Write the sliced ``src`` into its coordinates of the full ``dst``,
    in place; the removed coordinates of ``dst`` stay as they are (with
    no keep vector, all of ``dst`` is written)."""
    src = src.to(dst.device, dst.dtype)
    if ik is None and ok is None:
        dst.copy_(src)
    elif ik is not None and ok is not None:
        rows = _index(ok, dst.device)
        cols = _index(ik, dst.device)
        dst[rows[:, None], cols[None, :]] = src
    elif ik is not None:
        dst[:, _index(ik, dst.device)] = src
    else:
        dst[_index(ok, dst.device)] = src


def _expand_leaf(t: torch.Tensor, ik, ok, base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter a sliced leaf back into full coordinates. Removed
    coordinates come from ``base`` (a full-coordinate anchor) when given,
    else zeros (False for bool masks)."""
    if ik is None and ok is None:
        return t  # a leaf the plan does not touch: trained values win
    shape = list(t.shape)
    if ik is not None:
        shape[1] = int(ik.size)
    if ok is not None:
        shape[0] = int(ok.size)
    if base is not None:
        if list(base.shape) != shape:
            raise ValueError(f"expand anchor shape {tuple(base.shape)} != full shape {tuple(shape)}")
        out = base.detach().to(t.device).clone()
    else:
        out = t.new_zeros(shape)
    scatter_into(out, t, ik, ok)
    return out


# ----------------------------------------------------------------- analysis
def analyze_masks(
    params: Tree,
    masks: Tree,
    graph: PropagationGraph,
    batch_stats: Optional[Tree] = None,
) -> tuple[dict[str, np.ndarray], dict]:
    """Per-space bool keep vectors and the report.

    keep[c] = not (fan-out slice all masked AND residue at every consumer
    exactly zero). Raises CompactionError when a space keeps 0 channels."""
    batch_stats = batch_stats or {}
    dead: dict[str, np.ndarray] = {}
    raw_residue: dict[str, np.ndarray] = {}
    for name, sp in graph.spaces.items():
        m = masks.get(sp.producer.kernel)
        if m is None:
            raise CompactionError(
                f"no mask at {sp.producer.kernel} — compaction needs the bool "
                "masks of the prunable kernels"
            )
        dead[name] = ~m.reshape(m.shape[0], -1).any(dim=1).cpu().numpy()
        if sp.producer.bias is not None:
            raw = _np64(_get(params, sp.producer.bias))
        else:
            raw = np.zeros(sp.channels, np.float64)
        raw_residue[name] = _apply_gate(sp.post, raw, params, batch_stats)

    # A dead channel whose residue is nonzero at ANY consumer must stay.
    blocked = {name: np.zeros(sp.channels, bool) for name, sp in graph.spaces.items()}
    for consumer in graph.consumers:
        vec = np.concatenate([raw_residue[s] for s in consumer.segments])
        vec = _apply_gate(consumer.gate, vec, params, batch_stats)
        off = 0
        for seg in consumer.segments:
            n = graph.spaces[seg].channels
            blocked[seg] |= vec[off : off + n] != 0.0
            off += n

    keeps: dict[str, np.ndarray] = {}
    space_report: dict[str, dict] = {}
    for name, sp in graph.spaces.items():
        keep = ~(dead[name] & ~blocked[name])
        if not keep.any():
            raise CompactionError(
                f"space {name!r}: all {sp.channels} channels are dead — the "
                "compacted layer would have zero width (its output is a "
                "constant); refusing to build a degenerate model"
            )
        keeps[name] = keep
        space_report[name] = {
            "channels": int(sp.channels),
            "kept": int(keep.sum()),
            "dead": int(dead[name].sum()),
            "blocked_residue": int((dead[name] & blocked[name]).sum()),
        }
    report = {
        "arch": graph.arch,
        "spaces": space_report,
        "channels_before": int(sum(sp.channels for sp in graph.spaces.values())),
        "channels_after": int(sum(k.sum() for k in keeps.values())),
    }
    return keeps, report


# --------------------------------------------------------------- compaction
def build_plan(
    params: Tree,
    masks: Tree,
    graph: PropagationGraph,
    batch_stats: Optional[Tree] = None,
) -> CompactionPlan:
    """Analyse the masks once and freeze the slice geometry into a plan.
    Host bookkeeping only: no tensor is sliced here, so a caller can check
    ``plan.savings()`` against a threshold before paying for the slicing."""
    batch_stats = batch_stats or {}
    keeps, report = analyze_masks(params, masks, graph, batch_stats)

    out_keep: dict[PathT, np.ndarray] = {}
    in_keep: dict[PathT, np.ndarray] = {}
    stats_keep: dict[PathT, np.ndarray] = {}
    for name, sp in graph.spaces.items():
        keep = keeps[name]
        out_keep[sp.producer.kernel] = keep
        if sp.producer.bias is not None:
            out_keep[sp.producer.bias] = keep
        for path in sp.attached_params:
            out_keep[path] = keep
        for path in sp.attached_stats:
            stats_keep[path] = keep
    for consumer in graph.consumers:
        keep = np.concatenate([keeps[s] for s in consumer.segments])
        # Consumer-side BN leaves span the concatenated (pre-flatten) axis.
        for path in consumer.attached_params:
            out_keep[path] = keep
        for path in consumer.attached_stats:
            stats_keep[path] = keep
        if consumer.repeat != 1:
            keep = np.tile(keep, consumer.repeat)
        in_keep[consumer.kernel] = keep

    width_overrides = {
        sp.override_key: int(keeps[name].sum())
        for name, sp in graph.spaces.items()
        if int(keeps[name].sum()) != sp.channels
    }

    before = after = 0
    for path, leaf in params.items():
        shape = list(leaf.shape)
        before += int(np.prod(shape)) if shape else 1
        if path in in_keep:
            shape[1] = int(in_keep[path].sum())
        if path in out_keep:
            shape[0] = int(out_keep[path].sum())
        after += int(np.prod(shape)) if shape else 1
    report.update(
        params_before=before,
        params_after=after,
        compacted_spaces=len(width_overrides),
    )
    return CompactionPlan(
        keeps=keeps,
        out_keep=out_keep,
        in_keep=in_keep,
        stats_keep=stats_keep,
        width_overrides=width_overrides,
        report=report,
    )


def compact_tree(tree: Tree, plan: CompactionPlan) -> dict:
    """Slice a flat params-keyed dict (raw or folded params, bool masks,
    gradients, an optimizer moment) along the plan. None leaves pass."""
    return {
        path: None if t is None else _slice_leaf(t, plan.in_keep.get(path), plan.out_keep.get(path))
        for path, t in tree.items()
    }


def expand_tree(tree: Tree, plan: CompactionPlan, anchor: Optional[Tree] = None) -> dict:
    """Inverse of ``compact_tree``: kept coordinates bit-identical to the
    sliced tree; removed coordinates zeros or, with ``anchor`` (a
    full-coordinate dict of the same keys), the anchor's values. The anchor
    form keeps the next level's global magnitude threshold honest: consumer
    in-rows of a removed channel carry real magnitudes in a dense run."""
    return {
        path: None if t is None else _expand_leaf(
            t, plan.in_keep.get(path), plan.out_keep.get(path),
            None if anchor is None else anchor[path],
        )
        for path, t in tree.items()
    }


def compact_stats(stats: Tree, plan: CompactionPlan) -> dict:
    """Slice BatchNorm running stats (mean/var leaves keyed by stats_keep)."""
    return {path: _slice_leaf(t, None, plan.stats_keep.get(path)) for path, t in stats.items()}


def expand_stats(stats: Tree, plan: CompactionPlan, anchor: Optional[Tree] = None) -> dict:
    """Inverse of ``compact_stats``; removed entries from anchor or zeros."""
    return {
        path: _expand_leaf(t, None, plan.stats_keep.get(path),
                           None if anchor is None else anchor[path])
        for path, t in stats.items()
    }


def compact_params(
    params: Tree,
    masks: Tree,
    graph: PropagationGraph,
    batch_stats: Optional[Tree] = None,
) -> CompactionResult:
    """Slice dead channels out of params/batch_stats along the graph: the
    mask-folded, physically smaller tensors and the ``width_overrides``
    that re-instantiate the matching model. Leaves the graph does not name
    (trunk convs, attention projections, heads, residual axes) are folded
    but keep their shape."""
    batch_stats = batch_stats or {}
    plan = build_plan(params, masks, graph, batch_stats)
    folded = {
        path: t if masks.get(path) is None else t * masks[path].to(t.device, t.dtype)
        for path, t in params.items()
    }
    return CompactionResult(
        params=compact_tree(folded, plan),
        batch_stats=compact_stats(batch_stats, plan),
        width_overrides=plan.width_overrides,
        report=plan.report,
    )
