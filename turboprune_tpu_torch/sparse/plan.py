"""One ExecutionPlan: the single producer of sparse-backend decisions (port
of ``turboprune_tpu/sparse/plan.py``).

``plan_execution`` derives one ``ExecutionPlan`` from the live masks:

* channel compaction is tried first (whole-model width slicing, committed
  when ``CompactionPlan.savings()`` clears ``compact_min_savings``);
* N:M gathering is then planned over the survivors, routing each hookable
  layer whose live contraction rows clear ``nm_min_axis_savings``;
* everything else stays masked-dense.

The plan carries the model-constructor overrides (``width_overrides`` /
``nm_overrides``), hashable cache keys, and ``plan_signature()`` whose
leading element is the plan kind ("masked" / "compact" / "nm" / "mixed").
Every per-layer decision (backend, reason, estimated or measured gain)
lands in ``plan.report["decisions"]``, so a fallback to dense is visible.

Autotune (``autotune="cost"`` or ``"measure"``) re-checks each routed N:M
layer against masked-dense (an analytic gather-overhead cost model, or a
timing of both on the masks' device: CUDA events on a card,
``time.perf_counter`` on the CPU) and demotes the layers where gathering
would not pay. Compaction is a whole-model property and is not tuned.

Gradients stay masked-dense's through any mix: compaction slices
coordinates whose gradients are zero under the mask (the anchor expansion
restores them), and ``nm_matmul`` keeps dw a full dense GEMM.

The JAX planner takes a model factory to plan the N:M half on the
compacted model; the hook keys depend only on the model's family (and a
ViT's attention), never on its widths, so the port plans on the model it
is given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional

import torch

from .compact import CompactionPlan, build_plan, compact_tree
from .graph import CompactionError, build_graph
from .nm import _matrix_view, eligible_layers
from .nm_execute import MIN_AXIS_SAVINGS, NMExecPlan, _hook_key, build_nm_plan, nm_matmul

# "force" commits compaction whenever the plan builds (even the identity
# slice) and lets CompactionError propagate; "auto" gates on the savings
# threshold and records failures as decisions.
COMPACT_MODES = ("auto", "force", "off")
NM_MODES = ("auto", "off")
AUTOTUNE_MODES = ("off", "cost", "measure")

# Analytic gather overhead as a fraction of the dense layer's cost (the JAX
# package's constant); autotune="measure" replaces it with a timing.
_GATHER_OVERHEAD = 0.15


@dataclasses.dataclass
class ExecutionPlan:
    """``compaction``/``nm`` hold only committed backend plans (None = that
    backend does not run); ``decisions`` is the routing table and
    ``report`` the audit record with both sub-reports."""

    compaction: Optional[CompactionPlan]
    nm: Optional[NMExecPlan]
    decisions: dict
    report: dict

    @property
    def kind(self) -> str:
        if self.compaction is not None and self.nm is not None:
            return "mixed"
        if self.compaction is not None:
            return "compact"
        if self.nm is not None:
            return "nm"
        return "masked"

    @property
    def width_overrides(self) -> Optional[dict]:
        return self.compaction.width_overrides if self.compaction else None

    @property
    def nm_overrides(self) -> Optional[dict]:
        return self.nm.overrides if self.nm else None

    def width_key(self) -> tuple:
        """Hashable compaction part of the step and eval cache keys."""
        return self.compaction.as_override_tuple() if self.compaction else ()

    def nm_key(self) -> tuple:
        """Hashable N:M part of the step cache keys."""
        return self.nm.as_override_tuple() if self.nm else ()

    def plan_signature(self) -> tuple:
        kind = self.kind
        if kind == "compact":
            return ("compact", self.width_key())
        if kind == "nm":
            return ("nm", self.nm_key())
        if kind == "mixed":
            return ("mixed", self.width_key(), self.nm_key())
        return ("masked",)


def _plan_compaction(model, params, masks, batch_stats, mode: str,
                     min_savings: float) -> tuple[Optional[CompactionPlan], dict]:
    """Build the slice plan and decide commit or decline."""
    if mode == "off":
        return None, {"backend": "dense", "committed": False, "reason": "compaction disabled"}
    try:
        candidate = build_plan(params, masks, build_graph(model, params), batch_stats)
    except CompactionError as e:
        if mode == "force":
            raise
        return None, {"backend": "dense", "committed": False, "reason": f"CompactionError: {e}"}
    savings = candidate.savings()
    if mode == "force":
        commit, reason = True, "backend forced compact"
    elif savings <= 0.0:
        commit, reason = False, "no dead channels to slice"
    elif savings < min_savings:
        commit, reason = False, f"savings {savings:.4f} below threshold {min_savings}"
    else:
        commit, reason = True, f"savings {savings:.4f} clears threshold {min_savings}"
    decision = {
        "backend": "compact" if commit else "dense",
        "committed": commit,
        "savings": round(float(savings), 6),
        "params_before": candidate.report["params_before"],
        "params_after": candidate.report["params_after"],
        "channels_before": candidate.report["channels_before"],
        "channels_after": candidate.report["channels_after"],
        "reason": reason,
    }
    return (candidate if commit else None), decision


def _time_call(fn, device: torch.device) -> float:
    """Best of 3 ms of a warm call: CUDA events on a card, the host clock
    on the CPU."""
    fn()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


@torch.no_grad()
def _nm_layer_estimates(nplan: NMExecPlan, shapes: dict, mode: str,
                        device: torch.device) -> dict[str, dict]:
    """Per routed hook key: the estimated (cost model) or measured (a
    timing of both on ``device``, batch 32, fp32) gain of gathering over
    masked-dense. Gain < 1.0 means gathering would lose."""
    out: dict[str, dict] = {}
    for key, (ki, ko) in nplan.overrides.items():
        i, o = shapes[key]
        if mode == "cost":
            kept_out = (len(ko) / o) if ko is not None else 1.0
            est_cost = len(ki) / i * kept_out + _GATHER_OVERHEAD
            out[key] = {"mode": "cost", "est_gain": round(1.0 / est_cost, 4)}
            continue
        x = torch.ones(32, i, device=device)
        w = torch.ones(i, o, device=device)
        b = torch.zeros(o, device=device)
        ki_t = torch.as_tensor(ki, dtype=torch.long, device=device)
        ko_t = None if ko is None else torch.as_tensor(ko, dtype=torch.long, device=device)
        dense_ms = _time_call(lambda: x @ w + b, device)
        nm_ms = _time_call(lambda: nm_matmul(ki_t, ko_t, x, w, b), device)
        out[key] = {
            "mode": "measure",
            "dense_ms": round(dense_ms, 5),
            "nm_ms": round(nm_ms, 5),
            "est_gain": round(dense_ms / max(nm_ms, 1e-9), 4),
        }
    return out


def _demote(nplan: NMExecPlan, drop: set, key_by_name: dict) -> NMExecPlan:
    """The N:M plan without the demoted hook keys, coverage recounted."""
    overrides = {k: v for k, v in nplan.overrides.items() if k not in drop}
    layers = {}
    routed_params = 0
    for name, info in nplan.report["layers"].items():
        info = dict(info)
        if info["routed"] and key_by_name.get(name) in drop:
            info["routed"] = False
        if info["routed"]:
            routed_params += info["numel"]
        layers[name] = info
    eligible = nplan.report["eligible_params"]
    report = {
        "eligible_params": eligible,
        "routed_params": routed_params,
        "coverage_frac": routed_params / eligible if eligible else 0.0,
        "layers": layers,
    }
    return NMExecPlan(overrides=overrides, report=report)


def plan_execution(
    model,
    params: Mapping,
    masks: Mapping,
    batch_stats: Optional[Mapping] = None,
    *,
    compact: str = "auto",
    nm: str = "auto",
    compact_min_savings: float = 0.0,
    nm_min_axis_savings: float = MIN_AXIS_SAVINGS,
    autotune: str = "off",
) -> ExecutionPlan:
    """This level's ExecutionPlan from the live masks (``params`` and
    ``batch_stats``: flat dicts keyed by flax path, ``graph.model_leaves``).

    ``compact``: "auto" (commit when ``savings()`` > 0 clears
    ``compact_min_savings``), "force" (commit whenever the plan builds;
    CompactionError propagates) or "off". ``nm``: "auto" or "off".
    ``autotune`` refines the N:M routing against masked-dense: "cost"
    (analytic) or "measure" (timed on the masks' device)."""
    if compact not in COMPACT_MODES:
        raise ValueError(f"compact mode {compact!r} not in {COMPACT_MODES}")
    if nm not in NM_MODES:
        raise ValueError(f"nm mode {nm!r} not in {NM_MODES}")
    if autotune not in AUTOTUNE_MODES:
        raise ValueError(f"autotune {autotune!r} not in {AUTOTUNE_MODES}")
    batch_stats = batch_stats or {}

    cplan, comp_decision = _plan_compaction(
        model, params, masks, batch_stats, compact, compact_min_savings
    )

    nplan: Optional[NMExecPlan] = None
    nm_report: Optional[dict] = None
    layer_decisions: dict[str, dict] = {}
    if nm != "off":
        # Compose over the committed widths: gather the survivors.
        live_masks = compact_tree(masks, cplan) if cplan is not None else masks
        candidate = build_nm_plan(model, live_masks, min_axis_savings=nm_min_axis_savings)
        nm_report = candidate.report
        key_by_name = {}
        shapes = {}
        for name, shape, s in eligible_layers(live_masks):
            key = _hook_key(model, name, shape)
            key_by_name[name] = key
            if key is not None:
                shapes[key] = _matrix_view(shape, s)
        estimates: dict[str, dict] = {}
        if candidate.overrides and autotune != "off":
            device = next(iter(masks.values())).device
            estimates = _nm_layer_estimates(candidate, shapes, autotune, device)
            drop = {k for k, e in estimates.items() if e["est_gain"] < 1.0}
            if drop:
                candidate = _demote(candidate, drop, key_by_name)
            nm_report = candidate.report
        if candidate.overrides:
            nplan = candidate
        for name, info in nm_report["layers"].items():
            key = key_by_name.get(name)
            if info["routed"]:
                decision = {
                    "backend": "nm",
                    "reason": (
                        f"live rows {info['kept_in_frac']:.3f} clear "
                        f"axis-savings threshold {nm_min_axis_savings}"
                    ),
                }
            elif not info["hookable"]:
                decision = {"backend": "dense", "reason": "no gathered-execution hook for this layer"}
            elif key in estimates and estimates[key]["est_gain"] < 1.0:
                decision = {
                    "backend": "dense",
                    "reason": "autotune: gather overhead beats the reduced-GEMM win for this layer",
                }
            else:
                decision = {
                    "backend": "dense",
                    "reason": (
                        f"live rows {info['kept_in_frac']:.3f} above "
                        f"axis-savings threshold {nm_min_axis_savings}"
                    ),
                }
            if key in estimates:
                decision.update(estimates[key])
            layer_decisions[name] = decision

    decisions = {"compaction": comp_decision, "layers": layer_decisions}
    plan = ExecutionPlan(compaction=cplan, nm=nplan, decisions=decisions, report={})
    dense_layers = sum(1 for d in layer_decisions.values() if d["backend"] == "dense")
    plan.report = {
        "kind": plan.kind,
        "autotune": autotune,
        "backend_counts": {
            "nm_layers": len(nplan.overrides) if nplan is not None else 0,
            "dense_layers": dense_layers,
            "compact_spaces": cplan.report.get("compacted_spaces", 0) if cplan else 0,
        },
        "coverage_frac": nm_report["coverage_frac"] if nm_report else 0.0,
        "compaction": comp_decision,
        "nm": nm_report,
        "decisions": decisions,
    }
    return plan
