"""Make sparsity pay: dead-channel compaction and gathered N:M execution
for training and evaluation (port of ``turboprune_tpu/sparse/``).

graph.py          channel spaces with per-architecture propagation (VGG
                  chains, ResNet stops at residual joins, DenseNet
                  concat-aware offsets, ViT MLP blocks), over flat dicts
                  keyed by flax path (``model_leaves``)
compact.py        ``build_plan`` (keep vectors and the size report) and the
                  slice/scatter pair ``compact_tree``/``expand_tree``;
                  ``compact_params`` for evaluation, with the residue guard
                  that keeps a dead channel whose relu(bn(0)) is nonzero
train_compact.py  ``compact_train_state``/``expand_train_state``: the whole
                  train state (params, masks, BatchNorm statistics, the
                  optimizer's state) sliced onto a smaller model for a level
                  and scattered back into full coordinates
nm.py             N:M projection of unstructured masks onto separable
                  (transposable) block patterns
nm_execute.py     gathered N:M execution: ``nm_matmul`` (reduced forward and
                  dx, full dw), the NM modules and ``build_nm_plan``
plan.py           ``plan_execution``: the one planner that turns live masks
                  into an ``ExecutionPlan`` (compact the dead channels, N:M
                  the scattered survivors, dense where neither pays)

Consumed by the harness (``experiment_params.compact_train``,
``compact_eval``, ``nm_sparsity``, the ``planner`` knobs) and the driver's
N:M projection.
"""

from .compact import (
    CompactionPlan,
    CompactionResult,
    analyze_masks,
    build_plan,
    compact_params,
    compact_stats,
    compact_tree,
    expand_stats,
    expand_tree,
)
from .graph import CompactionError, PropagationGraph, build_graph, model_leaves
from .nm import (
    NMError,
    check_divisibility,
    nm_pattern_inaxis,
    nm_pattern_transposable,
    project_masks,
)
from .nm_execute import NMExecPlan, build_nm_plan
from .plan import (
    AUTOTUNE_MODES,
    COMPACT_MODES,
    NM_MODES,
    ExecutionPlan,
    plan_execution,
)
from .train_compact import (
    compact_train_state,
    expand_opt_state,
    expand_train_state,
    slice_opt_state,
    width_signature,
)

__all__ = [
    "AUTOTUNE_MODES",
    "COMPACT_MODES",
    "CompactionError",
    "CompactionPlan",
    "CompactionResult",
    "ExecutionPlan",
    "NMError",
    "NMExecPlan",
    "NM_MODES",
    "PropagationGraph",
    "analyze_masks",
    "build_graph",
    "build_nm_plan",
    "build_plan",
    "check_divisibility",
    "compact_params",
    "compact_stats",
    "compact_tree",
    "compact_train_state",
    "expand_opt_state",
    "expand_stats",
    "expand_train_state",
    "expand_tree",
    "model_leaves",
    "nm_pattern_inaxis",
    "nm_pattern_transposable",
    "plan_execution",
    "project_masks",
    "slice_opt_state",
    "width_signature",
]
