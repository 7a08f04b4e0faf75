"""The one planner and plan execution in the port
(turboprune_tpu_torch/sparse/plan.py; the harness's ``_enter_plan`` /
``_exit_plan``, ``compact_eval``, the mid-level slot; the driver's ``nm``
criterion and N:M projection) against the JAX package and against the
port's own masked-dense runs.

``plan_execution`` against JAX (bit for bit): kind, width and N:M keys,
``plan_signature``, backend counts, coverage and every decision (with its
reason and, under ``autotune="cost"``, its estimate) for compact, nm,
mixed and masked masks on a small VGG-11-BN (``fc_features=(32, 32)``) and
a depth-2 DeiT; ``autotune="measure"`` times every routed layer.

Harness levels (ResNet-18 on CIFAR-10's shapes, synthetic data, batch 8,
two steps, fp32, weight decay 0; the masks kill half of every block's
``Conv_0`` output channels, whose relu(bn(0)) is 0 at init, plus 20%
scattered zeros): a ``compact_train`` level, a DeiT-Tiny
``nm_sparsity='2:4'`` level with flash attention and a ``compact_eval``
evaluation each end within rtol 1e-4 + atol 1e-5 of the masked-dense run
(params and statistics; loss within 1e-5 relative), the removed
coordinates equal to the level's start bit for bit; a mid-level slot
written inside a compacted level holds full coordinates and its resume
ends where the uninterrupted level ended, bit for bit; one level compiled
under ``aot_eager`` with a plan ends within the same tolerance of the
eager level; and the driver's ``nm`` criterion and the ``mag`` criterion
with the ``nm_sparsity`` projection give the same N:M masks.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, jax_masks, jax_params, seeded_variables
from turboprune_tpu import sparse as jsparse
from turboprune_tpu.models import vgg as jvgg
from turboprune_tpu.models.vit import VisionTransformer as JaxViT
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu_torch import bridge, sparse
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import vgg, vit
from turboprune_tpu_torch.pruning import prune_nm
from turboprune_tpu_torch.sparse.graph import model_leaves
from turboprune_tpu_torch.utils.checkpoint import restore_model_tree

VGG = dict(cfg=vgg.VGG_CFGS["vgg11"], num_classes=10, fc_features=(32, 32))


# --------------------------------------------------------- the planner vs JAX


def _vgg_case(kill: bool, nm_fc: bool):
    jmodel = jvgg.VGG(jvgg.VGG_CFGS["vgg11"], 10, fc_features=(32, 32))
    variables = seeded_variables(jmodel, 32, seed=2)
    params = jax.tree.map(np.array, variables["params"])
    stats = variables["batch_stats"]
    rng = np.random.default_rng(3)
    masks = jax.tree.map(lambda m: None if m is None else np.ones(m.shape, bool),
                         jmasking.make_masks(params), is_leaf=lambda x: x is None)
    if kill:
        for name, leaf in params.items():
            if name.startswith("conv"):
                masks[name]["kernel"][..., rng.random(leaf["kernel"].shape[-1]) < 0.5] = False
                leaf["bias"][:] = 0.0  # dead channels' residue: relu(bn(0))
    if nm_fc:
        for fc in ("fc0", "fc1", "fc2"):
            m = masks[fc]["kernel"]
            m[rng.permutation(m.shape[0])[: m.shape[0] // 2]] = False
    model = vgg.VGG(**VGG)
    state, tmasks = bridge.params_from_flax(params, masks, stats)
    model.load_state_dict(state)
    return jmodel, params, stats, masks, model, tmasks


def _deit_case():
    params = jax_params(seed=9)
    masks = jax.device_get(jsparse.project_masks(params, jax_masks(params, seed=9), 2, 4)[0])
    model = vit.VisionTransformer(**TINY, image_size=32, attention_impl="dense")
    state, tmasks = bridge.params_from_flax(params, masks)
    model.load_state_dict(state)
    return JaxViT(**TINY, attention_impl="dense"), params, {}, masks, model, tmasks


@pytest.mark.parametrize("case", ["compact", "nm", "mixed", "masked"])
def test_plan_matches_jax(case):
    jmodel, params, stats, masks, model, tmasks = (
        _deit_case() if case == "nm" else _vgg_case(case in ("compact", "mixed"), case == "mixed"))
    kw = dict(compact="off" if case == "nm" else "auto", nm="off" if case == "compact" else "auto",
              compact_min_savings=0.25, autotune="cost" if case == "nm" else "off")
    want = jsparse.plan_execution(jmodel, params, masks, stats, **kw)
    tparams, tstats = model_leaves(model)
    got = sparse.plan_execution(model, tparams, tmasks, tstats, **kw)
    assert got.kind == want.kind == case
    assert got.width_key() == want.width_key()
    assert got.nm_key() == want.nm_key()
    assert got.plan_signature() == want.plan_signature()
    assert got.decisions == want.decisions
    for k in ("kind", "autotune", "backend_counts", "coverage_frac", "compaction", "nm"):
        assert got.report[k] == want.report[k], k
    if case == "nm":
        # autotune="measure" times each routed layer against masked-dense
        # (the host clock on the CPU); the timings decide, so only their
        # presence is checked.
        timed = sparse.plan_execution(model, tparams, tmasks, tstats, **{**kw, "autotune": "measure"})
        measured = [d for d in timed.decisions["layers"].values() if "mode" in d]
        assert len(measured) == len(got.nm_overrides)
        assert all(d["mode"] == "measure" and d["dense_ms"] > 0 and d["nm_ms"] > 0 for d in measured)


# ------------------------------------------------------------ harness levels

RESNET = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=8",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
    "optimizer_params.weight_decay=0",
    "experiment_params.training_precision=float32",
]
DEIT = RESNET + ["model_params.model_name=deit_tiny_patch16_224",
                 "model_params.attention_impl=flash"]


def _harness(tmp_path, overrides, name):
    cfg = compose("cifar10_imp", overrides + [f"experiment_params.base_dir={tmp_path}"])
    return PruningHarness(cfg, ("", str(tmp_path / name)), device="cpu")


def _channel_masks(harness, seed=0):
    """Half of every block's Conv_0 output channels dead, 20% scattered
    zeros everywhere."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for path, m in harness.state.masks.items():
        m = torch.rand(m.shape, generator=g) >= 0.2
        if path.endswith("Conv_0/kernel"):
            m[torch.rand(m.shape[0], generator=g) < 0.5] = False
        out[path] = m
    return out


def _nm_masks(harness, seed=0):
    g = torch.Generator().manual_seed(seed)
    masks = {p: torch.rand(m.shape, generator=g) >= 0.2 for p, m in harness.state.masks.items()}
    return sparse.project_masks(harness.state.model.state_dict(), masks, 2, 4)[0]


def _snapshot(harness) -> dict:
    return {k: v.detach().clone() for k, v in harness.state.model.state_dict().items()}


def _assert_close(got: dict, want: dict, skip=()):
    for k in want:
        if k not in skip:
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)


def _removed_equal_start(start: dict, end: dict, plan) -> None:
    """Every coordinate the plan removed ends as it started, bit for bit."""
    from turboprune_tpu_torch.sparse.graph import state_key

    n = 0
    for path in set(plan.in_keep) | set(plan.out_keep) | set(plan.stats_keep):
        key = state_key(path)
        kept = torch.zeros_like(start[key], dtype=torch.bool)
        rows = plan.out_keep.get(path, plan.stats_keep.get(path))
        rows = torch.ones(kept.shape[0], dtype=torch.bool) if rows is None else torch.from_numpy(rows)
        cols = plan.in_keep.get(path)
        if cols is None:
            kept[rows] = True
        else:
            kept[rows[:, None].expand(-1, kept.shape[1]) & torch.from_numpy(cols)[None, :]] = True
        removed = ~kept
        n += int(removed.sum())
        assert torch.equal(end[key][removed], start[key][removed]), key
    assert n > 0


def _run_level(harness, masks, level=1, epochs=1):
    harness.state.masks = {p: m.clone() for p, m in masks.items()}
    harness.train_one_level(epochs, level)
    return _snapshot(harness)


@pytest.mark.parametrize("knob", ["compact_train", "nm_sparsity"])
def test_planned_level_ends_at_masked_dense(tmp_path, knob):
    base = DEIT if knob == "nm_sparsity" else RESNET
    on = "experiment_params.nm_sparsity='2:4'" if knob == "nm_sparsity" else \
        "experiment_params.compact_train=true"
    planned = _harness(tmp_path, base + [on], "planned")
    dense = _harness(tmp_path, base, "dense")
    masks = _nm_masks(planned) if knob == "nm_sparsity" else _channel_masks(planned)
    start = _snapshot(planned)
    params, stats = model_leaves(planned.state.model)
    plan = sparse.build_plan(params, masks, sparse.build_graph(planned.state.model, params), stats)
    end = _run_level(planned, masks)
    want = _run_level(dense, masks)
    report = planned.last_plan_report
    if knob == "compact_train":
        assert report["kind"] == "compact" and report["compaction"]["savings"] >= 0.25
        _removed_equal_start(start, end, plan)
        # A removed channel's running variance stays anchored; the dense
        # run's decays toward the dead channel's batch variance 0 (its
        # residue is 0 either way).
        removed_var = {k for k in want if k.endswith("BatchNorm_0.var")}
        _assert_close(end, want, skip=removed_var)
    else:
        assert report["kind"] == "nm" and report["backend_counts"]["nm_layers"] == 25
        _assert_close(end, want)
    assert planned.compact_metrics.render_prometheus().count("plan_") >= 5
    assert planned._plan_ctx is None and planned.state.model is planned.model


def test_compact_eval_matches_masked_dense(tmp_path):
    planned = _harness(tmp_path, RESNET + ["experiment_params.compact_eval=true"], "planned")
    dense = _harness(tmp_path, RESNET, "dense")
    masks = _channel_masks(planned)
    for h in (planned, dense):
        h.state.masks = masks
    got, want = planned.evaluate(), dense.evaluate()
    assert got["test_acc"] == want["test_acc"]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=1e-5)
    report = planned.last_compaction_report
    assert report["params_after"] < report["params_before"]
    (key,) = planned._plan_eval_cache
    small = planned._plan_eval_cache[key][0]
    assert small.layer1_0.Conv_0.out_channels == dict(key)["layer1_0/Conv_0"] < 64


def test_mid_level_slot_inside_a_compacted_level_resumes(tmp_path):
    overrides = RESNET + ["experiment_params.compact_train=true",
                          "experiment_params.checkpoint_every_epochs=1"]
    a = _harness(tmp_path, overrides, "expt")
    masks = _channel_masks(a)
    full_shapes = {k: v.shape for k, v in a.state.model.state_dict().items()}
    end_a = _run_level(a, masks, epochs=2)
    slot = restore_model_tree(a.ckpts.mid_level_path())
    assert {**slot["params"], **slot["batch_stats"]}.keys() == full_shapes.keys()
    assert all(v.shape == full_shapes[k] for k, v in {**slot["params"], **slot["batch_stats"]}.items())
    momentum = slot["optimizer"]["state"]
    names = [k for k, _ in a.state.model.named_parameters()]
    assert all(s["momentum_buffer"].shape == full_shapes[names[i]] for i, s in momentum.items())
    # A preempted run's successor: the slot restores (full), the plan is
    # re-derived and its momentum re-sliced, and epoch 1 ends where the
    # uninterrupted level did.
    b = _harness(tmp_path, overrides, "expt")
    b.train_one_level(2, 1)  # the masks too come from the slot
    end_b = _snapshot(b)
    assert b.last_plan_report["kind"] == "compact"
    for k in end_a:
        assert torch.equal(end_b[k], end_a[k]), k


def test_compiled_level_with_a_plan(tmp_path):
    eager = _harness(tmp_path, RESNET + ["experiment_params.compact_train=true"], "eager")
    compiled = _harness(tmp_path, RESNET + ["experiment_params.compact_train=true",
                                            "model_params.use_compile=true"], "compiled")
    masks = _channel_masks(eager)
    want = _run_level(eager, masks)
    got = _run_level(compiled, masks)
    assert compiled.last_plan_report["kind"] == "compact"
    assert len(compiled._plan_step_cache) == 1
    _assert_close(got, want)


@pytest.mark.parametrize("method", ["nm", "mag"])
def test_nm_criterion_and_projection_through_the_driver(tmp_path, method):
    cfg = compose("cifar10_imp", RESNET + [
        f"pruning_params.prune_method={method}", "pruning_params.target_sparsity=0.2",
        "experiment_params.nm_sparsity='2:4'", f"experiment_params.base_dir={tmp_path}"])
    expt, summaries = run(cfg, device="cpu")
    from pathlib import Path

    level0 = restore_model_tree(Path(expt) / "checkpoints" / "model_level_0")
    level1 = restore_model_tree(Path(expt) / "checkpoints" / "model_level_1")
    want = prune_nm(level0["params"], level0["masks"], 0.8, 2, 4, True)
    for path, m in want.items():
        assert torch.equal(level1["masks"][path], m), path
    fc = level1["masks"]["fc/kernel"]
    assert (fc.T.reshape(-1, 4, fc.shape[0]).any(-1).sum(-1) <= 2).all()
    assert summaries[1]["achieved_density"] < 0.8
