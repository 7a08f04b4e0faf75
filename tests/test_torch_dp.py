"""Data-parallel training in the port, alone: a real gloo world of 2
processes on localhost (``tests/torch_port_dp_worker.py``, suite "dp",
spawned once per test run) against the same work in one process.

- ``cifar10_imp`` (ResNet-18, CIFAR stem; synthetic 16x16 images, global
  batch 16, fp32, 2 levels of 2 steps) through ``run_experiment_torch.main``
  in the world against the same run in one process: level 0's parameters
  by ROADMAP.md's fp32 rule (each tensor's update from the seed's init
  within 1e-3 + 2 x the noise, the noise being the largest distance
  between one process's level 0 in 4 orders of its batches' rows); level
  1's masks equal on both ranks and, bit for bit, one process's pruning
  of the world's level-0 weights; the level CSVs' densities exactly one
  process's; the metric sums the global batch's (counts exactly, the loss
  by the same rule); one experiment directory, written by rank 0 alone;
- VGG-11 with dropout: each rank's uniforms are its rows of the global
  batch's draw, and one step ends where one process's ends (no
  BatchNorm: only the order of the gradient sums differs, rtol 1e-5);
- SGD's, AdamW's and schedule-free SGD's states stay equal on both ranks
  (the exact check over params and optimizer state after three steps);
- SNIP scored on a host-scope loader's rows (all-gathered) gives masks
  equal on both ranks and to one process's on the global batch;
- a ``compact_train`` level of ResNet-18 with dead channels: every rank
  ends equal (the compacted parameters' gradients are averaged) and
  within the fp32 rule of one process's level;
- the mid-level slot of an ImageFolder run writes one stream blob per
  rank, and a fresh harness on each rank resumes its own;
- ``num_devices`` unequal to the world raises; the compiled step in a
  world of 2 raises naming ROADMAP item 13c.
"""

import csv
from pathlib import Path

import pytest
import torch

import torch_port_dp_worker as worker
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import run_once, spawn_world, write_image_folder
from turboprune_tpu_torch import driver
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import create_model, vgg
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import prune_the_model
from turboprune_tpu_torch.train import (
    DropoutNoise,
    create_optimizer,
    create_schedule,
    create_train_state,
    make_train_step,
)
from turboprune_tpu_torch.utils.checkpoint import model_state_dict, restore_model_tree

LIMIT = 1e-3
ORDERS = 4


def _one_process_driver(root: Path) -> dict:
    """The world's run in one process, and the noise of its level 0: that
    level's two steps from the seed's init, their batches' rows in ORDERS
    orders (the first the loader's own)."""
    out = worker.drive(root / "driver")
    cfg = compose("cifar10_imp", worker.DP_OVERRIDES + [f"experiment_params.base_dir={root}"])
    h = PruningHarness(cfg, ("", str(root / "noise")), device="cpu")
    start = worker._state(h.model)
    batches = list(h.train_batches())
    h.setup_level(1)
    n = len(batches[0][1])
    orders = [torch.arange(n)] + [
        torch.randperm(n, generator=torch.Generator().manual_seed(i)) for i in range(1, ORDERS)]
    out["noise"] = []
    for order in orders:
        h.model.load_state_dict(start)
        ts = create_train_state(h.model, h._make_optimizer)
        step = make_train_step(h._schedule)
        loss = sum(float(step(ts, (x[order], y[order]))["loss_sum"]) for x, y in batches)
        out["noise"].append({"state": worker._state(h.model), "loss_sum": loss})
    out["start"] = start
    return out


def _one_process_dropout() -> dict:
    model = vgg.vgg11(10, fc_features=(32, 32)).init_weights(torch.Generator().manual_seed(0))
    noise = DropoutNoise(torch.device("cpu"), seed=3)
    drawn = noise(model, 4, 5)
    rng = worker.np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype("float32"))
    y = torch.from_numpy(rng.integers(0, 10, size=4)).long()
    state = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=0.0))
    step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3), dropout_noise=noise)
    step(state, (x, y))
    return {"noise": drawn, "state": worker._state(model)}


def _one_process_snip(root: Path) -> dict:
    cfg = compose("cifar10_er_snip", worker.DP_OVERRIDES + [f"experiment_params.base_dir={root}"])
    h = PruningHarness(cfg, ("", str(root / "snip_1")), device="cpu")
    h.loaders.train_loader = worker.HostLoader(worker.snip_batch())
    driver.prune_level(h, 0.8, 1)
    return {"masks": dict(h.state.masks)}


def _one_process_plan(root: Path) -> list:
    """The world's planned level in one process, its batches' rows in
    ORDERS orders (the first the loader's own)."""
    orders = [None] + [torch.randperm(16, generator=torch.Generator().manual_seed(i))
                       for i in range(1, ORDERS)]
    return [worker.planned_level(root / f"plan_{i}", o) for i, o in enumerate(orders)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _noise(states: list, start: dict, k: str) -> float:
    """The largest distance of an update in another order from the first
    order's (0 for a tensor no step moves)."""
    if torch.equal(states[0][k], start[k]):
        return 0.0
    return max(_rel(s[k] - start[k], states[0][k] - start[k]) for s in states[1:])


def _rule(got: dict, ends: list, start: dict) -> dict:
    """Per floating tensor: (the distance of ``got``'s update from the
    first order's, the noise over the orders)."""
    return {k: (_rel(got[k] - start[k], ends[0][k] - start[k]), _noise(ends, start, k))
            for k in start if start[k].is_floating_point()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _expt(root: Path, base: str) -> Path:
    (expt,) = (Path(root) / base).iterdir()
    return expt


def _compare(root: Path, world: list, one: dict) -> dict:
    """What the tests read, reduced to per-tensor distances and
    agreements: the states themselves (hundreds of MB at full width) stay
    out of the session's shared result."""
    expt = _expt(root, "driver")
    level0 = restore_model_tree(expt / "checkpoints" / "model_level_0")
    model = create_model("resnet18", num_classes=10, dataset_name="CIFAR10")
    model.load_state_dict(model_state_dict(level0))
    pruned = prune_the_model("mag", model, level0["masks"], 0.8)
    drv = one["driver"]
    masks = [r["run_driver"].pop("masks") for r in world]
    plan = one["plan"]
    plan_ends = [o["state"] for o in plan]
    return {
        "driver_rule": _rule(model_state_dict(level0), [n["state"] for n in drv["noise"]],
                             drv["start"]),
        "driver_masks": {"ranks_equal": _equal(*masks), "pruned_equal": _equal(masks[0], pruned),
                         "density": masking.overall_density(masks[0]),
                         "sparsity": masking.overall_sparsity(masks[0])},
        "driver_sums": drv["sums"], "noise_losses": [n["loss_sum"] for n in drv["noise"]],
        "dropout_close": [
            {k: bool(torch.allclose(r["dropout"]["state"][k], v, rtol=1e-5, atol=1e-7))
             for k, v in one["dropout"]["state"].items()} for r in world],
        "snip_equal": [_equal(r["snip"]["masks"], one["snip"]["masks"]) for r in world],
        "plan_rule": [_rule(r["plan"]["state"], plan_ends, plan[0]["start"]) for r in world],
        "plan_start_equal": [_equal(r["plan"]["start"], plan[0]["start"]) for r in world],
        "plan_ranks_equal": _equal(world[0]["plan"]["state"], world[1]["plan"]["state"]),
        "plan_kinds": [r["plan"]["kind"] for r in world] + [plan[0]["kind"]],
    }


def _produce(root):
    write_image_folder(root / "folder" / "train", classes=("a", "b", "c"), per_class=5)
    write_image_folder(root / "folder" / "val", classes=("a", "b", "c"), per_class=3, seed=1)
    one = root / "one"

    def references():  # while the world runs
        return {
            "driver": _one_process_driver(one),
            "dropout": _one_process_dropout(),
            "snip": _one_process_snip(one),
            "plan": _one_process_plan(one),
        }

    world, made = spawn_world("dp", root, references)
    compared = _compare(root, world, made)
    for r in world:
        for key in ("dropout", "snip", "plan"):
            r[key] = {k: v for k, v in r[key].items() if k in ("noise", "kind")}
    return {"world": world, "root": str(root), "dropout_noise": made["dropout"]["noise"],
            **compared}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    return run_once(tmp_path_factory, "torch_dp", _produce)


def _csv(path: Path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _run_dir(dp, which: str) -> Path:
    return _expt(dp["root"], "driver" if which == "world" else "one/driver")


# ---------------------------------------------------------------- the driver


def test_driver_level_0_parameters_by_the_fp32_rule(dp):
    """The world's level-0 end (``model_level_0``, written by rank 0)
    against one process's: each tensor's update from the seed's init
    within LIMIT + 2 x the noise over the batch orders."""
    rule = dp["driver_rule"]
    assert len(rule) > 40
    for k, (d, noise) in rule.items():
        assert d <= LIMIT + 2 * noise, (k, d, noise)


def test_driver_level_1_masks_are_one_process_pruning_of_the_same_weights(dp):
    """Both ranks end with the same masks, and they are, bit for bit, the
    masks one process computes from the world's level-0 weights (the same
    criterion on the same weights). One process's own level-0 weights
    differ from the world's by fp32 rounding, and so do the weights next to
    the threshold: its masks are not compared with the world's."""
    m = dp["driver_masks"]
    assert m["ranks_equal"] and m["pruned_equal"]
    # The ladder's 0.8, up to the weights tied at the threshold.
    assert abs(m["density"] - 0.8) < 1e-6


def test_driver_level_csv_densities_are_exact(dp):
    """Level 0's rows are one process's; level 1's sparsity and density
    are exactly those of the masks both ranks hold (one process's pruning
    of the same weights)."""
    rows = {w: _csv(_run_dir(dp, w) / "metrics" / "level_wise_metrics" / "level_0_metrics.csv")
            for w in ("world", "one")}
    assert [r["sparsity"] for r in rows["world"]] == [r["sparsity"] for r in rows["one"]]
    m = dp["driver_masks"]
    level_1 = _csv(_run_dir(dp, "world") / "metrics" / "level_wise_metrics" / "level_1_metrics.csv")
    assert [float(r["sparsity"]) for r in level_1] == [m["sparsity"]]
    summary = {w: _csv(next((_run_dir(dp, w) / "metrics").glob("*_summary.csv")))
               for w in ("world", "one")}
    assert summary["world"][0]["density"] == summary["one"][0]["density"] == "1.0"
    assert float(summary["world"][1]["density"]) == m["density"]
    assert float(summary["world"][1]["final_sparsity"]) == m["sparsity"]


def test_driver_metric_sums_are_the_global_batchs(dp):
    """Every epoch's and evaluation's sums, as the harness read them, are
    the global batch's on both ranks: the counts one process counts (2
    steps of 16 rows, 24 test images with 8 padding rows excluded), the
    level-0 train loss within LIMIT + 2 x the noise over the orders."""
    sums = [r["run_driver"]["sums"] for r in dp["world"]]
    assert sums[0] == sums[1]
    assert [s["count"] for s in sums[0]] == [s["count"] for s in dp["driver_sums"]] == [32, 24] * 2
    losses = dp["noise_losses"]
    noise = max(abs(x - losses[0]) for x in losses[1:])
    assert abs(sums[0][0]["loss_sum"] - losses[0]) <= LIMIT * abs(losses[0]) + 2 * noise
    assert dp["driver_sums"][0]["loss_sum"] == pytest.approx(losses[0], rel=1e-6)


def test_driver_writes_one_experiment_directory_once(dp):
    for r in dp["world"]:
        assert r["run_driver"]["rc"] == 0 and len(r["run_driver"]["dirs"]) == 1
    expt = _run_dir(dp, "world")
    assert (expt / "expt_config.yaml").exists()
    assert sorted(p.name for p in (expt / "checkpoints").iterdir()) == sorted(
        p.name for p in (_run_dir(dp, "one") / "checkpoints").iterdir())
    assert len(_csv(next((expt / "metrics").glob("*_summary.csv")))) == 2


# --------------------------------------------------------- the other paths


def test_dropout_draws_the_global_batchs_noise(dp):
    want = dp["dropout_noise"]
    for rank, r in enumerate(dp["world"]):
        got = r["dropout"]["noise"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert torch.equal(g, w[2 * rank:2 * (rank + 1)])


def test_dropout_step_ends_where_one_process_ends(dp):
    """rtol 1e-5, atol 1e-7, each tensor on each rank."""
    for close in dp["dropout_close"]:
        assert close and all(close.values()), [k for k, ok in close.items() if not ok]


def test_optimizer_states_stay_equal_across_ranks(dp):
    """SGD's momentum, AdamW's moments and schedule-free SGD's z (and the
    averaged weights they give) after three steps: equal on every rank,
    bit for bit, by the exact check."""
    for r in dp["world"]:
        for name in ("SGD", "AdamW", "ScheduleFreeSGD"):
            assert r["optimizers"][name] is None, name
            assert r["optimizers"][name + " leaves"] > 0


def test_snip_on_a_host_scope_loader_gives_equal_masks(dp):
    assert dp["snip_equal"] == [True, True]


def test_planned_level_averages_the_compacted_parameters(dp):
    """Both ranks start and end equal (the worker also checks the end
    exactly), and each tensor's update over the level lies within LIMIT +
    2 x the noise of one process's over the batch orders."""
    assert dp["plan_kinds"] == ["compact"] * 3
    assert dp["plan_start_equal"] == [True, True] and dp["plan_ranks_equal"]
    for rule in dp["plan_rule"]:
        assert len(rule) > 40
        for k, (d, noise) in rule.items():
            assert d <= LIMIT + 2 * noise, (k, d, noise)


def test_mid_level_slot_writes_a_stream_per_rank_and_resumes_each_ranks_own(dp):
    saved = [r["mid_level"]["saved"] for r in dp["world"]]
    assert saved[0] != saved[1]
    for r in dp["world"]:
        m = r["mid_level"]
        assert {"mid_level_stream_0", "mid_level_stream_1"} <= set(m["files"])
        assert m["start"] == 1 and m["restored"] == m["saved"]
    spans = [r["mid_level"]["span"] for r in dp["world"]]
    assert spans == [(0, 7), (7, 14)]  # 15 records, 2 ranks, the remainder dropped
    assert len({(r["mid_level"]["train_len"], r["mid_level"]["eval_len"])
                for r in dp["world"]}) == 1


def test_num_devices_unequal_to_the_world_raises(dp):
    for r in dp["world"]:
        refused = r["refusals"]
        assert "refusing to silently under-provision" in refused["num_devices"]
        assert refused["num_devices_2"] is None


def test_compiled_step_in_a_world_of_two_raises_naming_its_item(dp):
    for r in dp["world"]:
        assert "NotImplementedError" in r["refusals"]["compile"]
        assert "item 13c" in r["refusals"]["compile"]
