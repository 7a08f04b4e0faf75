"""``experiment_params.profile_dir`` in the port on the CPU: a tiny DeiT
run traces level 0's second training pass and nothing else, into one
Chrome trace per process, and trains bit for bit as the same run without
it; the JAX harness's own condition picks the same (level, epoch); a level
resumed past that epoch, and the cyclic driver, write no trace."""

import ast
import csv
import json
from pathlib import Path

import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import run_once
import run_cyclic_training_experiment_torch
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.harness.pruning_harness import traces_epoch
from turboprune_tpu_torch.utils import ExperimentCheckpoints

REPO = Path(__file__).resolve().parents[1]
OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "model_params.model_name=deit_tiny_patch16_224",
    "model_params.attention_impl=flash",
    "pruning_params.target_sparsity=0.2",
    "experiment_params.epochs_per_level=2",
    "experiment_params.max_steps_per_epoch=2",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=8",
    "dataset_params.total_batch_size=8",
]
# Wall-clock columns differ between any two runs.
CLOCK_COLUMNS = {"epoch_seconds", "samples_per_sec"}


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class Recording(PruningHarness):
    """Records every epoch's (level, epoch, traced) and whether the
    profiler was on during each evaluation."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.epochs, self.eval_profiled = [], []

    def _run_epoch(self, row, max_test_acc, snapshot_ok, trace_dir=""):
        self.epochs.append((row["level"], row["epoch"], bool(trace_dir)))
        return super()._run_epoch(row, max_test_acc, snapshot_ok, trace_dir)

    def evaluate(self):
        self.eval_profiled.append(_profiling())
        return super().evaluate()


def _run(base: Path, profile_dir: str = "") -> dict:
    harnesses = []

    class Harness(Recording):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            harnesses.append(self)

    extra = [f"experiment_params.profile_dir={profile_dir}"] if profile_dir else []
    cfg = compose("cifar10_imp", OVERRIDES + extra + [f"experiment_params.base_dir={base}"])
    expt_dir, _ = run(cfg, device="cpu", harness_cls=Harness)
    (h,) = harnesses
    rows = []
    for level in (0, 1):
        path = Path(expt_dir) / "metrics" / "level_wise_metrics" / f"level_{level}_metrics.csv"
        with open(path, newline="") as f:
            rows += [{k: v for k, v in r.items() if k not in CLOCK_COLUMNS}
                     for r in csv.DictReader(f)]
    ckpts = ExperimentCheckpoints(expt_dir)
    return {"epochs": h.epochs, "eval_profiled": h.eval_profiled, "rows": rows,
            "levels": [ckpts.load_level(level) for level in (0, 1)]}


def _produce(root: Path) -> dict:
    profile = root / "profile"
    return {"traced": _run(root / "a", str(profile)), "plain": _run(root / "b"),
            "files": sorted(p.name for p in profile.iterdir()),
            "trace": json.loads((profile / "rank0.pt.trace.json").read_text())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_once(tmp_path_factory, "torch_profile", _produce)


def _jax_condition():
    """The JAX harness's ``tracing = ...`` expression in ``train_one_level``,
    compiled from its source."""
    tree = ast.parse((REPO / "turboprune_tpu/harness/pruning_harness.py").read_text())
    (expr,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and [getattr(t, "id", None) for t in n.targets] == ["tracing"]]
    code = compile(ast.Expression(expr), "jax_condition", "eval")
    return lambda profile_dir, level, epoch: eval(
        code, {}, {"profile_dir": profile_dir, "level": level, "epoch": epoch})


def test_one_trace_for_level_0_epoch_1_training_only(runs):
    traced = runs["traced"]
    assert runs["files"] == ["rank0.pt.trace.json"]
    assert [(lv, ep) for lv, ep, on in traced["epochs"] if on] == [(0, 1)]
    assert len(traced["epochs"]) == 4
    # The evaluations ran outside the profile, also that of the traced epoch.
    assert traced["eval_profiled"] == [False] * 4
    events = runs["trace"]["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("flash_fwd" in n for n in names), "the traced pass ran no attention"
    assert any("flash_bwd_dkv" in n for n in names), "the traced pass ran no backward"
    assert not any(on for _, _, on in runs["plain"]["epochs"])


def test_trace_changes_no_number(runs):
    a, b = runs["traced"], runs["plain"]
    assert a["rows"] == b["rows"]
    for la, lb in zip(a["levels"], b["levels"]):
        for part in ("params", "masks"):
            assert la[part].keys() == lb[part].keys()
            for k in la[part]:
                assert torch.equal(la[part][k], lb[part][k]), (part, k)


def test_jax_harness_traces_the_same_epoch(runs):
    jax_traces = _jax_condition()
    for profile_dir in ("", "somewhere"):
        for level in range(3):
            for epoch in range(4):
                assert traces_epoch(profile_dir, level, epoch) == bool(
                    jax_traces(profile_dir, level, epoch)), (profile_dir, level, epoch)
    run_epochs = runs["traced"]["epochs"]
    assert [on for _, _, on in run_epochs] == [
        bool(jax_traces("profile", lv, ep)) for lv, ep, _ in run_epochs]


@pytest.mark.parametrize("slot_epoch, traced", [(1, False), (0, True)])
def test_resume_past_epoch_1_takes_no_trace(tmp_path, slot_epoch, traced):
    """Level 0 re-entered from the mid-level slot: after epoch 1 it trains
    epoch 2 only and writes nothing; after epoch 0 it trains epoch 1 and
    traces it."""
    profile = tmp_path / "profile"
    cfg = compose("cifar10_imp", OVERRIDES + [
        f"experiment_params.base_dir={tmp_path}", "experiment_params.checkpoint_every_epochs=1",
        "experiment_params.max_steps_per_epoch=1", f"experiment_params.profile_dir={profile}"])
    h = Recording(cfg, ("p", str(tmp_path / "expt")), device="cpu")
    h.setup_level(3)
    meta = {"max_test_acc": 0.0, "config_hash": h.config_hash, "run_id": h.run_id,
            "train_loader_epoch": slot_epoch + 1, "level_rows": []}
    h.ckpts.save_mid_level(0, slot_epoch, h.state, meta)
    h.train_one_level(3, 0)
    assert [ep for _, ep, _ in h.epochs] == list(range(slot_epoch + 1, 3))
    files = sorted(p.name for p in profile.iterdir()) if profile.exists() else []
    assert files == (["rank0.pt.trace.json"] if traced else [])


def test_cyclic_driver_takes_no_trace(tmp_path, capsys):
    profile = tmp_path / "profile"
    rc = run_cyclic_training_experiment_torch.main([
        "--device", "cpu", "--config-name=cifar10_imp", *OVERRIDES,
        "experiment_params.max_steps_per_epoch=1", "cyclic_training.num_cycles=2",
        "pruning_params.target_sparsity=0.0",
        f"experiment_params.base_dir={tmp_path}", f"experiment_params.profile_dir={profile}"])
    assert rc == 0
    assert not profile.exists()
    assert "cyclic harness takes no trace" in capsys.readouterr().out
