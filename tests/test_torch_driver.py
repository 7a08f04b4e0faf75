"""The port's IMP level loop end to end on the CPU: ``driver.run`` (and
``run_experiment_torch.main``) on ``cifar10_imp`` with synthetic data and a
DeiT-Tiny with flash attention, two levels of two steps each."""

import csv
from pathlib import Path

import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
import run_experiment_torch
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.utils import ExperimentCheckpoints

OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "model_params.model_name=deit_tiny_patch16_224",
    "model_params.attention_impl=flash",
    "pruning_params.target_sparsity=0.2",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
    "dataset_params.synthetic_num_train=32",
    "dataset_params.synthetic_num_test=12",
    "dataset_params.total_batch_size=8",
]


class RecordingHarness(PruningHarness):
    """Keeps each level's starting weights and masks."""

    def train_one_level(self, epochs_per_level, level):
        self.starts = getattr(self, "starts", {})
        self.starts[level] = (
            {k: v.detach().clone() for k, v in self.state.model.state_dict().items()},
            dict(self.state.masks),
        )
        return super().train_one_level(epochs_per_level, level)


def test_two_level_imp_run_on_the_cpu(tmp_path):
    harnesses = []

    class Harness(RecordingHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            harnesses.append(self)

    cfg = compose("cifar10_imp", OVERRIDES + [f"experiment_params.base_dir={tmp_path}"])
    expt_dir, summaries = run(cfg, device="cpu", harness_cls=Harness)
    (harness,) = harnesses
    n = masking.num_prunable(harness.state.masks)
    assert [s["level"] for s in summaries] == [0, 1]
    assert summaries[0]["achieved_density"] == 1.0
    assert abs(summaries[1]["achieved_density"] - 0.8) <= 1.0 / n

    ckpts = ExperimentCheckpoints(expt_dir)
    for role in ("model_init", "model_level_0", "model_level_1"):
        assert (ckpts.checkpoints_dir / role / "model.pt").exists(), role
    assert (ckpts.optimizer_path("optimizer_init") / "optimizer.pt").exists()
    init = ckpts.load_model("model_init")
    level0, level1 = ckpts.load_level(0), ckpts.load_level(1)
    assert all(bool((level1["masks"][p] <= level0["masks"][p]).all()) for p in level0["masks"])

    # imp: level 1 starts from model_init's weights with the new masks.
    start_params, start_masks = harness.starts[1]
    for key, want in init["params"].items():
        assert torch.equal(start_params[key], want), key
    for path, m in level1["masks"].items():
        assert torch.equal(start_masks[path], m), path

    metrics = Path(expt_dir) / "metrics"
    with open(next(metrics.glob("*_summary.csv")), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["level"]) for r in rows] == [0, 1]
    for level in (0, 1):
        with open(metrics / "level_wise_metrics" / f"level_{level}_metrics.csv", newline="") as f:
            (row,) = list(csv.DictReader(f))
        assert float(row["train_loss"]) == float(row["train_loss"])  # finite, not NaN


def test_cuda_is_the_default_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would run")
    cfg = compose("cifar10_imp", OVERRIDES + [f"experiment_params.base_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment_torch.main(["--config-name=cifar10_imp", *OVERRIDES,
                                   f"experiment_params.base_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())  # refused before writing anything


@pytest.mark.parametrize(
    "override",
    [
        "experiment_params.checkpoint_every_epochs=1",
        "experiment_params.compact_train=true",
        "dataset_params.dataloader_type=device",
        "optimizer_params.optimizer_name=ScheduleFreeSGD",
    ],
)
def test_unported_options_raise(tmp_path, override):
    cfg = compose("cifar10_imp", OVERRIDES + [override,
                                              f"experiment_params.base_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PruningHarness(cfg, ("", str(tmp_path / "x")), device="cpu")
