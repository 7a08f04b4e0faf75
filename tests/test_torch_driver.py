"""The port's level loop end to end on the CPU: ``driver.run`` (and
``run_experiment_torch.main``) on ``cifar10_imp`` with synthetic data and a
DeiT-Tiny with flash attention, two levels of two steps each; the same
config as shipped (ResNet-18, BatchNorm) and the prune-at-init configs
``cifar10_er_snip``/``cifar10_er_erk``."""

import copy
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
import run_experiment_torch
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.serve import InferenceEngine
from turboprune_tpu_torch.train import eval_step
from turboprune_tpu_torch.train.steps import masked_forward
from turboprune_tpu_torch.utils import ExperimentCheckpoints, model_state_dict

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
        "experiment_params.profile_dir={tmp}/profile",
        "experiment_params.compact_train=true",
        "model_params.pretrained_path={tmp}/deit.npz",
        "optimizer_params.optimizer_name=ScheduleFreeSGD",
    ],
)
def test_unported_options_raise(tmp_path, override):
    cfg = compose("cifar10_imp", OVERRIDES + [override.format(tmp=tmp_path),
                                              f"experiment_params.base_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PruningHarness(cfg, ("", str(tmp_path / "x")), device="cpu")


RESNET_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=12",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
]


def test_resnet18_imp_rewinds_params_and_batch_stats_and_serves(tmp_path):
    """cifar10_imp as shipped (ResNet-18, CIFAR stem, bf16), two levels:
    the imp rewind restores the parameters AND the BatchNorm statistics of
    model_init bit for bit; the level checkpoints carry the statistics the
    level trained; eval and serving run on them."""
    harnesses = []

    class Harness(RecordingHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            harnesses.append(self)

    cfg = compose("cifar10_imp", RESNET_OVERRIDES + [
        "pruning_params.target_sparsity=0.2", f"experiment_params.base_dir={tmp_path}"])
    assert cfg.model_params.model_name == "resnet18"
    expt_dir, summaries = run(cfg, device="cpu", harness_cls=Harness)
    (harness,) = harnesses
    n = masking.num_prunable(harness.state.masks)
    assert [s["achieved_density"] for s in summaries][0] == 1.0
    assert abs(summaries[1]["achieved_density"] - 0.8) <= 1.0 / n

    ckpts = ExperimentCheckpoints(expt_dir)
    init, level0, level1 = (ckpts.load_model("model_init"), ckpts.load_level(0),
                            ckpts.load_level(1))
    assert init["batch_stats"].keys() == level0["batch_stats"].keys()
    assert len(init["batch_stats"]) == 2 * 20  # mean and var of 20 BatchNorms
    assert not any(k in init["params"] for k in init["batch_stats"])
    # Training moved the running statistics of level 0.
    assert any(not torch.equal(level0["batch_stats"][k], v)
               for k, v in init["batch_stats"].items())
    start_state, start_masks = harness.starts[1]
    for key, want in model_state_dict(init).items():
        assert torch.equal(start_state[key], want), key
    for path, m in level1["masks"].items():
        assert torch.equal(start_masks[path], m), path
        assert bool((m <= level0["masks"][path]).all()), path

    # Eval and serving use the running statistics of the level checkpoint.
    images = harness.loaders.test_loader._base[:8]
    model = harness.state.model
    model.load_state_dict(model_state_dict(level1))
    masks = level1["masks"]
    model.eval()
    with torch.no_grad():
        want = masked_forward(model, masks, images)
        sums = eval_step(model, masks, (images, torch.zeros(8, dtype=torch.long)))
    assert not model.training
    torch.testing.assert_close(
        sums["loss_sum"],
        torch.nn.functional.cross_entropy(want.float(), torch.zeros(8, dtype=torch.long),
                                          reduction="sum"))
    engine = InferenceEngine.from_experiment(expt_dir, buckets=(8,), device="cpu")
    assert engine.level == 1 and not engine.model.training
    got = engine.predict(images.numpy())
    np.testing.assert_allclose(got, want.float().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("config", ["cifar10_er_snip", "cifar10_er_erk"])
def test_prune_at_init_runs_from_the_cli(tmp_path, config):
    """A prune-at-init config as shipped: one level at density 0.1, the
    model_init checkpoint pruned and its BatchNorm statistics untouched by
    the scoring (SNIP differentiates a train-mode forward)."""
    rc = run_experiment_torch.main(["--device", "cpu", f"--config-name={config}",
                                    *RESNET_OVERRIDES, f"experiment_params.base_dir={tmp_path}"])
    assert rc == 0
    (expt,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    ckpts = ExperimentCheckpoints(expt)
    init, level0 = ckpts.load_model("model_init"), ckpts.load_level(0)
    n = masking.num_prunable(init["masks"])
    density = masking.overall_density(init["masks"])
    if config == "cifar10_er_snip":
        assert abs(density - 0.1) <= 1.0 / n
    else:  # Bernoulli per layer: 4 sigma of the kept count
        assert abs(density - 0.1) * n <= 4 * (n * 0.1 * 0.9) ** 0.5
    for key, v in init["batch_stats"].items():
        assert bool((v == (1.0 if key.endswith(".var") else 0.0)).all()), key
    assert all(torch.equal(level0["masks"][p], m) for p, m in init["masks"].items())


def test_scoring_batch_starts_a_loader_epoch(tmp_path):
    from turboprune_tpu_torch.driver import _first_train_batch

    cfg = compose("cifar10_er_snip", RESNET_OVERRIDES + [f"experiment_params.base_dir={tmp_path}"])
    harness = PruningHarness(cfg, ("", str(tmp_path / "x")), device="cpu")
    loader = harness.loaders.train_loader
    assert loader.epoch == 0
    images, labels = _first_train_batch(harness)
    assert loader.epoch == 1 and images.shape == (8, 32, 32, 3)
    epoch0 = copy.copy(loader)
    epoch0.epoch = 0
    assert torch.equal(labels, next(iter(epoch0))[1])  # epoch 0's first batch


def test_device_loader_reads_local_files_only(tmp_path):
    cfg = compose("cifar10_imp", RESNET_OVERRIDES + [
        "dataset_params.dataloader_type=device", f"dataset_params.data_root_dir={tmp_path}",
        f"experiment_params.base_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError, match="dataloader_type: synthetic"):
        PruningHarness(cfg, ("", str(tmp_path / "x")), device="cpu")
