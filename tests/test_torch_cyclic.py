"""The port's cyclic-training driver: ``run_cyclic_training_experiment_torch``
on the CPU, two levels of a DeiT-Tiny in three cycles each. The per-step
learning rates are held against the JAX package's cyclical split and
schedules (no JAX training runs); the rows, the order of the level-0 saves
and the refusal of the mid-level slot are checked on the port alone."""

import csv
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
import run_cyclic_training_experiment_torch
from turboprune_tpu.pruning import generate_cyclical_schedule as jax_cyclical_schedule
from turboprune_tpu.train.schedules import create_schedule as jax_create_schedule
from turboprune_tpu_torch import driver
from turboprune_tpu_torch.config import ConfigError
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.harness import CyclicPruningHarness
from turboprune_tpu_torch.utils import MODEL_INIT, MODEL_REWIND, ExperimentCheckpoints

EPOCHS, CYCLES, STEPS_PER_EPOCH = 6, 3, 1
OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "model_params.model_name=deit_tiny_patch16_224",
    "dataset_params.total_batch_size=8",
    f"dataset_params.synthetic_num_train={8 * STEPS_PER_EPOCH}",
    "dataset_params.synthetic_num_test=8",
    f"experiment_params.epochs_per_level={EPOCHS}",
    f"cyclic_training.num_cycles={CYCLES}",
    "pruning_params.target_sparsity=0.2",
    # wr with the optimizer rewound: the rewind snapshot and the optimizer
    # restore are both on the path.
    "pruning_params.training_type=wr",
    "pruning_params.rewind_epoch=0",
    "pruning_params.rewind_optimizer=true",
]


class Recording(CyclicPruningHarness):
    """Records each step's lr (grouped per ``setup_level``), the model
    saves and the optimizer rewinds with the steps taken before them."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.initial = {k: v.detach().clone() for k, v in self.state.model.state_dict().items()}
        self.lrs, self.saves, self.rewinds, self.steps = {}, [], [], 0
        save_model = self.ckpts.save_model

        def recording_save(role, tree):
            self.saves.append((role, self.steps))
            save_model(role, tree)

        self.ckpts.save_model = recording_save
        Recording.last = self

    def train_one_level(self, epochs_per_level, level):
        self.level = level
        return super().train_one_level(epochs_per_level, level)

    def maybe_rewind_optimizer(self, level):
        self.rewinds.append((level, self.steps))
        super().maybe_rewind_optimizer(level)

    def setup_level(self, epochs):
        super().setup_level(epochs)
        cycle = []
        self.lrs.setdefault(self.level, []).append(cycle)
        step = self._train_step

        def recording_step(state, batch):
            out = step(state, batch)
            cycle.append(state.optimizer.param_groups[0]["lr"])
            self.steps += 1
            return out

        self._train_step = recording_step


@pytest.fixture(scope="module", params=["constant", "linear_decrease"])
def cyclic_run(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(request.param)
    argv = ["--device", "cpu", "--config-name=cifar10_imp", *OVERRIDES,
            f"cyclic_training.strategy={request.param}", f"experiment_params.base_dir={base}"]
    with mock.patch.object(driver, "CyclicPruningHarness", Recording):
        rc = run_cyclic_training_experiment_torch.main(argv)
    (expt,) = [d for d in base.iterdir() if d.is_dir()]
    return {"rc": rc, "strategy": request.param, "harness": Recording.last, "expt": expt}


def test_per_step_lr_equals_the_jax_package(cyclic_run):
    """Each cycle restarts its schedule from step 0 (the warm-up comes
    again); every lr within 1 fp32 ulp of the JAX package's."""
    assert cyclic_run["rc"] == 0
    h = cyclic_run["harness"]
    op = h.cfg.optimizer_params
    cycle_epochs = jax_cyclical_schedule(EPOCHS, CYCLES, cyclic_run["strategy"])
    assert len(cycle_epochs) == CYCLES and sum(cycle_epochs) <= EPOCHS
    want = []
    for epochs in cycle_epochs:
        schedule = jax_create_schedule(op.scheduler_type, op.lr, epochs, STEPS_PER_EPOCH,
                                       op.warmup_fraction)
        want.append(np.asarray(schedule(jnp.arange(epochs * STEPS_PER_EPOCH)), np.float32))
    assert want[0][0] < want[0].max()  # the schedule warms up
    # Level 0 builds one optimizer before its cycles, for the init saves.
    assert h.lrs[0][0] == []
    for level, cycles in ((0, h.lrs[0][1:]), (1, h.lrs[1])):
        assert [len(c) for c in cycles] == [len(w) for w in want], level
        for got, w in zip(cycles, want):
            ulps = np.abs(np.asarray(got) - w.astype(np.float64)) / np.spacing(w)
            assert ulps.max() <= 1.0, (level, ulps)


def test_rows_carry_the_cycle(cyclic_run):
    cycle_epochs = jax_cyclical_schedule(EPOCHS, CYCLES, cyclic_run["strategy"])
    metrics = cyclic_run["expt"] / "metrics" / "level_wise_metrics"
    for level in (0, 1):
        with open(metrics / f"level_{level}_metrics.csv", newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        assert reader.fieldnames[:5] == ["level", "cycle", "epoch", "train_loss", "train_acc"]
        assert reader.fieldnames[-1] == "sparsity"
        assert [(int(r["cycle"]), int(r["epoch"])) for r in rows] == [
            (c, e) for c, n in enumerate(cycle_epochs) for e in range(n)]
        assert all(int(r["level"]) == level for r in rows)
        assert all(np.isfinite(float(r["train_loss"])) for r in rows)


def test_init_saved_before_training_and_rewind_in_cycle_0_only(cyclic_run):
    h = cyclic_run["harness"]
    cycle_epochs = jax_cyclical_schedule(EPOCHS, CYCLES, cyclic_run["strategy"])
    # model_init before the first step, model_rewind after rewind_epoch 0 of
    # level 0's cycle 0, and nothing in the later cycles.
    assert h.saves == [(MODEL_INIT, 0), (MODEL_REWIND, STEPS_PER_EPOCH)]
    init = ExperimentCheckpoints(cyclic_run["expt"]).load_model(MODEL_INIT)
    for k, v in {**init["params"], **init["batch_stats"]}.items():
        assert torch.equal(v, h.initial[k]), k
    level_steps = sum(cycle_epochs) * STEPS_PER_EPOCH
    assert h.rewinds == [(0, 0), (1, level_steps)]  # the first cycle of each level


def test_mid_level_slot_is_refused(tmp_path):
    cfg = compose("cifar10_imp", OVERRIDES + ["experiment_params.checkpoint_every_epochs=1",
                                              f"experiment_params.base_dir={tmp_path}"])
    with pytest.raises(ConfigError, match="checkpoint_every_epochs"):
        driver.run_cyclic(cfg, device="cpu")


def test_cli_raises_without_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cyclic_training_experiment_torch.main(
            ["--config-name=cifar10_imp", *OVERRIDES, f"experiment_params.base_dir={tmp_path}"])
    assert not any(Path(tmp_path).iterdir())
