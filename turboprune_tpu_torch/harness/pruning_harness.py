"""PruningHarness — the training runtime (port of
``turboprune_tpu/harness/pruning_harness.py``).

Builds the model (a DeiT or a CNN, ``models.create_model``), loaders,
optimizer and checkpoints from the config on one device and owns a level's
epoch loop: per-level fresh optimizer and schedule, the level-0
``model_init``/``optimizer_init`` saves, the rewind snapshot at
``rewind_epoch``, per-epoch train and test passes, CSV rows. A CNN's
BatchNorm running statistics live in the model's buffers: the train step
moves them, the eval step reads them, and the model checkpoints carry
them as ``batch_stats``.
The JAX package runs a step (or a whole epoch) as one compiled program;
here a step is eager PyTorch in a Python loop, and the metric sums stay on
the device until the epoch's end.

Options of the JAX harness that later slices port raise here, naming the
ROADMAP.md item: the sparse execution backends (``compact_train``,
``compact_eval``, ``nm_sparsity``), more than one device, the profiler
trace, the mid-level checkpoint slot.
"""

from __future__ import annotations

import time

import torch

from ..config.schema import MainConfig
from ..data import create_loaders
from ..models import create_model
from ..ops import masking
from ..train import (
    TrainState,
    add_sums,
    create_optimizer,
    create_schedule,
    create_train_state,
    eval_step,
    make_train_step,
    reset_optimizer,
)
from ..utils import (
    MODEL_INIT,
    MODEL_REWIND,
    OPTIMIZER_INIT,
    OPTIMIZER_REWIND,
    ExperimentCheckpoints,
    MetricsLogger,
    display_training_info,
    resolve_device,
)

PRECISION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def refuse_unported(cfg: MainConfig) -> None:
    """Raise on the options whose slice of the port is still to come."""
    ep = cfg.experiment_params
    unported = {
        "experiment_params.compact_train": (ep.compact_train, "item 15"),
        "experiment_params.compact_eval": (ep.compact_eval, "item 15"),
        "experiment_params.nm_sparsity": (bool(ep.nm_sparsity), "item 15"),
        "experiment_params.num_devices > 1": (ep.num_devices > 1, "item 13"),
        "experiment_params.model_parallelism > 1": (ep.model_parallelism > 1, "item 13"),
        "experiment_params.profile_dir": (bool(ep.profile_dir), "item 17"),
        "experiment_params.checkpoint_every_epochs > 0": (
            ep.checkpoint_every_epochs > 0, "item 6"),
        "model_params.pretrained_path": (bool(cfg.model_params.pretrained_path), "item 12"),
    }
    for knob, (on, item) in unported.items():
        if on:
            raise NotImplementedError(
                f"{knob} is not yet ported to turboprune_tpu_torch "
                f"(ROADMAP.md queue A, {item})"
            )


class PruningHarness:
    """Trainer for one experiment on one device."""

    def __init__(
        self,
        cfg: MainConfig,
        expt_dir: tuple[str, str],
        device: str | torch.device = "cuda",
    ):
        refuse_unported(cfg)
        self.cfg = cfg
        self.prefix, self.expt_dir = expt_dir
        self.device = resolve_device(device)
        ep = cfg.experiment_params
        dp = cfg.dataset_params
        op = cfg.optimizer_params
        self.compute_dtype = PRECISION_DTYPES[ep.training_precision]
        self._make_optimizer = create_optimizer(
            op.optimizer_name, momentum=op.momentum, weight_decay=op.weight_decay
        )
        # Initialised on the CPU from the seed, then moved: the same
        # weights on every device.
        model = create_model(
            cfg.model_params.model_name,
            num_classes=dp.num_classes,
            dataset_name=dp.dataset_name,
            compute_dtype=self.compute_dtype,
            attention_impl=cfg.model_params.attention_impl,
            image_size=dp.image_size,
        )
        model.init_weights(torch.Generator().manual_seed(ep.seed))
        self.model = model.to(self.device)
        self.loaders = create_loaders(cfg, self.device)
        self.ckpts = ExperimentCheckpoints(self.expt_dir)
        self.metrics = MetricsLogger(self.expt_dir, self.prefix)
        self.steps_per_epoch = len(self.loaders.train_loader)
        if ep.max_steps_per_epoch:
            self.steps_per_epoch = min(self.steps_per_epoch, ep.max_steps_per_epoch)
        self.state: TrainState = create_train_state(self.model, self._make_optimizer)
        self._train_step = None

    # ------------------------------------------------------------------ tx
    def setup_level(self, epochs: int) -> None:
        """Fresh optimizer and schedule for a level (the reference
        rebuilds both per level)."""
        op = self.cfg.optimizer_params
        schedule = create_schedule(
            op.scheduler_type,
            base_lr=op.lr,
            epochs=epochs,
            steps_per_epoch=self.steps_per_epoch,
            warmup_fraction=op.warmup_fraction,
        )
        self._train_step = make_train_step(schedule)
        self.state = reset_optimizer(self.state, self._make_optimizer)

    def maybe_rewind_optimizer(self, level: int) -> None:
        """WR + ``rewind_optimizer``: restore the optimizer state captured
        at rewind_epoch. The schedule still restarts from step 0: the lr
        comes from the level's own step count, which the restore leaves
        at 0; Adam's own step count comes back with its moments."""
        pp = self.cfg.pruning_params
        if level > 0 and pp.training_type == "wr" and pp.rewind_optimizer:
            self.state.optimizer.load_state_dict(self.ckpts.load_optimizer(OPTIMIZER_REWIND))

    # --------------------------------------------------------------- loops
    def train_epoch(self) -> dict:
        """One pass over the train loader, at most ``steps_per_epoch``
        steps. Returns host-side epoch means."""
        sums = None
        t0 = time.perf_counter()
        for i, batch in enumerate(self.loaders.train_loader):
            if i >= self.steps_per_epoch:
                break
            sums = add_sums(sums, self._train_step(self.state, batch))
        if sums is None:
            raise RuntimeError(
                "train loader yielded no batches — dataset smaller than "
                "total_batch_size with drop_last?"
            )
        sums = {k: float(v) for k, v in sums.items()}  # waits for the device
        wall = time.perf_counter() - t0
        n = sums["count"]
        return {
            "train_loss": sums["loss_sum"] / n,
            "train_acc": 100.0 * sums["correct"] / n,
            "epoch_seconds": wall,
            "samples_per_sec": n / wall,
        }

    def evaluate(self) -> dict:
        """Full test pass; padded rows (label -1) count nowhere."""
        sums = None
        for batch in self.loaders.test_loader:
            sums = add_sums(sums, eval_step(self.state.model, self.state.masks, batch))
        if sums is None:
            raise RuntimeError("test loader yielded no batches")
        sums = {k: float(v) for k, v in sums.items()}
        n = sums["count"]
        return {
            "test_loss": sums["loss_sum"] / n,
            "test_acc": 100.0 * sums["correct"] / n,
        }

    # --------------------------------------------------------------- level
    def train_one_level(self, epochs_per_level: int, level: int) -> dict:
        """Train one sparsity level."""
        self.setup_level(epochs_per_level)
        self.maybe_rewind_optimizer(level)
        density = masking.overall_density(self.state.masks)
        display_training_info(self.cfg, level, density)
        if level == 0:
            # Level-0 artifacts: starting weights + optimizer (imp rewind
            # target).
            self.ckpts.save_model(MODEL_INIT, self.state.model_tree())
            self.ckpts.save_optimizer(OPTIMIZER_INIT, self.state.optimizer)

        rewind_epoch = self.cfg.pruning_params.rewind_epoch
        max_test_acc = 0.0
        for epoch in range(epochs_per_level):
            row = {"level": level, "epoch": epoch}
            row.update(self.train_epoch())
            row.update(self.evaluate())
            max_test_acc = max(max_test_acc, row["test_acc"])
            row["max_test_acc"] = max_test_acc
            row["sparsity"] = masking.overall_sparsity(self.state.masks)
            self.metrics.log_epoch(row)
            self._log_console(row)
            if level == 0 and rewind_epoch is not None and epoch == rewind_epoch:
                self.ckpts.save_model(MODEL_REWIND, self.state.model_tree())
                self.ckpts.save_optimizer(OPTIMIZER_REWIND, self.state.optimizer)

        return self.metrics.finish_level(
            level,
            {
                "density": density,
                "final_sparsity": masking.overall_sparsity(self.state.masks),
            },
        )

    def _log_console(self, row: dict) -> None:
        print(
            f"[L{row['level']:>2} E{row['epoch']:>3}] "
            f"train {row['train_loss']:.4f}/{row['train_acc']:5.2f}% "
            f"test {row['test_loss']:.4f}/{row['test_acc']:5.2f}% "
            f"(best {row['max_test_acc']:5.2f}%) "
            f"sparsity {row['sparsity']:5.2f}% "
            f"{row['samples_per_sec']:,.0f} img/s",
            flush=True,
        )
