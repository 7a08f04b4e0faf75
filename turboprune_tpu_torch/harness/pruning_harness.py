"""PruningHarness — the training runtime (port of
``turboprune_tpu/harness/pruning_harness.py``).

Builds the model (a DeiT or a CNN, ``models.create_model``), loaders,
optimizer and checkpoints from the config on one device and owns a level's
epoch loop: per-level fresh optimizer and schedule, the level-0
``model_init``/``optimizer_init`` saves, the rewind snapshot at
``rewind_epoch``, per-epoch train and test passes, CSV rows, and the
mid-level slot every ``checkpoint_every_epochs`` epochs, from which a
preempted level re-enters at the next epoch. A CNN's
BatchNorm running statistics live in the model's buffers: the train step
moves them, the eval step reads them, and the model checkpoints carry
them as ``batch_stats``.
The JAX package runs a step (or a whole epoch) as one compiled program.
Here a step runs from a Python loop: eagerly by default, or, with
``model_params.use_compile``, through the compiled train and eval forwards
(``train.compile_forward``: inductor under CUDA graphs on the card),
built once per harness; the shapes do not change between levels, so
nothing recompiles. The metric sums stay on the device until the epoch's
end.

Options of the JAX harness that later slices port raise here, naming the
ROADMAP.md item: the sparse execution backends (``compact_train``,
``compact_eval``, ``nm_sparsity``), more than one device, the profiler
trace.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from ..config.schema import MainConfig
from ..data import create_loaders
from ..models import create_model
from ..ops import masking
from ..train import (
    TrainState,
    add_sums,
    compile_forward,
    create_optimizer,
    create_schedule,
    create_train_state,
    eval_forward,
    eval_step,
    make_train_step,
    mark_buffers_static,
    reset_optimizer,
    train_forward,
)
from ..utils import (
    MODEL_INIT,
    MODEL_REWIND,
    OPTIMIZER_INIT,
    OPTIMIZER_REWIND,
    ExperimentCheckpoints,
    MetricsLogger,
    config_fingerprint,
    display_training_info,
    model_state_dict,
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
        # The mid-level slot's identity: a slot stamped with another config
        # is never restored.
        self.config_hash = config_fingerprint(cfg)
        self.run_id = Path(self.expt_dir).name
        self.metrics = MetricsLogger(self.expt_dir, self.prefix)
        self.steps_per_epoch = len(self.loaders.train_loader)
        if ep.max_steps_per_epoch:
            self.steps_per_epoch = min(self.steps_per_epoch, ep.max_steps_per_epoch)
        self.state: TrainState = create_train_state(self.model, self._make_optimizer)
        self._train_step = None
        # The step's model work, compiled once for every level: params
        # and statistics are read from their storage, masks and batches
        # are graph inputs (train.compile_forward).
        self._train_forward, self._eval_forward = train_forward, eval_forward
        if cfg.model_params.use_compile:
            mark_buffers_static(self.model)
            self._train_forward = compile_forward(train_forward, self.device)
            self._eval_forward = compile_forward(eval_forward, self.device)

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
        self._train_step = make_train_step(schedule, self._train_forward)
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
            sums = add_sums(sums, eval_step(self.state.model, self.state.masks, batch,
                                            self._eval_forward))
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

        ckpt_every = self.cfg.experiment_params.checkpoint_every_epochs
        start_epoch, max_test_acc = self._enter_mid_level(level) if ckpt_every else (0, 0.0)
        for epoch in range(start_epoch, epochs_per_level):
            row = {"level": level, "epoch": epoch}
            max_test_acc = self._run_epoch(row, max_test_acc, snapshot_ok=level == 0)
            # The level's last epoch is saved as model_level_{level}.
            if ckpt_every and (epoch + 1) % ckpt_every == 0 and epoch + 1 < epochs_per_level:
                self.ckpts.save_mid_level(level, epoch, self.state, meta={
                    "max_test_acc": max_test_acc,
                    "config_hash": self.config_hash,
                    "run_id": self.run_id,
                    "train_loader_epoch": getattr(self.loaders.train_loader, "epoch", 0),
                    # Plain float and int rows: the level CSV survives.
                    "level_rows": self.metrics.level_rows,
                })

        return self.metrics.finish_level(
            level,
            {
                "density": density,
                "final_sparsity": masking.overall_sparsity(self.state.masks),
            },
        )

    def _run_epoch(self, row: dict, max_test_acc: float, snapshot_ok: bool) -> float:
        """Train and evaluate one epoch, log ``row`` (which holds its level
        and epoch) and, where ``snapshot_ok`` and the epoch is
        ``rewind_epoch``, save the rewind snapshot. Returns the level's
        best test accuracy so far."""
        row.update(self.train_epoch())
        row.update(self.evaluate())
        max_test_acc = max(max_test_acc, row["test_acc"])
        row["max_test_acc"] = max_test_acc
        row["sparsity"] = masking.overall_sparsity(self.state.masks)
        self.metrics.log_epoch(row)
        self._log_console(row)
        if snapshot_ok and row["epoch"] == self.cfg.pruning_params.rewind_epoch:
            self.ckpts.save_model(MODEL_REWIND, self.state.model_tree())
            self.ckpts.save_optimizer(OPTIMIZER_REWIND, self.state.optimizer)
        return max_test_acc

    def _enter_mid_level(self, level: int) -> tuple[int, float]:
        """Restore the mid-level slot if it belongs to this level and
        config; returns (first epoch to train, the level's best test
        accuracy so far). A slot of another config or level, or a torn
        one, is cleared and the level trains from epoch 0."""
        mid = self.ckpts.peek_mid_level()
        if mid is None:
            return 0, 0.0
        restored = None
        if mid.get("config_hash") != self.config_hash:
            print(
                "[resume] REFUSING mid-level restore: slot config hash "
                f"{mid.get('config_hash')!r} != current {self.config_hash!r} "
                f"(run {mid.get('run_id')!r}) — the config changed since the "
                "slot was written; replaying the level from its start",
                flush=True,
            )
        elif mid["level"] == level:
            restored = self.ckpts.load_mid_level(level, mid["epoch"])
            if restored is None:
                print(
                    "[resume] mid-level slot is torn (header/state disagree) — "
                    "replaying the level",
                    flush=True,
                )
        if restored is None:
            self.ckpts.clear_mid_level()
            return 0, 0.0
        self.state.model.load_state_dict(model_state_dict(restored))
        self.state.masks = {p: m.to(self.device) for p, m in restored["masks"].items()}
        self.state.optimizer.load_state_dict(restored["optimizer"])
        self.state.step = int(restored["step"])
        # The rows before the preemption, so the level CSV and its best
        # test accuracy cover the whole level.
        self.metrics.level_rows = [dict(r) for r in mid.get("level_rows", [])]
        self._restore_train_stream(mid)
        start_epoch = mid["epoch"] + 1
        print(
            f"[resume] mid-level checkpoint: re-entering level {level} at "
            f"epoch {start_epoch}",
            flush=True,
        )
        return start_epoch, mid.get("max_test_acc", 0.0)

    def _restore_train_stream(self, mid: dict) -> None:
        """The train loader's data order at the slot. A loader whose epoch
        counter is its whole state (augmentation and shuffle drawn from
        (seed, epoch)) gets the counter back, which is exact; any other
        takes a fresh pass, with a warning. (The stream-position loaders
        of the JAX package are not ported yet: ROADMAP.md queue A, item
        14.)"""
        train_loader = self.loaders.train_loader
        if hasattr(train_loader, "epoch"):
            train_loader.epoch = mid["train_loader_epoch"]
            return
        print(
            "[resume] WARNING: the resumed run sees a fresh shuffle pass — "
            "statistically equivalent, NOT bit-identical to an "
            "uninterrupted run",
            flush=True,
        )

    def _log_console(self, row: dict) -> None:
        # Rows of the cyclic harness carry their cycle.
        cycle = f" C{row['cycle']}" if "cycle" in row else ""
        print(
            f"[L{row['level']:>2}{cycle} E{row['epoch']:>3}] "
            f"train {row['train_loss']:.4f}/{row['train_acc']:5.2f}% "
            f"test {row['test_loss']:.4f}/{row['test_acc']:5.2f}% "
            f"(best {row['max_test_acc']:5.2f}%) "
            f"sparsity {row['sparsity']:5.2f}% "
            f"{row['samples_per_sec']:,.0f} img/s",
            flush=True,
        )
