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

import contextlib
import itertools
import time
from pathlib import Path
from typing import Iterator

import torch

from ..config.schema import MainConfig
from ..data import create_loaders
from ..models import create_model
from ..ops import masking
from ..train import (
    DropoutNoise,
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

# A streaming loader's prefetch-engine stage times, in each epoch's row.
PIPELINE_STAGES = ("decode_wait_s", "transfer_wait_s", "consumer_wait_s")

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
        # Dropout's uniforms: one generator on the device, reseeded from
        # (seed, step) at every step (train.DropoutNoise).
        self.dropout_noise = DropoutNoise(self.device, ep.seed)
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
        self._train_step = make_train_step(schedule, self._train_forward, self.dropout_noise)
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
    def train_batches(self) -> Iterator[tuple]:
        """The epoch's train batches, at most ``steps_per_epoch``. A
        streaming loader with ``iter_chunks`` (.tpk) takes the chunked path
        when ``dataset_params.scan_chunk_steps`` K > 1: the prefetch engine
        moves K batches to the device as one [K, B, ...] chunk and the
        steps run over its slices (the JAX package runs a chunk as one
        scanned program; here each slice is one step, eager or compiled);
        a tail of fewer than K batches comes per batch. Either path feeds
        the step the same batches in the same order."""
        loader = self.loaders.train_loader
        chunk = self.cfg.dataset_params.scan_chunk_steps
        if chunk > 1 and hasattr(loader, "iter_chunks"):
            stream = items = loader.iter_chunks(chunk, max_batches=self.steps_per_epoch)
        else:
            stream = iter(loader)
            items = itertools.islice(stream, self.steps_per_epoch)
        try:
            for images, labels in items:
                if images.dim() == 5:
                    yield from zip(images.unbind(0), labels.unbind(0))
                else:
                    yield images, labels
        finally:
            # Stops a streaming loader's engine now, not when the iterator
            # is collected, so its stage times are final for this epoch.
            close = getattr(stream, "close", None)
            if close is not None:
                close()

    def train_epoch(self) -> dict:
        """One pass over the train loader, at most ``steps_per_epoch``
        steps. Returns host-side epoch means, and a streaming loader's
        pipeline stage times (``decode_wait_s``, ``transfer_wait_s``,
        ``consumer_wait_s``)."""
        sums = None
        t0 = time.perf_counter()
        with contextlib.closing(self.train_batches()) as batches:
            for batch in batches:
                sums = add_sums(sums, self._train_step(self.state, batch))
        if sums is None:
            raise RuntimeError(
                "train loader yielded no batches — dataset smaller than "
                "total_batch_size with drop_last?"
            )
        sums = {k: float(v) for k, v in sums.items()}  # waits for the device
        wall = time.perf_counter() - t0
        n = sums["count"]
        out = {
            "train_loss": sums["loss_sum"] / n,
            "train_acc": 100.0 * sums["correct"] / n,
            "epoch_seconds": wall,
            "samples_per_sec": n / wall,
        }
        stats = getattr(self.loaders.train_loader, "last_pipeline_stats", None)
        if stats is not None:
            out.update({k: stats[k] for k in PIPELINE_STAGES})
        return out

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
                self._save_mid_level(level, epoch, max_test_acc)

        return self.metrics.finish_level(
            level,
            {
                "density": density,
                "final_sparsity": masking.overall_sparsity(self.state.masks),
            },
        )

    def _save_mid_level(self, level: int, epoch: int, max_test_acc: float) -> None:
        """The slot after ``epoch`` of ``level``; a stream-position loader's
        state goes beside it, tagged for this save."""
        train_loader = self.loaders.train_loader
        meta = {
            "max_test_acc": max_test_acc,
            "config_hash": self.config_hash,
            "run_id": self.run_id,
            "train_loader_epoch": getattr(train_loader, "epoch", 0),
            # Plain float and int rows: the level CSV survives.
            "level_rows": self.metrics.level_rows,
        }
        get_stream = getattr(train_loader, "get_stream_state", None)
        if get_stream is not None:
            # One process: its blob is file 0 (the JAX package writes one
            # per host).
            self.ckpts.save_mid_level_stream(level, epoch, get_stream(), 0)
            meta["train_loader_stream_hosts"] = 1
        self.ckpts.save_mid_level(level, epoch, self.state, meta=meta)

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
        self._restore_train_stream(mid, level)
        start_epoch = mid["epoch"] + 1
        print(
            f"[resume] mid-level checkpoint: re-entering level {level} at "
            f"epoch {start_epoch}",
            flush=True,
        )
        return start_epoch, mid.get("max_test_acc", 0.0)

    def _restore_train_stream(self, mid: dict, level: int) -> str:
        """The train loader's data order at the slot, in three tiers; returns
        the tier taken ("stream", "epoch" or "fresh"):

        1. a stream-position loader (``set_stream_state``) takes its blob
           when the slot names one, the blob is tagged for this save and
           the loader accepts it (exact);
        2. a loader whose epoch counter is its whole state
           (``resumable_epochs``, true unless the loader says otherwise:
           synthetic, CIFAR, .tpk) gets the counter back (exact);
        3. anything else takes a fresh pass, with a warning."""
        train_loader = self.loaders.train_loader
        epoch = mid["train_loader_epoch"]
        if mid.get("train_loader_stream_hosts") and hasattr(train_loader, "set_stream_state"):
            blob = None
            if mid["train_loader_stream_hosts"] == 1:
                blob = self.ckpts.load_mid_level_stream(level, mid["epoch"], 0)
            if blob is None:
                print(
                    "[resume] stream-state blob missing or from another save or "
                    "process count; falling back to a fresh shuffle pass",
                    flush=True,
                )
            else:
                try:
                    train_loader.set_stream_state(blob)
                except ValueError as e:  # another loader's state
                    print(f"[resume] stream state rejected ({e}); falling back "
                          "to a fresh shuffle pass", flush=True)
                else:
                    train_loader.epoch = epoch
                    return "stream"
        elif getattr(train_loader, "resumable_epochs", True) and hasattr(train_loader, "epoch"):
            train_loader.epoch = epoch
            return "epoch"
        print(
            "[resume] WARNING: the resumed run sees a fresh shuffle pass — "
            "statistically equivalent, NOT bit-identical to an "
            "uninterrupted run",
            flush=True,
        )
        return "fresh"

    def _log_console(self, row: dict) -> None:
        # Rows of the cyclic harness carry their cycle.
        cycle = f" C{row['cycle']}" if "cycle" in row else ""
        print(
            f"[L{row['level']:>2}{cycle} E{row['epoch']:>3}] "
            f"train {row['train_loss']:.4f}/{row['train_acc']:5.2f}% "
            f"test {row['test_loss']:.4f}/{row['test_acc']:5.2f}% "
            f"(best {row['max_test_acc']:5.2f}%) "
            f"sparsity {row['sparsity']:5.2f}% "
            f"{row['samples_per_sec']:,.0f} img/s"
            + ("" if PIPELINE_STAGES[0] not in row else
               " (waits s: " + ", ".join(f"{k[:-7]} {row[k]:.3f}" for k in PIPELINE_STAGES) + ")"),
            flush=True,
        )
