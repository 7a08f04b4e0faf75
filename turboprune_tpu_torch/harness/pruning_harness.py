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

Sparse execution (``experiment_params.compact_train`` and/or
``nm_sparsity``): at each level's start, after any mid-level restore, one
planner (``sparse.plan_execution``) derives an ExecutionPlan from the live
masks: slice the whole train state onto a physically smaller model where
dead channels clear ``planner.compact_min_savings``, gather the surviving
N:M contractions, stay masked-dense where neither pays. The level then
trains on the plan's model (its own module objects, a fresh optimizer
holding the sliced state; under ``use_compile`` its own compiled graphs)
and, in a ``finally``, is scattered back into the full state it entered
with (``_exit_plan``). Everything that leaves a level is in full
coordinates: the level and rewind checkpoints, the mid-level slot, the
CSV's sparsity, the driver's prune. ``compact_eval`` evaluates on the
compacted model (``compact_params``) when no plan is live.

Pretrained weights (``model_params.pretrained_path``, a local timm DeiT
state_dict, ``models/pretrained.py``) land on the fresh CPU init before
it moves to the device, so the level-0 ``model_init`` save (the imp rewind
target) and any mask computed from the weights see them. With
``ScheduleFreeSGD`` every evaluation reads the optimizer's averaged
weights (``train.eval_weights``). With ``experiment_params.use_wandb``
every epoch row also goes to wandb (``utils/wandb_logging.py``).

Data parallel (a world of W processes launched by ``torchrun``, one per
device, ``parallel/``): the harness lays the world out as a (data =
W / M, model = M) mesh (``experiment_params.num_devices`` 0 or W,
``model_parallelism`` M), broadcasts rank 0's initial weights, gives the
BatchNorm layers the data group (global-batch statistics), and steps each
rank on its data row's rows of the global batch with the gradients
averaged over the data group. With M > 1 (``attention_impl: ring``) the M
ranks of a model row hold the same rows and share each sequence: the
model's ring attention shards the tokens over them (``parallel/ring.py``),
and everything else runs replicated on them; a host-scope loader shards by
data row. Epoch and evaluation sums are all-reduced over the data group,
so every rank logs the global numbers;
the CSVs, wandb, the console and every checkpoint are written by the
primary, except each rank's own train-stream position in the mid-level
slot. Before a plan re-instantiates the model, every rank asserts that it
derived the same widths.

With ``experiment_params.profile_dir``, level 0's second training pass
(``traces_epoch``) runs under ``torch.profiler`` and leaves one trace per
process, ``rank{r}.pt.trace.json``, in that directory; the evaluation
stays outside it, as in the JAX harness. A level resumed past that epoch
takes no trace.

The compiled step in a world of more than one process raises, naming
its ROADMAP.md item (13c).
"""

from __future__ import annotations

import contextlib
import itertools
import time
import types
from pathlib import Path
from typing import Iterator, Optional

import torch

from ..config.schema import MainConfig, parse_nm
from ..data import create_loaders
from ..models import create_model
from ..models.pretrained import load_pretrained
from ..ops import masking
from ..parallel import (
    all_reduce_sums,
    assert_width_agreement,
    broadcast_module,
    create_mesh,
    process_count,
    process_index,
    say,
    set_batchnorm_group,
    shard_batch,
)
from ..serve.metrics import ServeMetrics
from ..sparse import (
    build_graph,
    check_divisibility,
    compact_params,
    compact_train_state,
    expand_train_state,
    model_leaves,
    plan_execution,
)
from ..sparse.graph import state_key
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
    eval_weights,
    make_train_step,
    mark_buffers_static,
    reset_optimizer,
    restart_schedule,
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
from ..utils.wandb_logging import WandbRun

# A streaming loader's prefetch-engine stage times, in each epoch's row.
PIPELINE_STAGES = ("decode_wait_s", "transfer_wait_s", "consumer_wait_s")

PRECISION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def traces_epoch(profile_dir: str, level: int, epoch: int) -> bool:
    """Whether ``experiment_params.profile_dir`` traces this epoch's
    training pass: level 0's second epoch (its first pays the kernels'
    builds and the allocator's growth), as in the JAX package."""
    return bool(profile_dir) and level == 0 and epoch == 1


@contextlib.contextmanager
def epoch_trace(profile_dir: str, device: torch.device, rank: int) -> Iterator[None]:
    """``torch.profiler`` around the body (CPU activity, plus CUDA activity
    on a CUDA device), written as a Chrome/TensorBoard trace
    ``rank{rank}.pt.trace.json`` into ``profile_dir``. The device is
    synchronised before the profile closes, so the body's last kernels are
    in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = out / f"rank{rank}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    say(f"[profile] level 0 epoch 1 training pass traced: {path}")


class PruningHarness:
    """Trainer for one experiment on this process's device."""

    def __init__(
        self,
        cfg: MainConfig,
        expt_dir: tuple[str, str],
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.prefix, self.expt_dir = expt_dir
        self.device = resolve_device(device)
        ep = cfg.experiment_params
        dp = cfg.dataset_params
        op = cfg.optimizer_params
        self.mesh = create_mesh(ep.num_devices, ep.model_parallelism)
        if dp.total_batch_size % self.mesh.data_size:
            raise ValueError(
                f"total_batch_size={dp.total_batch_size} not divisible by the data "
                f"axis's {self.mesh.data_size} processes — adjust total_batch_size "
                "or num_devices")
        if cfg.model_params.use_compile and process_count() > 1:
            raise NotImplementedError(
                "model_params.use_compile in a world of more than one process is "
                "not yet ported to turboprune_tpu_torch (ROADMAP.md queue A, "
                "item 13c): the BatchNorm all-reduce and ring attention's "
                "point-to-point hops would run inside the compiled graphs")
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
            mesh=self.mesh,
        )
        model.init_weights(torch.Generator().manual_seed(ep.seed))
        stuff = ep.resume_experiment_stuff
        resumes_from_a_level = ep.resume_experiment and stuff is not None and stuff.resume_level > 0
        if cfg.model_params.pretrained_path and not resumes_from_a_level:
            # The fresh init only: a run resumed at a level > 0 takes every
            # weight from the level below's checkpoint.
            load_pretrained(cfg.model_params.pretrained_path, model)
        self.model = model.to(self.device)
        # Rank 0's weights on every rank (each drew the same from the seed;
        # this makes it so whatever a rank loaded), and the data group the
        # BatchNorm statistics are taken over.
        broadcast_module(self.model, self.mesh)
        set_batchnorm_group(self.model, self.mesh)
        self.loaders = create_loaders(cfg, self.device,
                                      shard=(self.mesh.data_rank, self.mesh.data_size))
        self.ckpts = ExperimentCheckpoints(self.expt_dir)
        # The mid-level slot's identity: a slot stamped with another config
        # is never restored.
        self.config_hash = config_fingerprint(cfg)
        self.run_id = Path(self.expt_dir).name
        self.metrics = MetricsLogger(self.expt_dir, self.prefix)
        self.wandb = WandbRun(cfg, self.prefix, self.expt_dir)
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
        # Sparse execution: the per-plan bundle (model, train step, eval
        # forward) cached by (total_steps, width key, nm key); the
        # compacted eval model cached by its width key; _plan_ctx holds the
        # live plan, the full state it entered with and the dense step
        # (None <=> training masked-dense). The plan reports and cache
        # sizes go out on compact_metrics.
        self._plan_step_cache: dict[tuple, tuple] = {}
        self._plan_eval_cache: dict[tuple, tuple] = {}
        self._plan_ctx: Optional[dict] = None
        self.last_plan_report: Optional[dict] = None
        self.last_compaction_report: Optional[dict] = None
        if ep.nm_sparsity:
            # Fail fast: a contraction width that does not divide into
            # M-blocks would otherwise surface at the first prune, a level
            # of training later.
            check_divisibility(self.state.masks, parse_nm(ep.nm_sparsity)[1])
        self.compact_metrics = ServeMetrics()

    def _plan_forwards(self, model) -> tuple:
        """(train, eval) forwards for a plan's ``model``: eager, or under
        ``use_compile`` compiled from copies of the functions with code
        objects of their own (dynamo keeps graphs and guards per code
        object, so a plan's graphs go with its cache entry and never count
        against the full model's recompile limit)."""
        if not self.cfg.model_params.use_compile:
            return train_forward, eval_forward
        mark_buffers_static(model)
        return tuple(compile_forward(_own_code(fn), self.device)
                     for fn in (train_forward, eval_forward))

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
        self._current_epochs = epochs
        self._schedule = schedule
        self._train_step = make_train_step(schedule, self._train_forward, self.dropout_noise,
                                           self.mesh)
        self.state = reset_optimizer(self.state, self._make_optimizer)

    def maybe_rewind_optimizer(self, level: int) -> None:
        """WR + ``rewind_optimizer``: restore the optimizer state captured
        at rewind_epoch. The schedule still restarts from step 0: the lr
        comes from the level's own step count, which the restore leaves
        at 0; Adam's own step count comes back with its moments, and
        schedule-free SGD's averaging count with its ``z``
        (``restart_schedule``)."""
        pp = self.cfg.pruning_params
        if level > 0 and pp.training_type == "wr" and pp.rewind_optimizer:
            self.state.optimizer.load_state_dict(self.ckpts.load_optimizer(OPTIMIZER_REWIND))
            restart_schedule(self.state.optimizer)

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
        scope = getattr(loader, "batch_scope", "global")
        try:
            for images, labels in items:
                if images.dim() == 5:
                    for batch in zip(images.unbind(0), labels.unbind(0)):
                        yield shard_batch(batch, self.mesh, scope)
                else:
                    yield shard_batch((images, labels), self.mesh, scope)
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
            for batch in batches:  # torchlint: hot-loop
                sums = add_sums(sums, self._train_step(self.state, batch))
        if sums is None:
            raise RuntimeError(
                "train loader yielded no batches — dataset smaller than "
                "total_batch_size with drop_last?"
            )
        sums = all_reduce_sums(sums, self.mesh)
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
        """Full test pass; padded rows (label -1) count nowhere. With
        ``compact_eval`` and no live plan, on the compacted model; with a
        plan live, the plan's model is the level's compact evaluation.
        With schedule-free SGD, on its averaged weights, swapped into the
        params' storage for the pass (``compact_eval`` folds and compacts
        them) and the trained weights copied back after."""
        with eval_weights(self.state.optimizer):
            if self.cfg.experiment_params.compact_eval and self._plan_ctx is None:
                return self._evaluate_compacted()
            return self._evaluate_on(self.state.model, self.state.masks, self._eval_forward)

    def _evaluate_on(self, model, masks, forward) -> dict:
        sums = None
        loader = self.loaders.test_loader
        scope = getattr(loader, "batch_scope", "global")
        for batch in loader:  # torchlint: hot-loop
            batch = shard_batch(batch, self.mesh, scope)
            sums = add_sums(sums, eval_step(model, masks, batch, forward))
        if sums is None:
            raise RuntimeError("test loader yielded no batches")
        sums = all_reduce_sums(sums, self.mesh)
        sums = {k: float(v) for k, v in sums.items()}
        n = sums["count"]
        return {
            "test_loss": sums["loss_sum"] / n,
            "test_acc": 100.0 * sums["correct"] / n,
        }

    def _evaluate_compacted(self) -> dict:
        """Test pass on the physically compacted model: the live masks
        analysed, dead channels sliced out of the mask-folded params
        (``compact_params``), the small model (cached by its widths, so a
        level's epochs reuse it) evaluates with all-ones masks, an exact
        no-op on the folded params."""
        params, stats = model_leaves(self.state.model)
        res = compact_params(params, self.state.masks,
                             build_graph(self.state.model, params), stats)
        self.last_compaction_report = res.report
        key = res.as_override_tuple()
        if key not in self._plan_eval_cache:
            self._evict_stale_plan_caches(key)
            model = self._small_model(res.width_overrides)
            self._plan_eval_cache[key] = (model, masking.make_masks(model),
                                          self._plan_forwards(model)[1])
            self._export_cache_gauges()
        model, masks, forward = self._plan_eval_cache[key]
        model.load_state_dict({state_key(p): t for p, t in {**res.params, **res.batch_stats}.items()})
        return self._evaluate_on(model, masks, forward)

    # ----------------------------------------------------- plan execution
    def _small_model(self, width_overrides, nm_overrides=None):
        """The architecture at compacted widths and/or with gathered N:M
        hooks, on the device (weights come from the state it takes). Ring
        attention becomes its param-identical dense attention, as in the
        JAX package and in serving: the small model runs replicated on the
        ranks of a ring, not sequence-sharded."""
        cfg = self.cfg
        attention_impl = cfg.model_params.attention_impl
        if attention_impl == "ring":
            attention_impl = "dense"
        return create_model(
            cfg.model_params.model_name,
            num_classes=cfg.dataset_params.num_classes,
            dataset_name=cfg.dataset_params.dataset_name,
            compute_dtype=self.compute_dtype,
            attention_impl=attention_impl,
            image_size=cfg.dataset_params.image_size,
            width_overrides=width_overrides,
            nm_overrides=nm_overrides,
        ).to(self.device)

    def _enter_plan(self) -> None:
        """Derive this level's ExecutionPlan from the live masks and move
        the level onto it. When compaction commits, the full state at entry
        is the anchor: at exit (and for any checkpoint written inside the
        level) the trained small state is scattered back over it, so
        removed coordinates come back as the dense run leaves them (exactly
        for weight_decay 0 with the per-level fresh optimizer: a removed
        coordinate sees zero gradient and zero momentum). An N:M plan moves
        the state onto a model with the gathered modules at full widths."""
        ep = self.cfg.experiment_params
        if self._plan_ctx is not None:
            return
        compact_mode = "auto" if ep.compact_train else "off"
        nm_mode = "auto" if ep.nm_sparsity else "off"
        if compact_mode == "off" and nm_mode == "off":
            return
        pl = self.cfg.planner
        params, stats = model_leaves(self.state.model)
        plan = plan_execution(
            self.state.model, params, self.state.masks, stats,
            compact=compact_mode,
            nm=nm_mode,
            compact_min_savings=pl.compact_min_savings,
            nm_min_axis_savings=pl.nm_min_axis_savings,
            autotune=pl.autotune,
        )
        # A collective: every rank calls it, also when nothing compacts,
        # before any model is re-instantiated at the plan's widths.
        assert_width_agreement(plan.plan_signature())
        self.last_plan_report = plan.report
        self.compact_metrics.record_plan(plan.report)
        if plan.kind == "masked":
            return  # neither backend pays at this level
        if plan.compaction is not None:
            self.last_compaction_report = plan.compaction.report
        width_key, nm_key = plan.width_key(), plan.nm_key()
        key = (self._current_epochs * self.steps_per_epoch, width_key, nm_key)
        self._evict_stale_plan_caches(width_key, nm_key)
        if key not in self._plan_step_cache:
            model = self._small_model(plan.width_overrides, plan.nm_overrides)
            set_batchnorm_group(model, self.mesh)
            forward, eval_fwd = self._plan_forwards(model)
            self._plan_step_cache[key] = (
                model, make_train_step(self._schedule, forward, self.dropout_noise, self.mesh),
                eval_fwd)
        self._export_cache_gauges()
        model, train_step, eval_fwd = self._plan_step_cache[key]
        self._plan_ctx = {"plan": plan, "anchor": self.state,
                          "dense": (self._train_step, self._eval_forward)}
        self.state = compact_train_state(self.state, plan.compaction, model, self._make_optimizer)
        self._train_step, self._eval_forward = train_step, eval_fwd
        r = plan.report
        parts = []
        if plan.compaction is not None:
            comp = r["compaction"]
            parts.append(f"params {comp['params_before']:,} -> {comp['params_after']:,} "
                         f"({r['backend_counts']['compact_spaces']} spaces)")
        if plan.nm is not None:
            parts.append(f"{r['backend_counts']['nm_layers']} layers gathered "
                         f"(coverage {r['coverage_frac']:.2f})")
        say(f"[plan] level runs {plan.kind}: " + ", ".join(parts))

    def _exit_plan(self) -> None:
        """Back to full coordinates and the masked-dense step. Idempotent;
        called in a ``finally``, so a raising epoch cannot leave the
        harness on a plan's shapes."""
        ctx = self._plan_ctx
        if ctx is None:
            return
        self._plan_ctx = None
        self._train_step, self._eval_forward = ctx["dense"]
        self.state = expand_train_state(self.state, ctx["plan"].compaction, ctx["anchor"])

    def _full_state(self) -> TrainState:
        """The live state in full coordinates: what every checkpoint
        written inside a level (rewind artifacts, the mid-level slot)
        holds, so a restore never learns the level ran on a plan."""
        ctx = self._plan_ctx
        if ctx is None:
            return self.state
        return expand_train_state(self.state, ctx["plan"].compaction, ctx["anchor"])

    def _full_masks(self):
        """Full-coordinate masks for the metric rows (masks never change
        inside a level: while on a plan, the anchor's are the current)."""
        return self.state.masks if self._plan_ctx is None else self._plan_ctx["anchor"].masks

    def _evict_stale_plan_caches(self, width_key: tuple, nm_key: Optional[tuple] = None) -> None:
        """The ladder only descends: bundles for another plan signature
        are never hit again (their models and compiled graphs would pin
        device memory). ``nm_key=None`` (compact eval) evicts on widths."""
        for k in [k for k in self._plan_step_cache
                  if k[1] != width_key or (nm_key is not None and k[2] != nm_key)]:
            del self._plan_step_cache[k]
        for k in [k for k in self._plan_eval_cache if k != width_key]:
            del self._plan_eval_cache[k]

    def _export_cache_gauges(self) -> None:
        self.compact_metrics.set_gauge("plan_step_cache_size", len(self._plan_step_cache))
        self.compact_metrics.set_gauge("plan_eval_cache_size", len(self._plan_eval_cache))

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
        # After any mid-level restore: the plan is derived from (and
        # anchored at) the restored full state.
        self._enter_plan()
        try:
            profile_dir = self.cfg.experiment_params.profile_dir
            for epoch in range(start_epoch, epochs_per_level):
                row = {"level": level, "epoch": epoch}
                max_test_acc = self._run_epoch(
                    row, max_test_acc, snapshot_ok=level == 0,
                    trace_dir=profile_dir if traces_epoch(profile_dir, level, epoch) else "")
                # The level's last epoch is saved as model_level_{level}.
                if ckpt_every and (epoch + 1) % ckpt_every == 0 and epoch + 1 < epochs_per_level:
                    self._save_mid_level(level, epoch, max_test_acc)
        finally:
            self._exit_plan()

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
            # Every rank writes its own blob (its shard's position); the
            # header, written by the primary, says how many there are.
            self.ckpts.save_mid_level_stream(level, epoch, get_stream(), process_index())
            meta["train_loader_stream_hosts"] = process_count()
        self.ckpts.save_mid_level(level, epoch, self._full_state(), meta=meta)

    def _run_epoch(self, row: dict, max_test_acc: float, snapshot_ok: bool,
                   trace_dir: str = "") -> float:
        """Train and evaluate one epoch, log ``row`` (which holds its level
        and epoch) and, where ``snapshot_ok`` and the epoch is
        ``rewind_epoch``, save the rewind snapshot. With ``trace_dir``, the
        training pass (not the evaluation) is traced into it. Returns the
        level's best test accuracy so far."""
        with (epoch_trace(trace_dir, self.device, process_index()) if trace_dir
              else contextlib.nullcontext()):
            row.update(self.train_epoch())
        row.update(self.evaluate())
        max_test_acc = max(max_test_acc, row["test_acc"])
        row["max_test_acc"] = max_test_acc
        row["sparsity"] = masking.overall_sparsity(self._full_masks())
        self.metrics.log_epoch(row)
        self.wandb.log(row)
        self._log_console(row)
        if snapshot_ok and row["epoch"] == self.cfg.pruning_params.rewind_epoch:
            full = self._full_state()
            self.ckpts.save_model(MODEL_REWIND, full.model_tree())
            self.ckpts.save_optimizer(OPTIMIZER_REWIND, full.optimizer)
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
            say("[resume] REFUSING mid-level restore: slot config hash "
                f"{mid.get('config_hash')!r} != current {self.config_hash!r} "
                f"(run {mid.get('run_id')!r}) — the config changed since the "
                "slot was written; replaying the level from its start")
        elif mid["level"] == level:
            restored = self.ckpts.load_mid_level(level, mid["epoch"])
            if restored is None:
                say("[resume] mid-level slot is torn (header/state disagree) — "
                    "replaying the level")
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
        say(f"[resume] mid-level checkpoint: re-entering level {level} at epoch {start_epoch}")
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
            if mid["train_loader_stream_hosts"] == process_count():
                blob = self.ckpts.load_mid_level_stream(level, mid["epoch"], process_index())
            if blob is None:
                say("[resume] stream-state blob missing or from another save or "
                    "process count; falling back to a fresh shuffle pass")
            else:
                try:
                    train_loader.set_stream_state(blob)
                except ValueError as e:  # another loader's state
                    say(f"[resume] stream state rejected ({e}); falling back "
                        "to a fresh shuffle pass")
                else:
                    train_loader.epoch = epoch
                    return "stream"
        elif getattr(train_loader, "resumable_epochs", True) and hasattr(train_loader, "epoch"):
            train_loader.epoch = epoch
            return "epoch"
        say("[resume] WARNING: the resumed run sees a fresh shuffle pass — "
            "statistically equivalent, NOT bit-identical to an "
            "uninterrupted run")
        return "fresh"

    def _log_console(self, row: dict) -> None:
        # Rows of the cyclic harness carry their cycle.
        cycle = f" C{row['cycle']}" if "cycle" in row else ""
        say(
            f"[L{row['level']:>2}{cycle} E{row['epoch']:>3}] "
            f"train {row['train_loss']:.4f}/{row['train_acc']:5.2f}% "
            f"test {row['test_loss']:.4f}/{row['test_acc']:5.2f}% "
            f"(best {row['max_test_acc']:5.2f}%) "
            f"sparsity {row['sparsity']:5.2f}% "
            f"{row['samples_per_sec']:,.0f} img/s"
            + ("" if PIPELINE_STAGES[0] not in row else
               " (waits s: " + ", ".join(f"{k[:-7]} {row[k]:.3f}" for k in PIPELINE_STAGES) + ")"))


def _own_code(fn: types.FunctionType) -> types.FunctionType:
    """A copy of ``fn`` with a code object of its own."""
    return types.FunctionType(fn.__code__.replace(), fn.__globals__, fn.__name__,
                              fn.__defaults__, fn.__closure__)
