"""Typed, validated config schema (the port's copy).

A copy of ``turboprune_tpu/config/schema.py`` with the same dataclasses and
the same validation, so the port composes and checks the repo's ``conf/``
tree without importing the JAX package. Knob comments describe the
reference's behaviour; the port runs the knobs its slices have ported.

Mirrors the knob surface of the reference's config dataclasses
(/root/reference/utils/harness_params.py:1-101) but is actually enforced:
every composed config is instantiated into these dataclasses and every
Literal-style choice is checked (the reference never registered its schema,
so it validated nothing — SURVEY.md §2.1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Optional

# Choice sets (reference: harness_params.py Literals).
DATASETS = ("CIFAR10", "CIFAR100", "ImageNet")
DATALOADER_TYPES = ("device", "grain", "tpk", "synthetic")
MASK_LAYER_TYPES = ("ConvMask", "LinearMask")
PRUNE_METHODS = (
    "er_erk",
    "er_balanced",
    "random_erk",
    "random_balanced",
    "synflow",
    "snip",
    "mag",
    "nm",
    "just dont",
)
# N:M structured-sparsity patterns the gathered execution backend supports
# (sparse/nm.py). The string is parsed by ``parse_nm`` for shape errors
# (0:4, 5:4, ...) and then checked against this literal set so graftlint's
# conf-bad-choice rule knows the valid values.
NM_SPARSITY_PATTERNS = ("2:4", "4:8")
TRAINING_TYPES = ("imp", "wr", "lrr", "at_init")
# fp16 included for reference-parity (base_harness.py:92-101); on TPU
# bfloat16 is the native fast dtype and the recommended default (fp16 has
# no hardware advantage and a narrower exponent range).
PRECISIONS = ("bfloat16", "float16", "float32")
ATTENTION_IMPLS = ("dense", "ring", "flash")
OPTIMIZERS = ("SGD", "AdamW", "ScheduleFreeSGD")
SCHEDULERS = (
    "MultiStepLRWarmup",
    "ImageNetLRDropsWarmup",
    "TriangularSchedule",
    "ScheduleFree",
    "TrapezoidalSchedule",
    "OneCycleLR",
)
CYCLIC_STRATEGIES = (
    "linear_increase",
    "linear_decrease",
    "exponential_decrease",
    "exponential_increase",
    "cyclic_peak",
    "alternating",
    "plateau",
    "constant",
)


class ConfigError(ValueError):
    pass


def _check_choice(name: str, value: Any, choices: tuple) -> None:
    if value not in choices:
        raise ConfigError(f"{name}={value!r} not in {choices}")


def parse_nm(spec: str) -> tuple[int, int]:
    """Parse an ``"N:M"`` sparsity spec into ``(n, m)`` with clear errors.

    Rejects malformed strings and degenerate pairs loudly at compose time —
    ``0:4`` keeps nothing (every eligible layer would go all-zero), ``4:4``
    keeps everything (the projection would be an expensive no-op), ``5:4``
    is impossible. Divisibility against actual layer widths is checked where
    the widths are known (sparse/nm.py raises NMError there)."""
    if isinstance(spec, int):
        # YAML 1.1 parses an unquoted 2:4 as the base-60 integer 124 — by
        # far the likeliest way an int lands here. Fail with the fix, not
        # a baffling "124 is not of the form N:M".
        raise ConfigError(
            f"nm_sparsity={spec!r}: unquoted N:M is a YAML 1.1 base-60 "
            f"integer — quote the value, e.g. nm_sparsity='2:4'"
        )
    parts = str(spec).split(":")
    if len(parts) != 2:
        raise ConfigError(
            f"nm_sparsity={spec!r} is not of the form 'N:M' (e.g. '2:4')"
        )
    try:
        n, m = int(parts[0]), int(parts[1])
    except ValueError:
        raise ConfigError(
            f"nm_sparsity={spec!r}: N and M must be integers"
        ) from None
    if m < 2:
        raise ConfigError(f"nm_sparsity={spec!r}: M must be >= 2")
    if not (0 < n < m):
        raise ConfigError(
            f"nm_sparsity={spec!r}: need 0 < N < M — N=0 would zero every "
            f"eligible layer, N>=M keeps everything (no sparsity)"
        )
    return n, m


@dataclass
class DatasetConfig:
    dataset_name: str = "CIFAR10"
    data_root_dir: str = "./data"
    total_batch_size: int = 512
    num_workers: int = 16
    # "device": whole dataset resident in device memory (CIFAR);
    # "grain": host-side grain pipeline (ImageNet); "synthetic": generated data.
    dataloader_type: str = "device"
    # Image geometry; defaults filled per dataset_name in validate().
    image_size: int = 0
    num_classes: int = 0
    # Synthetic-loader sizes (dataloader_type=synthetic only).
    synthetic_num_train: int = 2048
    synthetic_num_test: int = 512
    # "easy": separable class-mean colors (saturates at 100% — loop tests);
    # "hard": template-mixture task whose accuracy sits below the ceiling
    # and bends with density (science-bearing runs). snr scales difficulty.
    synthetic_task: str = "easy"
    # 1.5 -> spectral-oracle ~96% at 32px/10 classes (tests/test_data.py).
    synthetic_snr: float = 1.5
    # Native packed-dataset loader (dataloader_type=tpk): .tpk file paths;
    # empty = <data_root_dir>/{train,val}.tpk. With tpk_auto_pack, missing
    # .tpk files are packed once from ImageFolder splits under data_root_dir
    # (the analog of FFCV's .beton writing step).
    tpk_train_path: str = ""
    tpk_val_path: str = ""
    tpk_auto_pack: bool = False
    tpk_nthreads: int = 0  # 0 = min(16, cpu_count)
    # Streaming pipeline engine (grain/tpk; data/pipeline.py): bounded count
    # of in-flight batches between decode and the consumer, and how many
    # decode tasks run concurrently (tpk only — grain's stream is serial;
    # its decode parallelism is num_workers worker processes).
    prefetch_depth: int = 4
    decode_workers: int = 2
    # Streamed chunked-scan train path: fuse K prefetched batches into ONE
    # compiled lax.scan dispatch (1 = per-step dispatch). Device-resident
    # loaders already scan whole epochs and ignore this knob.
    scan_chunk_steps: int = 1

    def validate(self) -> None:
        _check_choice("dataset_params.dataset_name", self.dataset_name, DATASETS)
        _check_choice(
            "dataset_params.dataloader_type", self.dataloader_type, DATALOADER_TYPES
        )
        if self.total_batch_size <= 0:
            raise ConfigError("total_batch_size must be positive")
        if self.dataloader_type == "synthetic":
            if self.synthetic_num_train < self.total_batch_size:
                raise ConfigError(
                    f"synthetic_num_train={self.synthetic_num_train} < "
                    f"total_batch_size={self.total_batch_size}: the train "
                    "loader would yield zero (drop_last) batches"
                )
            if self.synthetic_num_test < 1:
                raise ConfigError("synthetic_num_test must be >= 1")
            _check_choice(
                "dataset_params.synthetic_task", self.synthetic_task,
                ("easy", "hard"),
            )
            if self.synthetic_snr <= 0:
                raise ConfigError("synthetic_snr must be positive")
        if self.prefetch_depth < 1:
            raise ConfigError("prefetch_depth must be >= 1")
        if self.decode_workers < 1:
            raise ConfigError("decode_workers must be >= 1")
        if self.scan_chunk_steps < 1:
            raise ConfigError("scan_chunk_steps must be >= 1")
        if self.image_size == 0:
            self.image_size = 224 if self.dataset_name == "ImageNet" else 32
        if self.num_classes == 0:
            self.num_classes = {"CIFAR10": 10, "CIFAR100": 100, "ImageNet": 1000}[
                self.dataset_name
            ]


@dataclass
class ModelConfig:
    model_name: str = "resnet18"
    # Reference-parity knob: masks are pytree-applied here (ops/masking.py)
    # so the ConvMask/LinearMask wrapper distinction has no JAX analog; the
    # key is accepted so reference configs compose, and validated so typos
    # still fail.
    # torchlint: disable=conf-dead-schema-field -- reference-parity: accepted+validated for config compatibility, structurally meaningless in the pytree-mask port
    mask_layer_type: str = "ConvMask"
    # Reference knob `use_compile` toggles torch.compile
    # (standard_pruning_harness.py:141). In the port, true trains and
    # evaluates through the compiled step (train.steps.compile_forward):
    # the masked forward, the loss and the metric sums under
    # torch.compile(fullgraph=True), inductor with CUDA graphs on the card
    # (aot_eager on a CPU device), the backward from AOTAutograd; the
    # optimizer step stays eager. false runs the eager step.
    use_compile: bool = False
    # Local timm/DeiT torch checkpoint to warm-start ViT weights from
    # (reference deit.py:82-89 downloads these; no egress here, so the file
    # is staged by the user). Empty = random init. ViT models only.
    pretrained_path: str = ""
    # "ring" = sequence-parallel ring attention over the mesh model axis
    # (parallel/ring.py; pair with experiment_params.model_parallelism > 1);
    # "flash" = single-device blockwise Pallas kernel (ops/flash.py).
    # ViT models only; params/checkpoints identical across all three.
    attention_impl: str = "dense"

    def validate(self) -> None:
        _check_choice(
            "model_params.mask_layer_type", self.mask_layer_type, MASK_LAYER_TYPES
        )
        _check_choice(
            "model_params.attention_impl", self.attention_impl, ATTENTION_IMPLS
        )
        if self.pretrained_path and not self.model_name.startswith("deit"):
            raise ConfigError(
                "pretrained_path is only supported for deit_* models "
                f"(got model_name={self.model_name!r})"
            )
        if self.attention_impl != "dense" and not self.model_name.startswith("deit"):
            raise ConfigError(
                f"attention_impl={self.attention_impl} requires a deit_* "
                f"model (got model_name={self.model_name!r})"
            )


@dataclass
class PruneConfig:
    prune_rate: float = 0.2
    prune_method: str = "mag"
    target_sparsity: float = 0.999
    training_type: str = "imp"
    rewind_epoch: Optional[int] = None
    # WR only: also restore the optimizer state (momentum buffers) captured
    # at rewind_epoch when rewinding weights. The reference wrote this
    # artifact but never loaded it (dead reset_optimizer,
    # harness_utils.py:24-46); default False preserves that behavior.
    rewind_optimizer: bool = False

    def validate(self) -> None:
        _check_choice("pruning_params.prune_method", self.prune_method, PRUNE_METHODS)
        _check_choice(
            "pruning_params.training_type", self.training_type, TRAINING_TYPES
        )
        if not (0.0 <= self.target_sparsity < 1.0):
            raise ConfigError("target_sparsity must be in [0, 1)")
        if not (0.0 < self.prune_rate < 1.0) and self.prune_method in ("mag", "nm"):
            raise ConfigError("prune_rate must be in (0, 1) for iterative pruning")
        if self.training_type == "wr" and self.rewind_epoch is None:
            raise ConfigError("training_type=wr requires rewind_epoch")
        if self.rewind_epoch is not None and self.rewind_epoch < 0:
            raise ConfigError("rewind_epoch must be >= 0")
        if self.rewind_optimizer and self.training_type != "wr":
            raise ConfigError("rewind_optimizer is only meaningful for wr")


@dataclass
class ResumeExperimentConfig:
    resume_level: int = 0
    resume_expt_name: str = ""


@dataclass
class ExperimentConfig:
    seed: int = 0
    base_dir: str = "./experiments"
    epochs_per_level: int = 150
    training_precision: str = "bfloat16"
    # Documents that the run expects a launcher (the reference's DDP flag).
    # The port does not read it: like the JAX package, every run joins
    # whatever world the launcher made (torchrun's environment; none = one
    # process) and trains data-parallel across it (parallel/).
    distributed: bool = False
    resume_experiment: bool = False
    resume_experiment_stuff: Optional[ResumeExperimentConfig] = None
    wandb_project_name: str = "TurboPrune_runs"
    # Mesh axes sizes, as in the JAX package; 0 = every device of the world
    # on `data`. In the port one process drives one device, so any other
    # value must equal the launched world's size (parallel.create_mesh).
    num_devices: int = 0
    # Size of the mesh `model` axis (sequence/tensor parallelism); devices
    # are laid out (data = n/model_parallelism, model). 1 = pure DP, the
    # reference's only strategy (SURVEY.md §2.3); > 1 shards each sequence
    # over a ring of model_parallelism processes (attention_impl: ring).
    model_parallelism: int = 1
    # Cap on train/eval steps per epoch (0 = full epoch) — for smoke tests.
    max_steps_per_epoch: int = 0
    # NOTE: the reference's log_every_steps knob is deliberately absent:
    # the scan-epoch design has no per-step host loop to log from
    # (metrics come back as per-epoch sums), so the knob could only ever
    # be a silent no-op — graftlint's conf-dead-schema-field caught it.
    use_wandb: bool = False
    # When set, write a jax.profiler trace of level-0 epoch-1 here.
    profile_dir: str = ""
    # Epoch-granular checkpointing (0 = off): every N epochs the full train
    # state is saved to one rotating mid_level slot, and a resumed run
    # re-enters the interrupted level at the saved epoch instead of
    # replaying it (beyond-reference; for preemptible TPUs).
    checkpoint_every_epochs: int = 0
    # Opt-in: run the per-epoch test pass on the dead-channel-COMPACTED
    # model (sparse/compact.py) instead of the masked-dense forward.
    # Numerically equivalent up to fp reassociation; the per-level
    # compaction report lands on harness.last_compaction_report.
    compact_eval: bool = False
    # Compact-as-you-train (sparse/train_compact.py): when a level's masks
    # contain enough dead channels, slice the WHOLE train state, rebuild
    # the model at the smaller widths, and run the level's epochs on the
    # physically smaller program — expanding back to full coordinates
    # before pruning, rewind saves and checkpoints (README "Sparsity
    # execution"). Levels below planner.compact_min_savings stay dense.
    compact_train: bool = False
    # N:M structured sparsity (sparse/nm.py): "" / null = off. When set,
    # every prune step projects the masks of matmul-heavy layers onto the
    # highest-magnitude-preserving N:M pattern and the level loop swaps
    # those layers onto the gathered reduced-width execution path
    # (sparse/nm_execute.py). Composes with compact_train: channels are
    # compacted first, the survivors get the N:M treatment.
    nm_sparsity: Optional[str] = ""
    # Transposable variant: the pattern satisfies N:M along BOTH matmul
    # axes so the backward dx contraction also runs reduced (TSENOR-style
    # alternating solver). False = input-axis-only greedy projection.
    nm_transposable: bool = True

    def validate(self) -> None:
        _check_choice(
            "experiment_params.training_precision", self.training_precision, PRECISIONS
        )
        if self.nm_sparsity:
            parse_nm(self.nm_sparsity)
            _check_choice(
                "experiment_params.nm_sparsity", self.nm_sparsity,
                NM_SPARSITY_PATTERNS,
            )
        if self.epochs_per_level <= 0:
            raise ConfigError("epochs_per_level must be positive")
        if self.model_parallelism < 1:
            raise ConfigError("model_parallelism must be >= 1")
        if self.checkpoint_every_epochs < 0:
            raise ConfigError("checkpoint_every_epochs must be >= 0")


@dataclass
class OptimizerConfig:
    optimizer_name: str = "SGD"
    lr: float = 0.2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    scheduler_type: str = "TriangularSchedule"
    warmup_fraction: float = 0.2

    def validate(self) -> None:
        _check_choice(
            "optimizer_params.optimizer_name", self.optimizer_name, OPTIMIZERS
        )
        _check_choice(
            "optimizer_params.scheduler_type", self.scheduler_type, SCHEDULERS
        )
        if not (0.0 <= self.warmup_fraction <= 1.0):
            raise ConfigError("warmup_fraction must be in [0, 1]")


# Execution-planner autotune modes (sparse/plan.py): off = threshold
# routing only; cost = analytic gather-overhead model demotes N:M layers
# that would lose to masked-dense; measure = per-layer jitted micro-bench
# on the host platform decides instead.
PLANNER_AUTOTUNE_MODES = ("off", "cost", "measure")


@dataclass
class PlannerConfig:
    """Execution-planner routing knobs (sparse/plan.py): ONE config surface
    for the thresholds that decide which sparse backend each level/layer
    runs, shared by the harness, serving, and the bench."""

    # Minimum fraction of parameters channel-slicing must remove before a
    # level is re-instantiated physically smaller (compile + state-slice
    # overhead must be worth it). 0 re-instantiates on any nonzero
    # shrinkage — serving uses 0 internally (no optimizer state to slice).
    compact_min_savings: float = 0.25
    # Minimum fraction of the contraction axis the gathered N:M path must
    # drop before a layer routes through it — below that the gather
    # overhead eats the reduced-GEMM win. Any projected N:M pattern
    # (N/M <= 1/2) clears the default.
    nm_min_axis_savings: float = 0.25
    # Autotune pass over the routed N:M layers vs the masked-dense floor.
    autotune: str = "off"

    def validate(self) -> None:
        _check_choice("planner.autotune", self.autotune, PLANNER_AUTOTUNE_MODES)
        if not (0.0 <= self.compact_min_savings < 1.0):
            raise ConfigError("planner.compact_min_savings must be in [0, 1)")
        if not (0.0 <= self.nm_min_axis_savings < 1.0):
            raise ConfigError("planner.nm_min_axis_savings must be in [0, 1)")


# Fleet request routing when a request carries no "model" field: the
# sparsest (latest) level, the dense (lowest) level, or a pinned id.
FLEET_ROUTES = ("latest", "dense", "pinned")
# Per-checkpoint execution backend, resolved by the one planner
# (sparse/plan.py): auto/mixed let the planner compose — compact where dead
# channels actually shrink the model AND N:M where a layer routes — while
# masked/compact/nm pin a single backend.
FLEET_BACKENDS = ("auto", "masked", "compact", "nm", "mixed")


@dataclass
class FleetConfig:
    """Multi-checkpoint tenancy (serve/fleet/): serve every saved level of
    one or more experiment dirs from one process, routed on the request's
    ``model`` field."""

    # Experiment dirs to scan; empty = fall back to serve.expt_dir.
    expt_dirs: list = field(default_factory=list)
    # Weight-paging budget: at most this many models hold weights and
    # compiled executables at once (LRU eviction beyond it).
    max_resident_models: int = 4
    # Directory for serialized AOT executables ("" = disabled): cold start
    # becomes load-not-compile. Safe to share between replicas; entries from
    # a different jax/jaxlib/backend are bypassed, corrupt ones quarantined.
    aot_cache_dir: str = ""
    # Data-parallel lanes per model: engines round-robin flushed
    # micro-batches across devices when present, threads on CPU.
    replicas: int = 1
    default_route: str = "latest"
    # Registry id to serve when default_route=pinned (e.g. "level_3").
    pinned_model: str = ""
    backend: str = "auto"

    def validate(self) -> None:
        _check_choice(
            "serve.fleet.default_route", self.default_route, FLEET_ROUTES
        )
        _check_choice("serve.fleet.backend", self.backend, FLEET_BACKENDS)
        if self.max_resident_models < 1:
            raise ConfigError("serve.fleet.max_resident_models must be >= 1")
        if self.replicas < 1:
            raise ConfigError("serve.fleet.replicas must be >= 1")
        if self.default_route == "pinned" and not self.pinned_model:
            raise ConfigError(
                "serve.fleet.default_route=pinned needs serve.fleet.pinned_model"
            )
        if self.pinned_model and self.default_route != "pinned":
            raise ConfigError(
                "serve.fleet.pinned_model is set but default_route is "
                f"{self.default_route!r} — set default_route=pinned or drop it"
            )


@dataclass
class ServeConfig:
    """Inference-serving knobs (serve/ subsystem; composed from conf/serve/).

    The model/dataset geometry is NOT configured here — the engine reads the
    experiment dir's own ``expt_config.yaml`` snapshot, so a served
    checkpoint can never be paired with the wrong architecture."""

    # Experiment dir to serve from (or pass --expt-dir to run_server.py).
    expt_dir: str = ""
    # Which checkpoint: model_level_{N}; -1 = highest saved level.
    checkpoint_level: int = -1
    # Alternative: a role name (model_init / model_rewind). Overrides level.
    checkpoint_role: str = ""
    host: str = "127.0.0.1"
    port: int = 8000
    # Padded batch-size buckets the engine compiles for. Every request batch
    # is padded up to the smallest bucket that fits (larger ones are split at
    # the biggest bucket), so steady-state traffic never triggers a fresh
    # XLA trace.
    batch_buckets: list = field(default_factory=lambda: [1, 8, 32, 128])
    # Dynamic micro-batching: flush when max_batch rows are waiting or the
    # oldest request has waited max_wait_ms.
    max_batch: int = 128
    max_wait_ms: float = 5.0
    # Backpressure: pending requests beyond this are rejected (HTTP 503).
    queue_depth: int = 256
    # Compile every bucket at startup (before the first request lands).
    warmup: bool = True
    request_timeout_s: float = 30.0
    # Dead-channel compaction (sparse/): physically slice all-zero fan-out
    # channels (and their BN/bias entries) out of the loaded checkpoint and
    # AOT-compile the smaller model. Numerically equivalent to the
    # masked-dense forward (up to fp reassociation); pays off only when the
    # masks contain dead channels, not scattered zeros (README "Sparsity
    # execution").
    compact: bool = False
    # Graceful-shutdown budget: on SIGTERM the server stops accepting and
    # answers already-accepted requests for up to this long before exiting.
    drain_timeout_s: float = 10.0
    # Fleet serving (serve/fleet/): present = serve every level of the
    # configured experiment dirs from this one process.
    fleet: Optional[FleetConfig] = None

    def validate(self) -> None:
        if self.drain_timeout_s < 0:
            raise ConfigError("serve.drain_timeout_s must be >= 0")
        if self.fleet is not None:
            self.fleet.validate()
        if not self.batch_buckets:
            raise ConfigError("serve.batch_buckets must be non-empty")
        buckets = list(self.batch_buckets)
        if any(not isinstance(b, int) or b < 1 for b in buckets):
            raise ConfigError(
                f"serve.batch_buckets must be positive ints, got {buckets}"
            )
        if buckets != sorted(set(buckets)):
            raise ConfigError(
                f"serve.batch_buckets must be strictly increasing, got {buckets}"
            )
        if self.max_batch < 1:
            raise ConfigError("serve.max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ConfigError("serve.max_wait_ms must be >= 0")
        if self.queue_depth < 1:
            raise ConfigError("serve.queue_depth must be >= 1")
        if not (0 <= self.port <= 65535):
            raise ConfigError("serve.port must be in [0, 65535] (0 = ephemeral)")
        if self.request_timeout_s <= 0:
            raise ConfigError("serve.request_timeout_s must be positive")


@dataclass
class CyclicTrainingConfig:
    num_cycles: int = 1
    strategy: str = "constant"

    def validate(self) -> None:
        _check_choice("cyclic_training.strategy", self.strategy, CYCLIC_STRATEGIES)
        if self.num_cycles < 1:
            raise ConfigError("num_cycles must be >= 1")


@dataclass
class MainConfig:
    dataset_params: DatasetConfig = field(default_factory=DatasetConfig)
    model_params: ModelConfig = field(default_factory=ModelConfig)
    pruning_params: PruneConfig = field(default_factory=PruneConfig)
    experiment_params: ExperimentConfig = field(default_factory=ExperimentConfig)
    optimizer_params: OptimizerConfig = field(default_factory=OptimizerConfig)
    cyclic_training: CyclicTrainingConfig = field(
        default_factory=CyclicTrainingConfig
    )
    # Execution-planner thresholds (sparse/plan.py). No conf/ group of its
    # own: the defaults are right for every preset, dotted overrides
    # (``planner.compact_min_savings=0.1``) tune individual knobs.
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    # Inference serving (run_server.py); optional — training configs don't
    # carry it, serving composes it from the conf/serve/ group.
    serve: Optional[ServeConfig] = None

    def validate(self) -> "MainConfig":
        for f in fields(self):
            sub = getattr(self, f.name)
            if sub is not None and hasattr(sub, "validate"):
                sub.validate()
        # Cross-group: model axis > 1 is only consumed by ring attention
        # today; with dense attention every model-axis device would
        # redundantly compute the same gradients at 1/model_parallelism
        # throughput — reject.
        if (
            self.experiment_params.model_parallelism > 1
            and self.model_params.attention_impl != "ring"
        ):
            raise ConfigError(
                "model_parallelism > 1 requires model_params.attention_impl="
                "ring (nothing else uses the model axis; dense attention "
                "would silently duplicate compute across it)"
            )
        # Cross-group: prune_method "nm" is magnitude pruning + N:M
        # projection — without a pattern there is nothing to project onto.
        if (
            self.pruning_params.prune_method == "nm"
            and not self.experiment_params.nm_sparsity
        ):
            raise ConfigError(
                "prune_method='nm' requires experiment_params.nm_sparsity "
                f"(one of {NM_SPARSITY_PATTERNS})"
            )
        # Cross-group: the rewind snapshot is taken at epoch == rewind_epoch
        # of level 0 (cycle 0 for cyclic) — an out-of-range value would
        # silently never save model_rewind and crash at the level-1 rewind
        # AFTER burning all of level 0's compute.
        rewind_epoch = self.pruning_params.rewind_epoch
        if rewind_epoch is not None:
            from ..pruning.densities import generate_cyclical_schedule

            budget = generate_cyclical_schedule(
                self.experiment_params.epochs_per_level,
                self.cyclic_training.num_cycles,
                self.cyclic_training.strategy,
            )[0]
            if rewind_epoch >= budget:
                raise ConfigError(
                    f"rewind_epoch={rewind_epoch} is outside level 0's "
                    f"first-cycle epoch budget ({budget}): the rewind "
                    "snapshot would never be saved"
                )
        return self


def _from_dict(cls, data: dict):
    """Instantiate a (possibly nested) dataclass from a plain dict, rejecting
    unknown keys — typo'd config knobs fail loudly instead of silently doing
    nothing (a failure mode the reference had: unvalidated OmegaConf)."""
    if data is None:
        return None
    known = {f.name: f for f in fields(cls)}
    unknown = set(data) - set(known)
    if unknown:
        raise ConfigError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, f in known.items():
        if name not in data:
            continue
        value = data[name]
        ftype = f.type
        nested = _resolve_dataclass(ftype)
        if nested is not None:
            if isinstance(value, dict):
                value = _from_dict(nested, value)
            elif value is None and "Optional" not in str(ftype):
                raise ConfigError(
                    f"{name} is a required config group "
                    f"({nested.__name__}) and cannot be null"
                )
            elif value is not None:
                hint = (
                    f" — for a config-group override use '{name}=<option>' "
                    f"where <option> is a yaml under conf/{name}/"
                    if cls is MainConfig
                    else ""
                )
                raise ConfigError(
                    f"{name} must be a mapping ({nested.__name__}), "
                    f"got {value!r}{hint}"
                )
        kwargs[name] = _coerce(name, ftype, value)
    return cls(**kwargs)


def _coerce(name: str, ftype, value):
    """Coerce yaml scalars to the field's declared type. YAML 1.1 reads
    ``5e-4`` as a string (no dot before the exponent), so float fields accept
    numeric strings; bool/int get strict checks."""
    tname = str(ftype)
    if value is None:
        return None
    try:
        if "float" in tname and not isinstance(value, float):
            return float(value)
        if "bool" in tname and not isinstance(value, bool):
            if isinstance(value, str) and value.lower() in ("true", "false"):
                return value.lower() == "true"
            raise ConfigError(f"{name}={value!r} is not a bool")
        if tname in ("int", "<class 'int'>", "Optional[int]", "typing.Optional[int]") and not isinstance(value, int):
            return int(value)
    except (TypeError, ValueError) as e:
        raise ConfigError(f"cannot coerce {name}={value!r} to {tname}: {e}") from e
    return value


_NESTED = {
    "DatasetConfig": DatasetConfig,
    "ModelConfig": ModelConfig,
    "PruneConfig": PruneConfig,
    "ExperimentConfig": ExperimentConfig,
    "OptimizerConfig": OptimizerConfig,
    "PlannerConfig": PlannerConfig,
    "CyclicTrainingConfig": CyclicTrainingConfig,
    "ResumeExperimentConfig": ResumeExperimentConfig,
    "ServeConfig": ServeConfig,
    "FleetConfig": FleetConfig,
}


def _resolve_dataclass(ftype) -> Optional[type]:
    name = ftype if isinstance(ftype, str) else getattr(ftype, "__name__", str(ftype))
    # Longest key first: "ExperimentConfig" is a substring of
    # "ResumeExperimentConfig" and must not shadow it.
    for key in sorted(_NESTED, key=len, reverse=True):
        if key in str(name):
            return _NESTED[key]
    return None


def config_from_dict(data: dict) -> MainConfig:
    data = dict(data)
    data.pop("defaults", None)
    cfg = _from_dict(MainConfig, data)
    return cfg.validate()


def config_to_dict(cfg: MainConfig) -> dict:
    return dataclasses.asdict(cfg)
