"""InferenceEngine — pruned-checkpoint forward with one compiled executable
per batch bucket (port of ``turboprune_tpu/serve/engine.py``).

Loads an experiment-dir checkpoint (``model_level_{L}`` or a role like
``model_init``) next to the experiment's own ``expt_config.yaml`` snapshot,
so a served checkpoint can never be paired with the wrong architecture.
A checkpoint's batch_stats (a ResNet's BatchNorm running statistics) load
with its params, and the model serves in eval mode on them. Masks are
folded into the weights ONCE at load time (``w * m`` is exact), so
per-request forwards skip the mask multiply. A request for n rows is
padded up to the smallest bucket >= n (split at the largest bucket), so
the device only ever sees the configured batch shapes.

Backend selection is delegated to the ONE planner (sparse/plan.py
``plan_execution``): ``backend="auto"``/``"mixed"`` let it compose —
channel-compact where dead channels actually shrink the checkpoint
(serving commits on ANY real shrinkage: no optimizer state to slice), N:M
gathering where the index plan routes a layer over the survivors, and
masked-dense where neither pays — while ``masked``/``compact``/``nm`` pin
a single backend (``compact`` raises when the plan cannot be built;
``nm`` degrades to masked when nothing routes). Masks are folded before
any slicing or gathering, so every backend reads exact already-masked
weights; ``engine.plan.report`` carries the per-layer decision table.

Each bucket's forward is compiled once (``torch.compile(fullgraph=True,
dynamic=False)``: inductor on CUDA, ``backend="aot_eager"`` on a CPU
device) behind a double-checked single-flight lock, and counted as a
compile-cache miss; every later use is a hit. On CUDA the compiled forward
is then captured in a ``torch.cuda.CUDAGraph`` of its own, with a static
input and a static output buffer, and a request is a copy in, a replay and
a copy out under the bucket's lock (two replica threads sharing the engine
would otherwise race on the static buffers). No Python runs per kernel,
so the flash kernel's wrapper counts only the warm-up and capture
launches: replays are counted by kernel name with ``torch.profiler``.
Nothing falls back: a graph break, a failed compile or a failed capture
raises.

Three traps shape the build:

- dynamo keeps its compiled entries (guard sets) on the Python code object
  it traced, at most ``recompile_limit`` (8) per code object, and with
  ``fullgraph=True`` the next one raises. Buckets x models over a fleet's
  life pass 8, so each bucket compiles functions with code objects of
  their own (``_region_function``), which die with the engine.
- inductor's compile time grows with the graph: a whole DeiT-Small forward
  compiles many times slower than one encoder block. A bucket compiles
  regions (``_regions``): a ViT's encoder blocks, one graph per distinct
  block shape that all its blocks share, the rest of the forward eager
  around them (captured in the CUDA graph all the same); any other model
  whole.
- ``mode="reduce-overhead"`` keeps its CUDA-graph trees per thread (the
  warm-up, batcher and replica threads would each record their own), so
  the graphs are captured explicitly, once, in the building thread.
- A capture fails when another thread's work joins it. Builds and
  releases take the process-wide ``_BUILD_LOCK``; each card has one build
  stream (warm-up and capture, ``capture_error_mode="thread_local"``) and
  one serve stream (copies and replays), both from PyTorch's pool, which
  makes them non-blocking: neither waits on nor joins the legacy default
  stream. Two streams per card, not one per bucket: cuBLAS keeps a
  workspace for every stream it has run on for the life of the process,
  so a stream per bucket would leak a workspace per page-in.

With an ``aot_cache`` (serve/fleet/aot_cache.py) each bucket's inductor
artifacts are looked up on disk by the traced graph's fingerprint before
inductor compiles; ``compiles_total`` counts only the compiles that still
ran (inductor's FX-graph cache misses and bypasses on CUDA; every
``aot_eager`` compile on the CPU, which has no artifact to keep), so a
warm cache shows a compile-free rebuild. ``close()`` gives the device
memory back: the graphs' pools, the static buffers and the weights.
"""

from __future__ import annotations

import bisect
import functools
import gc
import threading
import time
import types
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models import create_model
from ..ops import masking
from ..sparse import compact_stats, compact_tree, model_leaves, plan_execution
from ..sparse.graph import state_key
from ..sparse.nm_execute import MIN_AXIS_SAVINGS
from ..utils.checkpoint import ExperimentCheckpoints, model_state_dict, restore_model_tree
from ..utils.device import resolve_device
from ..utils.experiment import load_config

if TYPE_CHECKING:
    from .fleet.aot_cache import AOTExecutableCache

DEFAULT_BUCKETS = (1, 8, 32, 128)

PRECISION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}

# backend knob -> (compact mode, nm mode) handed to the planner. "mixed"
# is the explicit spelling of what "auto" already does — both backends
# offered, the planner composes whatever pays.
_BACKEND_MODES = {
    "masked": ("off", "off"),
    "compact": ("force", "off"),
    "nm": ("off", "auto"),
    "auto": ("auto", "auto"),
    "mixed": ("auto", "auto"),
}
BACKENDS = tuple(_BACKEND_MODES)

# One bucket build (compile, warm-up, capture) or release at a time in the
# process: a CUDA-graph capture must not be joined by another build's work,
# and the inductor counters and the cache artifacts read around a build
# are process-wide.
_BUILD_LOCK = threading.Lock()
# card index -> (build stream, serve stream); guarded-by: _BUILD_LOCK
_STREAMS: dict[int, tuple] = {}


def _region_function(name: str):
    """``type(module).forward(module, *args)`` as a function with a code
    object of its own: dynamo's cache entries for it live and die with the
    bucket that compiled it."""

    def region(module, *args):
        return type(module).forward(module, *args)

    code = region.__code__.replace(co_name=name, co_qualname=name)
    return types.FunctionType(code, region.__globals__, name)


def _regions(model: nn.Module) -> list[nn.Module]:
    """The modules a bucket compiles: a ViT's encoder blocks, which share
    one graph per distinct shape (inductor's compile time grows with the
    graph, and twelve identical blocks compile as one), else the whole
    model."""
    from ..models.vit import EncoderBlock

    blocks = [m for m in model.modules() if isinstance(m, EncoderBlock)]
    return blocks or [model]


def _signature(module: nn.Module) -> tuple:
    """What one compiled region graph is specialised to, besides its input."""
    return (type(module),) + tuple(
        (name, tuple(t.shape), t.dtype)
        for name, t in (*module.named_parameters(), *module.named_buffers())
    )


def _inductor_compiles() -> int:
    """Inductor compiles that ran in this process: FX-graph cache misses
    and bypasses (a hit loads a compiled graph instead)."""
    from torch._dynamo.utils import counters

    c = counters["inductor"]
    return int(c["fxgraph_cache_miss"] + c["fxgraph_cache_bypass"])


def _card_streams(device: torch.device) -> tuple:
    """(build stream, serve stream) of a card. Call under _BUILD_LOCK."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = (torch.cuda.Stream(index), torch.cuda.Stream(index))
    return _STREAMS[index]


class _Bucket:
    """One bucket's compiled forward; on CUDA its captured graph, the
    stream it replays on, its static buffers and pinned output buffer.
    ``lock`` serialises uses."""

    __slots__ = ("fn", "lock", "graph", "stream", "x", "y", "host_out")

    def __init__(self, fn, graph=None, stream=None, x=None, y=None, host_out=None):
        self.fn = fn
        self.lock = threading.Lock()
        self.graph = graph
        self.stream = stream
        self.x = x
        self.y = y
        self.host_out = host_out

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.fn = self.graph = self.stream = self.x = self.y = self.host_out = None


class InferenceEngine:
    """Bucketed, mask-folded, compiled forward over a loaded checkpoint.

    ``predict`` is thread-safe: compilation is single-flight behind a lock
    and each bucket's replay runs under the bucket's own lock."""

    def __init__(
        self,
        model: nn.Module,
        state_dict: dict,
        masks: dict,
        *,
        input_shape: Sequence[int],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        metrics=None,
        level: Optional[int] = None,
        source: str = "",
        compact: bool = False,
        backend: Optional[str] = None,
        device: str | torch.device = "cuda",
        model_factory: Optional[Callable[..., nn.Module]] = None,
        aot_cache: Optional["AOTExecutableCache"] = None,
        nm_min_axis_savings: Optional[float] = None,
        autotune: str = "off",
    ):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        if backend is None:
            backend = "compact" if compact else "masked"
        if backend not in _BACKEND_MODES:
            raise ValueError(f"unknown serving backend {backend!r}")
        self.device = resolve_device(device)
        self.input_shape = tuple(int(d) for d in input_shape)
        self.metrics = metrics
        self.aot_cache = aot_cache
        self.level = level
        self.source = source
        self.density = masking.overall_density(masks)
        self.compaction: Optional[dict] = None
        self.nm_plan_report: Optional[dict] = None

        model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        masks = {p: m.to(self.device) for p, m in masks.items()}
        compact_mode, nm_mode = _BACKEND_MODES[backend]
        # The ONE planner (sparse/plan.py) produces the backend decision.
        # compact_min_savings=0 is serving's commit rule: any real shrinkage
        # pays at inference (no optimizer state to slice). The real
        # BatchNorm statistics go to the planner: compaction slices them.
        params, stats = model_leaves(model)
        plan = plan_execution(
            model, params, masks, stats,
            compact=compact_mode,
            nm=nm_mode,
            compact_min_savings=0.0,
            nm_min_axis_savings=(
                MIN_AXIS_SAVINGS if nm_min_axis_savings is None else nm_min_axis_savings
            ),
            autotune=autotune,
        )
        self.plan = plan
        self.backend = plan.kind
        self._plan_signature = plan.plan_signature()
        # Fold once, in place: pruned weights become literal zeros, so
        # forwards skip the mask multiply and any slice or N:M gather reads
        # exact already-masked weights.
        model.load_state_dict(masking.apply_masks(model.state_dict(), masks))
        if plan.width_overrides or plan.nm_overrides:
            if model_factory is None:
                raise ValueError(
                    f"the {plan.kind} plan re-instantiates the model at its "
                    "widths / with its N:M modules: pass model_factory"
                )
            served = model_factory(
                width_overrides=plan.width_overrides, nm_overrides=plan.nm_overrides
            ).to(self.device)
            if plan.compaction is not None:
                # Serve the physically smaller model: numerically the
                # masked-dense forward up to summation order.
                params, stats = model_leaves(model)
                sliced = {**compact_tree(params, plan.compaction),
                          **compact_stats(stats, plan.compaction)}
                served.load_state_dict({state_key(p): t for p, t in sliced.items()})
                self.compaction = plan.compaction.report
            else:
                served.load_state_dict(model.state_dict())
            model = served.eval()
        if plan.nm is not None:
            self.nm_plan_report = {
                "routed_layers": len(plan.nm.overrides),
                "coverage_frac": plan.nm.report["coverage_frac"],
                "eligible_params": plan.nm.report["eligible_params"],
                "routed_params": plan.nm.report["routed_params"],
            }
        if metrics:
            metrics.record_plan(plan.report)
        self.model = model.requires_grad_(False)
        self.num_classes = int(getattr(model, "num_classes", 0)) or None
        self._compiled: dict[int, _Bucket] = {}  # guarded-by: _compile_lock
        self._compile_lock = threading.Lock()
        # Held while a compiled forward runs Python (its regions routed).
        self._forward_lock = threading.Lock()
        self._closed = False  # guarded-by: _compile_lock

    # ----------------------------------------------------------- compiling
    def _inc(self, name: str, value: float = 1.0) -> None:
        if self.metrics:
            self.metrics.inc(name, value)

    def _executable(self, bucket: int) -> _Bucket:
        """The compiled forward for one bucket shape, built once per bucket
        per engine."""
        # torchlint: disable=unsynchronized-shared-mutation -- the lock-free fast path: _compiled is only written under _compile_lock with a finished bucket, a dict lookup is atomic, and a bucket close() released is caught under its own lock (b.fn is None)
        b = self._compiled.get(bucket)
        if b is not None:
            if self.metrics:
                self.metrics.compile_hit()
            return b
        with self._compile_lock:
            if self._closed:
                raise RuntimeError("inference engine closed")
            b = self._compiled.get(bucket)
            if b is not None:  # lost the race: someone compiled it already
                if self.metrics:
                    self.metrics.compile_hit()
                return b
            if self.metrics:
                self.metrics.compile_miss()
            t0 = time.perf_counter()
            # Single flight: concurrent requests for the same cold bucket
            # wait for one build; warm buckets take the lock-free path.
            with _BUILD_LOCK:
                # torchlint: disable=blocking-call-under-lock -- single-flight build IS the point of _compile_lock: concurrent requests for the same cold bucket wait for one compile; warm buckets stay lock-free via the fast path above
                b = self._build(bucket)
            self._inc("compile_seconds_total", time.perf_counter() - t0)
            self._compiled[bucket] = b
        return b

    def _build(self, bucket: int) -> _Bucket:
        from torch.compiler._cache import CacheArtifactManager

        cuda = self.device.type == "cuda"
        inner = torch._dynamo.lookup_backend("inductor" if cuda else "aot_eager")
        traced: dict = {"graphs": 0, "keys": []}

        def backend(gm, example_inputs):
            # The trace ran; before the expensive compile, hand inductor
            # the artifacts an earlier process stored for this graph.
            traced["graphs"] += 1
            if self.aot_cache is not None:
                key = self.aot_cache.make_key(
                    graph_fingerprint=self.aot_cache.fingerprint(gm, example_inputs),
                    plan_signature=self._plan_signature,
                    bucket=bucket,
                )
                payload, status = self.aot_cache.load(key, self.device)
                self._inc(f"aot_cache_{status}_total")
                if payload is not None:
                    torch.compiler.load_cache_artifacts(payload)
                traced["keys"].append((key, status))
            return inner(gm, example_inputs)

        model, regions = self.model, _regions(self.model)
        compiled: dict[tuple, object] = {}
        for m in regions:
            sig = _signature(m)
            if sig not in compiled:
                compiled[sig] = torch.compile(
                    _region_function(f"serve_bucket_{bucket}_region_{len(compiled)}"),
                    backend=backend, fullgraph=True, dynamic=False,
                )
        routes = [(m, functools.partial(compiled[_signature(m)], m)) for m in regions]

        def fn(x):
            # Eager Python around the compiled regions; on CUDA it runs only
            # to warm up and to capture. Each region's forward is routed to
            # its compiled graph for the call, then restored.
            with self._forward_lock:
                for m, route in routes:
                    m.forward = route
                try:
                    return model(x).float()
                finally:
                    for m, _ in routes:
                        del m.forward

        before = _inductor_compiles()
        CacheArtifactManager.clear()
        x = torch.zeros((bucket, *self.input_shape), dtype=torch.float32, device=self.device)
        if cuda:
            build, serve = _card_streams(self.device)
            build.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(build), torch.no_grad():
                fn(x)  # compile, then one warm call before the capture
                fn(x)
            build.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(
                graph, stream=build, capture_error_mode="thread_local"
            ):
                y = fn(x)
            host_out = torch.empty(y.shape, dtype=torch.float32, pin_memory=True)
            built = _Bucket(fn, graph, serve, x, y, host_out)
            compiles = _inductor_compiles() - before
        else:
            with torch.no_grad():
                fn(x)
            built = _Bucket(fn)
            compiles = traced["graphs"]
        self._inc("compiles_total", compiles)
        missed = [key for key, status in traced["keys"] if status != "hit"]
        if missed:
            # What inductor compiled, or found in its own caches, for this
            # bucket's graphs since the clear() above.
            artifacts = torch.compiler.save_cache_artifacts()
            if artifacts is not None:
                for key in missed:
                    self.aot_cache.store(key, artifacts[0], self.device)
        return built

    def warmup(self) -> None:
        """Compile every bucket up front (misses counted; later traffic is
        then all cache hits — the zero-steady-state-recompile property)."""
        for b in self.buckets:
            self._executable(b)

    @property
    def compiled_buckets(self) -> tuple[int, ...]:
        with self._compile_lock:
            return tuple(sorted(self._compiled))

    # ----------------------------------------------------------- inference
    def predict(self, images: np.ndarray) -> np.ndarray:
        """Logits for a [n, H, W, C] float batch (or one [H, W, C] image),
        any n >= 1. Pads to the bucket internally; returns exactly n rows of
        float32 logits — padded rows never leak (rows are independent)."""
        x = np.asarray(images, np.float32)
        if x.ndim == len(self.input_shape):
            x = x[None]
        if x.ndim != len(self.input_shape) + 1 or x.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected images of shape [n, {', '.join(map(str, self.input_shape))}]"
                f" (or one unbatched image), got {x.shape}"
            )
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        max_b = self.buckets[-1]
        outs = [
            self._predict_chunk(x[off : off + max_b])
            for off in range(0, n, max_b)
        ]
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _predict_chunk(self, chunk: np.ndarray) -> np.ndarray:
        k = chunk.shape[0]
        bucket = self.buckets[bisect.bisect_left(self.buckets, k)]
        if bucket > k:
            self._inc("padded_rows_total", bucket - k)
        b = self._executable(bucket)
        chunk = np.ascontiguousarray(chunk)
        with b.lock:
            if b.fn is None:
                raise RuntimeError("inference engine closed")
            if b.graph is None:
                if bucket > k:
                    pad = np.zeros((bucket - k, *self.input_shape), np.float32)
                    chunk = np.concatenate([chunk, pad])
                with torch.no_grad():
                    return b.fn(torch.from_numpy(chunk)).numpy()[:k]
            with torch.cuda.stream(b.stream):
                b.x[:k].copy_(torch.from_numpy(chunk))
                if bucket > k:
                    b.x[k:].zero_()
                b.graph.replay()
                b.host_out.copy_(b.y, non_blocking=True)
            b.stream.synchronize()
            return b.host_out[:k].numpy().copy()

    # ------------------------------------------------------------ lifetime
    def close(self) -> None:
        """Give the device memory back: every bucket's graph pool and
        buffers, then the weights. Later calls raise."""
        with self._compile_lock:
            self._closed = True
            built, self._compiled = self._compiled, {}
        with _BUILD_LOCK:
            for b in built.values():
                with b.lock:
                    b.release()
            self.model = None
            gc.collect()  # dynamo's entries sit in reference cycles
            if self.device.type == "cuda":
                # torchlint: disable=blocking-call-under-lock -- under _BUILD_LOCK on purpose: a synchronize while another engine captures a CUDA graph would fail that capture, and _BUILD_LOCK is what keeps captures alone
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()

    def info(self) -> dict:
        out = {
            "level": self.level,
            "density": round(float(self.density), 6),
            "backend": self.backend,
            "buckets": list(self.buckets),
            "compiled_buckets": list(self.compiled_buckets),
            "input_shape": list(self.input_shape),
            "num_classes": self.num_classes,
            "source": self.source,
            "device": str(self.device),
        }
        if self.nm_plan_report is not None:
            out["nm"] = dict(self.nm_plan_report)
        if self.compaction is not None:
            out["compaction"] = {
                "params_before": self.compaction["params_before"],
                "params_after": self.compaction["params_after"],
                "channels_before": self.compaction["channels_before"],
                "channels_after": self.compaction["channels_after"],
                "compacted_spaces": self.compaction["compacted_spaces"],
            }
        # The planner's routing table: why each eligible layer (and the
        # compaction stage) landed on its backend. JSON-safe scalars only.
        out["plan"] = {
            "kind": self.plan.kind,
            "autotune": self.plan.report["autotune"],
            "decisions": self.plan.decisions,
        }
        return out

    # -------------------------------------------------------- construction
    @classmethod
    def from_experiment(
        cls,
        expt_dir: str | Path,
        *,
        level: Optional[int] = None,
        role: str = "",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        metrics=None,
        precision: Optional[str] = None,
        compact: bool = False,
        backend: Optional[str] = None,
        aot_cache: Optional["AOTExecutableCache"] = None,
        device: str | torch.device = "cuda",
    ) -> "InferenceEngine":
        """Build from an experiment directory.

        ``level=None`` / ``level=-1`` serves the highest saved
        ``model_level_{L}``; ``role`` (e.g. ``model_init``) overrides level.
        ``precision`` overrides the experiment's training_precision for the
        serving forward (default: serve with the training dtype)."""
        dev = resolve_device(device)
        expt_dir = Path(expt_dir)
        cfg = load_config(expt_dir)
        dp = cfg.dataset_params
        dtype = PRECISION_DTYPES[
            precision or cfg.experiment_params.training_precision
        ]
        # Serving is single-device: ring (sequence-parallel) runs as its
        # param-identical dense attention.
        attention_impl = cfg.model_params.attention_impl
        if attention_impl == "ring":
            attention_impl = "dense"

        def factory(width_overrides=None, nm_overrides=None) -> nn.Module:
            # The compacted / gathered model gets the same stem, dtype and
            # attention wiring.
            return create_model(
                cfg.model_params.model_name,
                num_classes=dp.num_classes,
                dataset_name=dp.dataset_name,
                compute_dtype=dtype,
                attention_impl=attention_impl,
                image_size=dp.image_size,
                width_overrides=width_overrides,
                nm_overrides=nm_overrides,
            )

        ckpts = ExperimentCheckpoints(expt_dir)
        if role:
            path = ckpts.model_path(role)
            level = None
        else:
            if level is None or level < 0:
                saved = ckpts.saved_levels()
                if not saved:
                    raise FileNotFoundError(
                        f"no model_level_* checkpoints under "
                        f"{ckpts.checkpoints_dir}"
                    )
                level = saved[-1]
            path = ckpts.level_path(level)
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {path} does not exist")
        restored = restore_model_tree(path)
        return cls(
            factory(),
            model_state_dict(restored),
            restored["masks"],
            input_shape=(dp.image_size, dp.image_size, 3),
            buckets=buckets,
            metrics=metrics,
            level=level,
            source=str(path),
            compact=compact,
            backend=backend,
            device=dev,
            model_factory=factory,
            aot_cache=aot_cache,
            # The experiment's planner knobs travel to serving (the compact
            # commit rule stays serving's own "any shrinkage pays").
            nm_min_axis_savings=cfg.planner.nm_min_axis_savings,
            autotune=cfg.planner.autotune,
        )
