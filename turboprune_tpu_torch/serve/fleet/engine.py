"""FleetEngine — every checkpoint of an experiment family behind one door
(port of ``turboprune_tpu/serve/fleet/engine.py``).

One process, N models: the registry names every saved level (masked-dense,
compacted, N:M-gathered, or a mix — ``backend="auto"``/``"mixed"`` hand
each checkpoint to the one planner, sparse/plan.py), and requests route on
a ``model`` field. Each resident model owns a full serving stack —
InferenceEngine (its compiled, captured buckets), a DynamicBatcher (so one
model's burst cannot head-of-line-block another's queue), and a labelled
ServeMetrics from the shared MetricsHub (so two models'
``plan_params_dense`` are distinct series, not an overwrite).

Weight paging: at most ``max_resident_models`` models hold weights and
compiled buckets at once, evicted LRU on page-in of the next. Eviction
drains the model's batcher and then closes its engines, which gives their
device memory back (weights, CUDA-graph pools, static buffers). Page-in
cost is checkpoint load + bucket compiles — with a shared
``AOTExecutableCache`` inductor's compiles become disk loads (the trace
still runs). A model's metrics instance survives eviction (counters keep
accumulating across page cycles).

Replicas: ``replicas=K`` builds K engines per model, one per card, when
the host has several (``torch.cuda.device_count()``), or shares one engine
across a K-thread flush pool when it has one (or serves on the CPU); the
per-model batcher round-robins flushed micro-batches across them (see
batcher.py). A shared engine serialises each bucket's replay behind the
bucket's lock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..batcher import DynamicBatcher
from ..engine import DEFAULT_BUCKETS, InferenceEngine
from ..metrics import MetricsHub
from ...utils.device import resolve_device
from .registry import ModelRegistry, ModelSpec


class _Resident:
    __slots__ = ("spec", "engines", "batcher", "metrics")

    def __init__(self, spec, engines, batcher, metrics):
        self.spec = spec
        self.engines = engines
        self.batcher = batcher
        self.metrics = metrics

    @property
    def engine(self) -> InferenceEngine:
        return self.engines[0]


class FleetEngine:
    def __init__(
        self,
        registry: ModelRegistry,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_resident_models: int = 4,
        replicas: int = 1,
        aot_cache=None,
        hub: Optional[MetricsHub] = None,
        max_batch: int = 128,
        max_wait_ms: float = 5.0,
        queue_depth: int = 256,
        default_route: str = "latest",
        pinned_model: str = "",
        backend: str = "auto",
        warmup: bool = False,
        device: str | torch.device = "cuda",
    ):
        if max_resident_models < 1:
            raise ValueError("max_resident_models must be >= 1")
        self.registry = registry
        self.buckets = tuple(buckets)
        self.max_resident_models = int(max_resident_models)
        self.replicas = int(replicas)
        self.aot_cache = aot_cache
        self.hub = hub or MetricsHub()
        self.metrics = self.hub.get("")  # fleet-level (routing/paging)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue_depth = queue_depth
        self.default_route = default_route
        self.pinned_model = pinned_model
        self.backend = backend
        self.device = resolve_device(device)
        self._residents: "OrderedDict[str, _Resident]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()  # protects the resident map + LRU
        self._build_locks: dict[str, threading.Lock] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # Fail fast on a bad route config instead of on the first request.
        self.default_model = registry.default_id(default_route, pinned_model)
        if warmup:
            self._resident(self.default_model)

    # -------------------------------------------------------------- paging
    def _build_lock(self, model_id: str) -> threading.Lock:
        with self._lock:
            lock = self._build_locks.get(model_id)
            if lock is None:
                lock = self._build_locks[model_id] = threading.Lock()
            return lock

    def _resident(self, model_id: str) -> _Resident:
        with self._lock:
            r = self._residents.get(model_id)
            if r is not None:
                self._residents.move_to_end(model_id)
                return r
        # Build outside the fleet lock (checkpoint load + compiles are
        # slow); the per-model lock stops duplicate builds of the SAME
        # model while other models keep serving.
        with self._build_lock(model_id):
            with self._lock:
                r = self._residents.get(model_id)
                if r is not None:
                    self._residents.move_to_end(model_id)
                    return r
            r = self._page_in(self.registry.get(model_id))
            evicted: list[_Resident] = []
            with self._lock:
                closed = self._closed
                if not closed:
                    self._residents[model_id] = r
                    self._residents.move_to_end(model_id)
                    while len(self._residents) > self.max_resident_models:
                        _, old = self._residents.popitem(last=False)
                        evicted.append(old)
                    self.metrics.set_gauge("resident_models", len(self._residents))
            if closed:
                self._page_out(r)
                raise RuntimeError("fleet engine closed")
            for old in evicted:
                self._page_out(old)
            return r

    def _page_in(self, spec: ModelSpec) -> _Resident:
        metrics = self.hub.get(spec.model_id)
        engines = []
        try:
            for dev in self._replica_devices():
                engines.append(InferenceEngine.from_experiment(
                    spec.expt_dir,
                    level=spec.level,
                    buckets=self.buckets,
                    metrics=metrics,
                    backend=self.backend,
                    aot_cache=self.aot_cache,
                    device=dev,
                ))
            for eng in engines:
                eng.warmup()
        except BaseException:
            for eng in engines:  # a half-built model gives its memory back
                eng.close()
            raise
        batcher = DynamicBatcher(
            engines,
            max_batch=self.max_batch,
            max_wait_ms=self.max_wait_ms,
            queue_depth=self.queue_depth,
            metrics=metrics,
            replicas=self.replicas,
        ).start()
        self.metrics.inc("model_pageins_total")
        metrics.set_gauge("model_level", spec.level)
        return _Resident(spec, engines, batcher, metrics)

    def _replica_devices(self) -> list:
        """One device per engine replica: distinct cards when the host has
        them, else one thread-shared engine (the batcher's flush pool still
        provides ``replicas`` concurrent lanes)."""
        n = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if self.replicas > 1 and n > 1:
            return [torch.device("cuda", i % n) for i in range(self.replicas)]
        return [self.device]

    def _page_out(self, r: _Resident) -> None:
        # Answer what the evicted model already accepted, then give its
        # device memory back; its metrics instance stays in the hub.
        r.batcher.drain(deadline_s=5.0)
        for eng in r.engines:
            eng.close()
        self.metrics.inc("model_evictions_total")

    # ------------------------------------------------------------- serving
    def resolve(self, model: str = "") -> ModelSpec:
        return self.registry.resolve(
            model or None,
            default_route=self.default_route,
            pinned_model=self.pinned_model,
        )

    def submit(self, images: np.ndarray, model: str = ""):
        """Route one request; returns (future, resident). Raises
        UnknownModelError / QueueFullError / ValueError like the parts."""
        spec = self.resolve(model)
        r = self._resident(spec.model_id)
        self.metrics.inc("routed_requests_total")
        return r.batcher.submit(images), r

    def predict(
        self, images: np.ndarray, model: str = "", timeout: float = 30.0
    ) -> np.ndarray:
        future, _ = self.submit(images, model=model)
        return future.result(timeout)

    # ----------------------------------------------------------- reporting
    @property
    def resident_ids(self) -> list[str]:
        with self._lock:
            return list(self._residents)

    def info(self) -> dict:
        with self._lock:
            residents = dict(self._residents)
        models = {}
        for model_id in self.registry.ids():
            r = residents.get(model_id)
            row = {
                "level": self.registry.get(model_id).level,
                "resident": r is not None,
            }
            if r is not None:
                row.update(r.engine.info())
                row["queue_depth"] = r.batcher.queue_depth
                row["replicas"] = len(r.engines)
                row["requests_total"] = int(r.metrics.counter("requests_total"))
            models[model_id] = row
        out = {
            "default_model": self.default_model,
            "max_resident_models": self.max_resident_models,
            "resident_models": len(residents),
            # The fleet-wide bucket set every resident is built with — the
            # executable surface per (model, plan): what /healthz reports
            # and the exec manifest bounds.
            "buckets": list(self.buckets),
            "models": models,
        }
        if self.aot_cache is not None:
            out["aot_cache"] = self.aot_cache.stats()
        return out

    # ------------------------------------------------------------ shutdown
    def drain(self, deadline_s: float = 10.0) -> dict:
        """Drain every resident batcher within one shared deadline."""
        with self._lock:
            self._closed = True
            residents = list(self._residents.values())
        end = time.perf_counter() + max(0.0, float(deadline_s))
        results = {}
        for r in residents:
            left = max(0.0, end - time.perf_counter())
            results[r.spec.model_id] = r.batcher.drain(deadline_s=left)
        return results

    def close(self) -> None:
        """Drain, then close every resident engine."""
        self.drain(deadline_s=5.0)
        with self._lock:
            residents = list(self._residents.values())
            self._residents.clear()
        for r in residents:
            for eng in r.engines:
                eng.close()
