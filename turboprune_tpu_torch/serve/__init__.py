"""Inference serving for pruned checkpoints (port of
``turboprune_tpu/serve``).

engine.py   InferenceEngine — checkpoint loading, mask folding / channel
            compaction / N:M gathering backends, one compiled forward per
            padded batch-size bucket (captured in a CUDA graph on the card)
batcher.py  DynamicBatcher — deadline/size micro-batching with bounded-queue
            backpressure, replica round-robin, graceful drain
metrics.py  ServeMetrics + MetricsHub — per-model labelled latency
            histograms, counters, gauges, Prometheus text exposition
server.py   InferenceServer — stdlib HTTP /predict /healthz /metrics with
            fleet routing on the request's "model" field
fleet/      ModelRegistry + FleetEngine + AOTExecutableCache — every level
            of an experiment family from one process, weight paging, and
            cold starts that load inductor's artifacts instead of compiling
loadgen.py  Open-loop Poisson load generator — p50/p99/p99.9 vs offered
            load and the saturation knee

Entry point: run_server_torch.py at the repo root, configured by the
conf/serve/ group.
"""

from .batcher import DynamicBatcher, QueueFullError
from .engine import BACKENDS, DEFAULT_BUCKETS, PRECISION_DTYPES, InferenceEngine
from .fleet import (
    AOTExecutableCache,
    FleetEngine,
    ModelRegistry,
    ModelSpec,
    UnknownModelError,
    open_cache,
)
from .loadgen import detect_knee, run_open_loop, sweep_offered_load
from .metrics import (
    LATENCY_BUCKETS_MS,
    MetricsHub,
    ServeMetrics,
    render_prometheus_all,
)
from .server import InferenceServer, build_server

__all__ = [
    "AOTExecutableCache",
    "BACKENDS",
    "DEFAULT_BUCKETS",
    "DynamicBatcher",
    "FleetEngine",
    "InferenceEngine",
    "InferenceServer",
    "LATENCY_BUCKETS_MS",
    "MetricsHub",
    "ModelRegistry",
    "ModelSpec",
    "PRECISION_DTYPES",
    "QueueFullError",
    "ServeMetrics",
    "UnknownModelError",
    "build_server",
    "detect_knee",
    "open_cache",
    "render_prometheus_all",
    "run_open_loop",
    "sweep_offered_load",
]
