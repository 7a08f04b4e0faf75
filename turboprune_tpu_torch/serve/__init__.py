"""Inference serving for pruned checkpoints (port of
``turboprune_tpu/serve``, single-model serving).

engine.py   InferenceEngine — checkpoint loading, mask folding, padded
            batch-size buckets, warm-up
batcher.py  DynamicBatcher — deadline/size micro-batching with bounded-queue
            backpressure and graceful drain
metrics.py  ServeMetrics — latency histograms, counters, gauges, Prometheus
            text exposition
server.py   InferenceServer — stdlib HTTP /predict /healthz /metrics

Entry point: run_server_torch.py at the repo root. The fleet, the sparse
backends and the load generator are later slices (ROADMAP.md).
"""

from .batcher import DynamicBatcher, QueueFullError
from .engine import DEFAULT_BUCKETS, PRECISION_DTYPES, InferenceEngine
from .metrics import LATENCY_BUCKETS_MS, ServeMetrics
from .server import InferenceServer, UnknownModelError, build_server

__all__ = [
    "DEFAULT_BUCKETS",
    "DynamicBatcher",
    "InferenceEngine",
    "InferenceServer",
    "LATENCY_BUCKETS_MS",
    "PRECISION_DTYPES",
    "QueueFullError",
    "ServeMetrics",
    "UnknownModelError",
    "build_server",
]
