"""Serving metrics: latency histograms, throughput counters, gauges and
bucket warm-up stats, exportable as Prometheus text exposition format
(port of ``turboprune_tpu/serve/metrics.py``).

One ``ServeMetrics`` instance is shared by the engine (a bucket's first
run versus its warm runs — the port's counterpart of the JAX engine's
compile-cache hits and misses), the batcher (request/image counters, batch
sizes, queue depth, per-request latency), and the HTTP server (the /metrics
endpoint). All mutation goes through one lock — the batcher worker, N HTTP
handler threads and the engine all write concurrently.

Quantiles (p50/p99) are computed from a bounded sliding window of recent
latencies rather than from the histogram buckets: the window gives exact
recent-traffic quantiles, while the cumulative buckets remain the
long-horizon Prometheus view.

The harness exports its execution plans here too (``record_plan``, the
``plan_*`` gauges). The fleet's labelled multi-model hub is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Optional

# Upper bounds (ms) of the cumulative latency histogram; +Inf is implicit.
LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)

_PREFIX = "turboprune_serve_"


class ServeMetrics:
    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}  # guarded-by: _lock
        self._gauges: dict[str, float] = {}  # guarded-by: _lock
        # counts[i] = observations <= LATENCY_BUCKETS_MS[i]; last slot = +Inf.
        self._latency_counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)  # guarded-by: _lock
        self._latency_sum_ms = 0.0  # guarded-by: _lock
        self._latency_total = 0  # guarded-by: _lock
        self._latency_window: deque[float] = deque(maxlen=window)  # guarded-by: _lock

    # ------------------------------------------------------------ mutation
    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def record_plan(self, report: dict) -> None:
        """Export an ExecutionPlan report (sparse/plan.py) as the ``plan_*``
        gauges: per-layer backend counts, N:M coverage and, where
        compaction was planned, the dense and compacted parameter and
        channel counts: the size and routing the process actually runs."""
        counts = report.get("backend_counts", {})
        self.set_gauge("plan_layers_nm", counts.get("nm_layers", 0))
        self.set_gauge("plan_layers_dense", counts.get("dense_layers", 0))
        self.set_gauge("plan_spaces_compacted", counts.get("compact_spaces", 0))
        self.set_gauge("plan_coverage_frac", report.get("coverage_frac", 0.0))
        comp = report.get("compaction") or {}
        if "params_before" in comp:
            self.set_gauge("plan_params_dense", comp["params_before"])
            self.set_gauge("plan_params_compacted", comp["params_after"])
            self.set_gauge("plan_channels_dense", comp["channels_before"])
            self.set_gauge("plan_channels_compacted", comp["channels_after"])

    def bucket_warm(self) -> None:
        self.inc("bucket_warm_runs_total")

    def bucket_first_run(self) -> None:
        self.inc("bucket_first_runs_total")

    def observe_latency_ms(self, ms: float) -> None:
        with self._lock:
            i = bisect.bisect_left(LATENCY_BUCKETS_MS, ms)
            self._latency_counts[i] += 1
            self._latency_sum_ms += ms
            self._latency_total += 1
            self._latency_window.append(ms)

    def observe_batch(self, rows: int) -> None:
        with self._lock:
            self._counters["batches_total"] = (
                self._counters.get("batches_total", 0.0) + 1
            )
            self._counters["images_total"] = (
                self._counters.get("images_total", 0.0) + rows
            )

    # ------------------------------------------------------------- queries
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def latency_quantile_ms(self, q: float) -> Optional[float]:
        """Exact quantile over the recent-latency window; None when empty."""
        with self._lock:
            data = sorted(self._latency_window)
        if not data:
            return None
        idx = min(len(data) - 1, max(0, round(q * (len(data) - 1))))
        return data[idx]

    def _raw(self) -> dict:
        """Consistent snapshot of everything the renderer needs."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latency_counts": list(self._latency_counts),
                "latency_sum_ms": self._latency_sum_ms,
                "latency_total": self._latency_total,
            }

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        raw = self._raw()
        lines = []
        for kind in ("counter", "gauge"):
            for name, value in sorted(raw[kind + "s"].items()):
                lines += [f"# TYPE {_PREFIX}{name} {kind}",
                          f"{_PREFIX}{name} {_fmt(value)}"]
        hist = f"{_PREFIX}request_latency_ms"
        lines.append(f"# TYPE {hist} histogram")
        running = 0
        for le, c in zip(LATENCY_BUCKETS_MS, raw["latency_counts"]):
            running += c
            lines.append(f'{hist}_bucket{{le="{_fmt(le)}"}} {running}')
        lines += [
            f'{hist}_bucket{{le="+Inf"}} {raw["latency_total"]}',
            f"{hist}_sum {_fmt(raw['latency_sum_ms'])}",
            f"{hist}_count {raw['latency_total']}",
        ]
        # Convenience gauges (non-canonical but handy without a scraper).
        for q, qname in ((0.5, "p50"), (0.99, "p99")):
            v = self.latency_quantile_ms(q)
            if v is not None:
                name = f"{_PREFIX}request_latency_{qname}_ms"
                lines += [f"# TYPE {name} gauge", f"{name} {_fmt(v)}"]
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Integral values without the trailing .0 (Prometheus accepts both;
    integers read better for counters)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
