"""Serving metrics: latency histograms, throughput counters, gauges, and
compile-cache stats, exportable as Prometheus text exposition format (a
copy of ``turboprune_tpu/serve/metrics.py``: plain Python).

One ``ServeMetrics`` instance is shared by the engine (compile-cache
hits/misses: a bucket's compiled forward built, or found built), the
batcher (request/image counters, batch sizes, queue depth, per-request
latency), and the HTTP server (the /metrics endpoint). All mutation goes
through one lock — the batcher worker, N HTTP handler threads, and the
engine's compile path all write concurrently.

Multi-model (fleet) serving attaches a label set to each instance
(``labels=(("model", "level_3"),)``) and renders every instance through one
``MetricsHub``: samples are grouped by metric NAME across instances so the
exposition carries exactly one ``# TYPE`` line per metric with one labelled
sample per model — two engines exporting ``plan_params_dense`` are distinct
series, not a silent overwrite.

Quantiles (p50/p99) are computed from a bounded sliding window of recent
latencies rather than from the histogram buckets: the window gives exact
recent-traffic quantiles for the JSON snapshot, while the cumulative
buckets remain the long-horizon Prometheus view (scrapers compute their own
quantiles via histogram_quantile).

The harness exports its execution plans here too (``record_plan``, the
``plan_*`` gauges).
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Iterable, Optional, Sequence

# Upper bounds (ms) of the cumulative latency histogram; +Inf is implicit.
LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)

_PREFIX = "turboprune_serve_"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(pairs: Sequence[tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


class ServeMetrics:
    def __init__(
        self,
        window: int = 4096,
        labels: Sequence[tuple[str, str]] = (),
    ):
        self.labels = tuple((str(k), str(v)) for k, v in labels)
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}  # guarded-by: _lock
        self._gauges: dict[str, float] = {}  # guarded-by: _lock
        # counts[i] = observations <= LATENCY_BUCKETS_MS[i]; last slot = +Inf.
        self._latency_counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)  # guarded-by: _lock
        self._latency_sum_ms = 0.0  # guarded-by: _lock
        self._latency_total = 0  # guarded-by: _lock
        self._latency_window: deque[float] = deque(maxlen=window)  # guarded-by: _lock
        self._batch_window: deque[int] = deque(maxlen=window)  # guarded-by: _lock

    # ------------------------------------------------------------ mutation
    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def compile_hit(self) -> None:
        self.inc("compile_cache_hits_total")

    def compile_miss(self) -> None:
        self.inc("compile_cache_misses_total")

    def record_plan(self, report: dict) -> None:
        """Export an ExecutionPlan report (sparse/plan.py) as the ``plan_*``
        gauges: per-layer backend counts, N:M coverage and, where
        compaction was planned, the dense and compacted parameter and
        channel counts: the size and routing the process actually runs."""
        counts = report.get("backend_counts", {})
        self.set_gauge("plan_layers_nm", counts.get("nm_layers", 0))
        self.set_gauge("plan_layers_dense", counts.get("dense_layers", 0))
        self.set_gauge(
            "plan_spaces_compacted", counts.get("compact_spaces", 0)
        )
        self.set_gauge("plan_coverage_frac", report.get("coverage_frac", 0.0))
        comp = report.get("compaction") or {}
        if "params_before" in comp:
            self.set_gauge("plan_params_dense", comp["params_before"])
            self.set_gauge("plan_params_compacted", comp["params_after"])
            self.set_gauge("plan_channels_dense", comp["channels_before"])
            self.set_gauge("plan_channels_compacted", comp["channels_after"])

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
            self._batch_window.append(int(rows))

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

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            batch_window = list(self._batch_window)
            total = self._latency_total
            lat_sum = self._latency_sum_ms
        snap = {**counters, **gauges}
        snap["latency_observations"] = total
        if total:
            snap["latency_mean_ms"] = lat_sum / total
        for q, name in ((0.5, "p50_ms"), (0.9, "p90_ms"), (0.99, "p99_ms")):
            v = self.latency_quantile_ms(q)
            if v is not None:
                snap[f"latency_{name}"] = v
        if batch_window:
            snap["mean_batch_rows"] = sum(batch_window) / len(batch_window)
        return snap

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
        return render_prometheus_all([self])


def render_prometheus_all(instances: Iterable["ServeMetrics"]) -> str:
    """Render N metric instances (typically one per served model) as ONE
    exposition: samples are grouped by metric name so each name gets exactly
    one ``# TYPE`` line with one labelled sample per instance — the spec
    forbids repeating TYPE for a name, which is what naively concatenating
    per-model renders would do."""
    # name -> {"kind": ..., "lines": [...]}; insertion order preserved so
    # related series stay adjacent.
    series: dict[str, dict] = {}

    def add(name: str, kind: str, line: str) -> None:
        s = series.setdefault(name, {"kind": kind, "lines": []})
        s["lines"].append(line)

    for m in instances:
        raw = m._raw()
        lbl = _label_str(m.labels)
        for name, value in sorted(raw["counters"].items()):
            add(name, "counter", f"{_PREFIX}{name}{lbl} {_fmt(value)}")
        for name, value in sorted(raw["gauges"].items()):
            add(name, "gauge", f"{_PREFIX}{name}{lbl} {_fmt(value)}")
        hist = f"{_PREFIX}request_latency_ms"
        running = 0
        for le, c in zip(LATENCY_BUCKETS_MS, raw["latency_counts"]):
            running += c
            le_pairs = (*m.labels, ("le", _fmt(le)))
            add(
                "request_latency_ms",
                "histogram",
                f"{hist}_bucket{_label_str(le_pairs)} {running}",
            )
        inf_pairs = (*m.labels, ("le", "+Inf"))
        add(
            "request_latency_ms",
            "histogram",
            f"{hist}_bucket{_label_str(inf_pairs)} {raw['latency_total']}",
        )
        add(
            "request_latency_ms",
            "histogram",
            f"{hist}_sum{lbl} {_fmt(raw['latency_sum_ms'])}",
        )
        add(
            "request_latency_ms",
            "histogram",
            f"{hist}_count{lbl} {raw['latency_total']}",
        )
        # Convenience gauges (non-canonical but handy without a scraper).
        for q, qname in ((0.5, "p50"), (0.99, "p99")):
            v = m.latency_quantile_ms(q)
            if v is not None:
                add(
                    f"request_latency_{qname}_ms",
                    "gauge",
                    f"{_PREFIX}request_latency_{qname}_ms{lbl} {_fmt(v)}",
                )
    lines = []
    for name, s in series.items():
        lines.append(f"# TYPE {_PREFIX}{name} {s['kind']}")
        lines.extend(s["lines"])
    return "\n".join(lines) + "\n"


class MetricsHub:
    """Registry of per-model ``ServeMetrics`` instances for one process.

    ``get("")`` is the unlabelled fleet-level instance (routing counters,
    paging gauges); ``get(model_id)`` returns the SAME labelled instance for
    every caller asking about that model, so counters survive weight paging
    (an evicted model's series keeps accumulating when it pages back in)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: dict[str, ServeMetrics] = {}  # guarded-by: _lock

    def get(self, model: str = "") -> ServeMetrics:
        with self._lock:
            inst = self._instances.get(model)
            if inst is None:
                labels = (("model", model),) if model else ()
                inst = ServeMetrics(labels=labels)
                self._instances[model] = inst
            return inst

    def instances(self) -> list[ServeMetrics]:
        with self._lock:
            return list(self._instances.values())

    def counter(self, name: str, model: str = "") -> float:
        return self.get(model).counter(name)

    def render_prometheus(self) -> str:
        return render_prometheus_all(self.instances())

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._instances.items())
        return {key or "_fleet": inst.snapshot() for key, inst in items}


def _fmt(v: float) -> str:
    """Integral values without the trailing .0 (Prometheus accepts both;
    integers read better for counters)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
