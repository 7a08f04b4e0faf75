"""Open-loop load generator — "handles heavy traffic" as a measured number
(a copy of ``turboprune_tpu/serve/loadgen.py``: plain Python).

Closed-loop clients (a thread pool that waits on each reply) can never overload the
system: each client waits for its response before sending again, so
measured latency stays flattering right up to the cliff. This generator is
OPEN-LOOP: arrivals are a Poisson process at a configured offered load,
issued on schedule whether or not earlier requests have returned — exactly
how independent users behave. Latency is charged from the INTENDED arrival
time, so scheduler slip when the generator itself falls behind counts
against the system rather than being silently forgiven (the
coordinated-omission correction).

``sweep_offered_load`` runs points of increasing offered RPS and reports
p50/p99/p99.9, goodput (completed requests/s), rejection counts (bounded
queue sheds), and sampled queue depth per point, then locates the
SATURATION KNEE: the first offered load where goodput falls measurably
short of offered or tail latency explodes relative to the lightest point.
Everything is in-process against a submit callable (fleet engine or
batcher), so it measures the serving stack, not HTTP parsing.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

from .batcher import QueueFullError

# Knee thresholds: completion ratio (completed / issued — robust to the
# +-sqrt(n) Poisson noise in the arrival count itself) below 90%, or p99
# beyond 5x the lightest point's p99, marks the point as saturated.
KNEE_GOODPUT_FRAC = 0.9
KNEE_P99_FACTOR = 5.0


def _quantile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def run_open_loop(
    submit: Callable[[], Future],
    *,
    offered_rps: float,
    duration_s: float,
    seed: int = 0,
    drain_timeout_s: float = 30.0,
    depth_probe: Optional[Callable[[], int]] = None,
) -> dict:
    """One open-loop point: Poisson arrivals at ``offered_rps`` for
    ``duration_s``; returns latency quantiles, goodput, rejects, errors,
    and sampled queue depth. ``submit`` issues one request and returns its
    Future (QueueFullError counts as a shed, not a failure)."""
    if offered_rps <= 0:
        raise ValueError("offered_rps must be > 0")
    rng = random.Random(seed)
    lock = threading.Lock()
    latencies_ms: list[float] = []
    errors = [0]

    def _record(fut: Future, t_intended: float) -> None:
        def cb(f: Future) -> None:
            t_done = time.perf_counter()
            if f.exception() is not None:
                with lock:
                    errors[0] += 1
                return
            with lock:
                latencies_ms.append((t_done - t_intended) * 1e3)

        fut.add_done_callback(cb)

    pending: list[Future] = []
    rejected = 0
    issued = 0
    depth_samples: list[int] = []
    start = time.perf_counter()
    t = rng.expovariate(offered_rps)
    while t < duration_s:
        now = time.perf_counter() - start
        if t > now:
            time.sleep(t - now)
        t_intended = start + t
        try:
            fut = submit()
            _record(fut, t_intended)
            pending.append(fut)
        except QueueFullError:
            rejected += 1
        issued += 1
        if depth_probe is not None and issued % 16 == 0:
            depth_samples.append(int(depth_probe()))
        t += rng.expovariate(offered_rps)
    # Let the tail finish (bounded): stragglers past the timeout count as
    # unfinished, never as fake latencies.
    deadline = time.perf_counter() + drain_timeout_s
    for fut in pending:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        try:
            fut.result(timeout=left)
        # torchlint: disable=broad-except -- measurement, not control flow: failures were already tallied by the done-callback (errors) or fall out as unfinished below
        except Exception:
            pass
    with lock:
        lats = sorted(latencies_ms)
        n_err = errors[0]
    completed = len(lats)
    point = {
        "offered_rps": float(offered_rps),
        "duration_s": float(duration_s),
        "issued": issued,
        "completed": completed,
        "rejected": rejected,
        "errors": n_err,
        "unfinished": issued - rejected - completed - n_err,
        "goodput_rps": completed / duration_s,
        "p50_ms": _quantile(lats, 0.50),
        "p99_ms": _quantile(lats, 0.99),
        "p999_ms": _quantile(lats, 0.999),
        "mean_ms": (sum(lats) / completed) if completed else None,
        "max_queue_depth": max(depth_samples) if depth_samples else None,
    }
    return point


def detect_knee(
    points: Sequence[dict],
    *,
    goodput_frac: float = KNEE_GOODPUT_FRAC,
    p99_factor: float = KNEE_P99_FACTOR,
) -> Optional[float]:
    """First offered load (RPS) where the system stops keeping up: the
    completion ratio falls below ``goodput_frac`` (requests shed by the
    bounded queue or unanswered), or p99 > ``p99_factor`` x the lightest
    point's p99. None = no knee inside the swept range."""
    if not points:
        return None
    base_p99 = points[0].get("p99_ms")
    for p in points:
        offered = p["offered_rps"]
        issued = max(1, p.get("issued", 0))
        saturated = p["completed"] / issued < goodput_frac
        if (
            not saturated
            and base_p99
            and p.get("p99_ms") is not None
            and p["p99_ms"] > p99_factor * base_p99
        ):
            saturated = True
        if saturated:
            return float(offered)
    return None


def sweep_offered_load(
    submit_factory: Callable[[], Callable[[], Future]],
    *,
    rps_list: Sequence[float],
    duration_s: float = 2.0,
    seed: int = 0,
    settle_s: float = 0.25,
    drain_timeout_s: float = 30.0,
    depth_probe: Optional[Callable[[], int]] = None,
) -> dict:
    """Sweep offered load low -> high; returns {"points", "knee_rps",
    "saturated"}. ``submit_factory`` is called once per point so the caller
    can rotate payloads/models per point without sharing iterator state
    across points."""
    points = []
    for i, rps in enumerate(sorted(float(r) for r in rps_list)):
        point = run_open_loop(
            submit_factory(),
            offered_rps=rps,
            duration_s=duration_s,
            seed=seed + i,
            drain_timeout_s=drain_timeout_s,
            depth_probe=depth_probe,
        )
        points.append(point)
        time.sleep(settle_s)  # let queues empty between points
    knee = detect_knee(points)
    return {
        "points": points,
        "knee_rps": knee,
        "saturated": knee is not None,
    }
