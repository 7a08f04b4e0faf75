"""The port's open-loop load generator (turboprune_tpu_torch/serve/
loadgen.py) against the JAX package's (turboprune_tpu/serve/loadgen.py):
``_quantile``, ``detect_knee``, ``run_open_loop`` and
``sweep_offered_load`` must give exactly the same numbers.

Both modules read ``time.perf_counter`` and ``time.sleep``; the tests hand
each module the same fake clock (sleep advances it, nothing waits) and the
same deterministic submit (it advances the clock by a service time that
depends on the call number, sheds every 5th request with the module's own
QueueFullError and fails every 7th), so arrivals, latencies charged from
the intended arrival, sheds, errors and queue-depth samples are all
reproducible. One short real-clock point drives a DynamicBatcher over a
stub engine (well under a second).
"""

import math
from concurrent.futures import Future

import numpy as np
import pytest

from turboprune_tpu.serve import batcher as jbatcher
from turboprune_tpu.serve import loadgen as jloadgen
from turboprune_tpu_torch.serve import DynamicBatcher, QueueFullError
from turboprune_tpu_torch.serve import loadgen


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += max(0.0, s)


def _submit(clock, full_error, service_ms=(0.0, 2.5, 40.0)):
    calls = [0]

    def submit():
        calls[0] += 1
        n = calls[0]
        if n % 5 == 0:
            raise full_error("full")
        clock.now += service_ms[n % len(service_ms)] / 1e3
        f = Future()
        if n % 7 == 0:
            f.set_exception(RuntimeError("boom"))
        else:
            f.set_result(n)
        return f

    return submit


def _both(monkeypatch, run):
    """``run(module, clock, QueueFullError)`` on each package's loadgen
    with a fresh fake clock each."""
    out = []
    for module, full in ((loadgen, QueueFullError), (jloadgen, jbatcher.QueueFullError)):
        clock = FakeClock()
        monkeypatch.setattr(module, "time", clock)
        out.append(run(module, clock, full))
    return out


@pytest.mark.parametrize("vals", [[], [3.0], [1.0, 2.0], list(np.linspace(0.5, 99.5, 101)),
                                  [5.0, 1.0, 9.0, 2.0]])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 0.999, 1.0])
def test_quantile_equals_jax(vals, q):
    s = sorted(vals)
    assert loadgen._quantile(s, q) == jloadgen._quantile(s, q)


@pytest.mark.parametrize("points", [
    [],
    [{"offered_rps": 10.0, "issued": 10, "completed": 10, "p99_ms": 2.0},
     {"offered_rps": 20.0, "issued": 20, "completed": 20, "p99_ms": 3.0}],
    [{"offered_rps": 10.0, "issued": 10, "completed": 10, "p99_ms": 2.0},
     {"offered_rps": 40.0, "issued": 40, "completed": 30, "p99_ms": 3.0}],
    [{"offered_rps": 10.0, "issued": 10, "completed": 10, "p99_ms": 2.0},
     {"offered_rps": 40.0, "issued": 40, "completed": 40, "p99_ms": 10.5}],
    [{"offered_rps": 5.0, "issued": 0, "completed": 0, "p99_ms": None},
     {"offered_rps": 9.0, "issued": 9, "completed": 9, "p99_ms": 1.0}],
])
def test_detect_knee_equals_jax(points):
    assert loadgen.detect_knee(points) == jloadgen.detect_knee(points)
    kw = {"goodput_frac": 0.8, "p99_factor": 2.0}
    assert loadgen.detect_knee(points, **kw) == jloadgen.detect_knee(points, **kw)


@pytest.mark.parametrize("rps,seed", [(50.0, 0), (400.0, 3), (2000.0, 7)])
def test_open_loop_point_equals_jax_on_a_fake_clock(monkeypatch, rps, seed):
    def run(module, clock, full):
        depth = iter(range(10**6))
        return module.run_open_loop(_submit(clock, full), offered_rps=rps, duration_s=0.5,
                                    seed=seed, drain_timeout_s=1.0,
                                    depth_probe=lambda: next(depth))

    got, want = _both(monkeypatch, run)
    assert got == want
    assert got["issued"] == got["completed"] + got["rejected"] + got["errors"] + got["unfinished"]
    assert got["rejected"] == got["issued"] // 5 and got["errors"] > 0
    assert got["p50_ms"] <= got["p99_ms"] <= got["p999_ms"]


def test_sweep_equals_jax_on_a_fake_clock(monkeypatch):
    def run(module, clock, full):
        return module.sweep_offered_load(lambda: _submit(clock, full), rps_list=[800.0, 50.0, 200.0],
                                         duration_s=0.25, seed=1, settle_s=0.01)

    got, want = _both(monkeypatch, run)
    assert got == want
    assert [p["offered_rps"] for p in got["points"]] == [50.0, 200.0, 800.0]
    assert got["saturated"] == (got["knee_rps"] is not None)


class _SlowEngine:
    """Rows of [k, 2, 2, 3] in, k rows of their sums out, after a delay."""

    input_shape = (2, 2, 3)
    buckets = (4,)

    def __init__(self, delay_s):
        self.delay_s = delay_s

    def predict(self, x):
        import time

        time.sleep(self.delay_s)
        return x.reshape(x.shape[0], -1).sum(1, keepdims=True)


def test_open_loop_through_a_batcher_counts_every_request():
    """A real clock: 0.3 s at 200 rps into a batcher whose queue holds 4
    and whose engine takes 20 ms a batch: some requests shed, every issued
    request is accounted for, latency is finite and charged from arrival."""
    batcher = DynamicBatcher(_SlowEngine(0.02), max_batch=4, max_wait_ms=1.0,
                             queue_depth=4).start()
    x = np.ones((1, 2, 2, 3), np.float32)
    try:
        point = loadgen.run_open_loop(lambda: batcher.submit(x), offered_rps=200.0,
                                      duration_s=0.3, seed=0, drain_timeout_s=5.0,
                                      depth_probe=lambda: batcher.queue_depth)
    finally:
        batcher.close()
    issued = point["issued"]
    assert issued == point["completed"] + point["rejected"] + point["errors"] + point["unfinished"]
    assert point["errors"] == 0 and point["unfinished"] == 0 and point["completed"] > 0
    assert math.isfinite(point["p99_ms"]) and point["p99_ms"] >= 0.0
    assert point["max_queue_depth"] is None or point["max_queue_depth"] <= 4
