"""graftsan — runtime concurrency sanitizer, the dynamic mirror of the
static thread rules (concurrency_rules.py), over the port's own threaded
subsystems (a copy of the JAX package's sanitizer with the port's drives).

The static layer proves properties of a LEXICAL thread model: spawn sites
it can resolve, locks it can name, accesses it can see. This module checks
the same two properties against what a real run actually does:

* **lock order** — ``threading.Lock``/``RLock``/``Condition`` factories are
  patched for the duration of a run; every lock CREATED BY PACKAGE CODE
  (creation-site frame filter — stdlib internals like ``queue.Queue``'s
  conditions stay unwrapped) is wrapped so each acquire records a
  held-before edge. A cycle in the observed acquisition-order graph (or a
  re-acquire of a held non-reentrant Lock) is a deadlock witness: exit 1,
  no exceptions.
* **shared writes** — ``watch(cls)`` patches ``cls.__setattr__`` to record
  (instance, attribute, thread, lockset held). An attribute rebound by two
  or more threads on the same instance with no common lock is an observed
  race. Each observed race is then diffed against the static
  ``unsynchronized-shared-mutation`` findings (waived findings count — a
  waiver is still an explanation): an observed race the static layer never
  claimed is a BLIND SPOT in the lexical model and fails the run, the same
  contract as an unattributed compile in the compile audit.

Two built-in drives put the package's real concurrent subsystems under
load: ``pipeline`` (data/pipeline.py's PrefetchEngine: pool decoders + the
transfer thread moving batches onto the device + concurrent stats readers
+ racing closes) and ``fleet`` (serve/fleet/engine.py: a 2-model
FleetEngine with ``max_resident_models=1`` so page-in/evict churns under
concurrent submitters; engines are faked so no checkpoint or compiler is
needed). ``file.py:builder`` drives a custom callable. The drives run on
``cuda`` unless ``cpu`` is asked for; without CUDA, ``cuda`` is a usage
error. Exit codes follow the CLI contract: 0 clean, 1 cycle or
unexplained race, 2 usage error.

First-write exemption: the first rebind of each (instance, attribute) is
init-time by construction (``__init__`` runs before the object is shared)
and is not counted.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

from .drivers import load_builder, resolve_runtime_target

__all__ = ["Graftsan", "SanitizeError", "run_sanitize"]

_PKG_ROOT = str(Path(__file__).resolve().parents[1])
_SELF = str(Path(__file__).resolve())

_KINDS = ("Lock", "RLock", "Condition")


class SanitizeError(RuntimeError):
    """Usage/environment error (unknown target, missing builder): exit 2."""


class _LockWrapper:
    """Records acquire/release against the owning Graftsan; everything else
    delegates to the real primitive (so e.g. ``Condition(lock=wrapper)``
    still finds ``locked()`` and misses ``_release_save`` exactly like the
    real Lock would)."""

    def __init__(self, san, real, kind, site, uid):
        self._san = san
        self._real = real
        self._kind = kind  # "lock" | "rlock" | "condition"
        self._site = site
        self._uid = uid

    def acquire(self, blocking=True, timeout=-1):
        self._san._pre_acquire(self)
        got = self._real.acquire(blocking, timeout)
        if got:
            self._san._did_acquire(self)
        return got

    def release(self):
        self._real.release()
        self._san._did_release(self)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __repr__(self):
        return f"<graftsan {self._kind} #{self._uid} from {self._site}>"


class _CondWrapper(_LockWrapper):
    """Condition: ``wait`` releases the lock for its duration, so the held
    stack must drop it on entry and restore it on return (the restore
    records no order edge — the reacquire is protocol, not policy)."""

    def wait(self, timeout=None):
        self._san._did_release(self)
        try:
            return self._real.wait(timeout)
        finally:
            self._san._did_acquire(self)

    def wait_for(self, predicate, timeout=None):
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            left = None if end is None else end - time.monotonic()
            if left is not None and left <= 0:
                break
            self.wait(left)
            result = predicate()
        return result


class Graftsan:
    """Context manager: patch the lock factories, observe, unpatch.

    ``include`` limits wrapping to locks whose creation site (the frame
    calling the factory) lives under one of the given path prefixes;
    default is the turboprune_tpu_torch package."""

    def __init__(self, include=None):
        self._include = tuple(str(p) for p in include) if include else (_PKG_ROOT,)
        # Real primitives captured NOW, before any patching, so the
        # sanitizer's own bookkeeping never runs through a wrapper.
        self._mu = threading.Lock()
        self._real_factories: dict = {}
        self._held: dict = {}  # thread id -> [wrapper] (acquisition order)
        self._sites: dict = {}  # uid -> (site, kind)
        self._edges: dict = {}  # (uid_a, uid_b) -> witness dict
        self._writes: dict = {}  # (obj id, cls name, attr) -> [(tid, held)]
        self._first: set = set()  # (obj id, attr): init-write exemption
        # Strong refs to every watched instance: id() keys above are only
        # meaningful while the object is alive — letting an evicted object
        # die would let a NEW instance reuse its id and inherit its
        # first-write exemptions (its unguarded __init__ writes would then
        # read as races).
        self._keepalive: dict = {}
        self._watched: list = []  # (cls, original __setattr__ or None)
        self._uid = 0
        self.lock_count = 0
        self._active = False

    # ------------------------------------------------------------ patching
    def __enter__(self) -> "Graftsan":
        for kind in _KINDS:
            self._real_factories[kind] = getattr(threading, kind)
            setattr(threading, kind, self._factory(kind))
        self._active = True
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
        for kind, real in self._real_factories.items():
            setattr(threading, kind, real)
        for cls, orig in reversed(self._watched):
            if orig is None:
                try:
                    delattr(cls, "__setattr__")
                except AttributeError:
                    pass
            else:
                cls.__setattr__ = orig
        self._watched.clear()

    def _factory(self, kind):
        real_ctor = self._real_factories[kind]
        san = self

        def make(*args, **kwargs):
            real = real_ctor(*args, **kwargs)
            frame = sys._getframe(1)
            fname = frame.f_code.co_filename
            if fname == _SELF or not fname.startswith(san._include):
                return real
            with san._mu:
                san._uid += 1
                san.lock_count += 1
                uid = san._uid
                site = f"{fname}:{frame.f_lineno}"
                san._sites[uid] = (site, kind.lower())
            cls = _CondWrapper if kind == "Condition" else _LockWrapper
            return cls(san, real, kind.lower(), site, uid)

        return make

    # ----------------------------------------------------------- lock events
    def _pre_acquire(self, w) -> None:
        tid = threading.get_ident()
        with self._mu:
            held = self._held.get(tid, [])
            if any(h is w for h in held):
                if w._kind == "lock":
                    # Non-reentrant Lock re-acquired by its holder: this
                    # thread is now deadlocked for real — record the
                    # self-edge so cycles() reports it even though the run
                    # will need its timeout to notice.
                    self._edges.setdefault(
                        (w._uid, w._uid),
                        {
                            "from": w._site,
                            "to": w._site,
                            "thread": threading.current_thread().name,
                        },
                    )
                return  # RLock/Condition re-entry is legal, no edge
            for h in held:
                self._edges.setdefault(
                    (h._uid, w._uid),
                    {
                        "from": h._site,
                        "to": w._site,
                        "thread": threading.current_thread().name,
                    },
                )

    def _did_acquire(self, w) -> None:
        with self._mu:
            self._held.setdefault(threading.get_ident(), []).append(w)

    def _did_release(self, w) -> None:
        with self._mu:
            held = self._held.get(threading.get_ident(), [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] is w:
                    del held[i]
                    break

    # --------------------------------------------------------- write events
    def watch(self, cls) -> None:
        """Record every attribute rebind on instances of ``cls`` with the
        writing thread and its lockset."""
        if any(c is cls for c, _ in self._watched):
            return
        orig_in_dict = "__setattr__" in vars(cls)
        orig = cls.__setattr__
        san = self

        def _setattr(obj, name, value, _orig=orig):
            _orig(obj, name, value)
            san._record_write(obj, name)

        cls.__setattr__ = _setattr
        self._watched.append((cls, orig if orig_in_dict else None))

    def _record_write(self, obj, attr) -> None:
        if not self._active:
            return
        tid = threading.get_ident()
        with self._mu:
            self._keepalive[id(obj)] = obj
            first_key = (id(obj), attr)
            if first_key not in self._first:
                self._first.add(first_key)
                return
            held = frozenset(w._uid for w in self._held.get(tid, ()))
            key = (id(obj), type(obj).__name__, attr)
            self._writes.setdefault(key, []).append((tid, held))

    # ------------------------------------------------------------- verdicts
    def order_edges(self) -> list:
        with self._mu:
            return [
                {"from": self._sites[a][0], "to": self._sites[b][0], **w}
                for (a, b), w in sorted(self._edges.items())
            ]

    def cycles(self) -> list:
        """Cycles in the observed acquisition-order graph, each a dict with
        the participating creation sites and the witnessing edges."""
        with self._mu:
            edges = dict(self._edges)
            sites = dict(self._sites)
        adj: dict = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        out = []
        for scc in _sccs(adj):
            if len(scc) > 1 or (scc[0], scc[0]) in edges:
                members = set(scc)
                witness = [
                    f"{sites[a][0]} -> {sites[b][0]} [{w['thread']}]"
                    for (a, b), w in sorted(edges.items())
                    if a in members and b in members
                ]
                out.append(
                    {
                        "locks": sorted(sites[u][0] for u in scc),
                        "edges": witness,
                    }
                )
        return sorted(out, key=lambda c: c["locks"])

    def races(self) -> list:
        """Attributes rebound by >= 2 threads on one instance with no
        common lock, aggregated to (class, attr) for the static diff."""
        seen: dict = {}
        with self._mu:
            items = sorted(self._writes.items(), key=lambda kv: kv[0][1:])
        for (_oid, cls, attr), ws in items:
            threads = {t for t, _ in ws}
            if len(threads) < 2:
                continue
            common = frozenset.intersection(*(h for _, h in ws))
            if common:
                continue
            row = seen.setdefault(
                (cls, attr),
                {"cls": cls, "attr": attr, "writes": 0, "threads": 0},
            )
            row["writes"] += len(ws)
            row["threads"] = max(row["threads"], len(threads))
        return [seen[k] for k in sorted(seen)]


def _sccs(adj: dict) -> list:
    """Iterative Tarjan over the uid graph; returns every SCC."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]
    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    u = stack.pop()
                    on_stack.discard(u)
                    scc.append(u)
                    if u == node:
                        break
                sccs.append(sorted(scc))
    return sccs


# ------------------------------------------------------------------ drivers


def _drive_pipeline(san: Graftsan, device) -> None:
    """PrefetchEngine under the exact load shape its races would need:
    pool decoders + the transfer thread (onto ``device``) + concurrent
    stats readers + three racing close() calls at the end (the
    close-idempotence race)."""
    import numpy as np
    import torch

    from ..data.pipeline import PrefetchEngine

    san.watch(PrefetchEngine)

    total = 64

    def mk(i):
        def task():
            time.sleep(0.0002)
            return np.full((8,), i, np.int64)

        return task

    eng = PrefetchEngine(
        (mk(i) for i in range(total)),
        lambda batches: [torch.from_numpy(b).to(device) for b in batches],
        depth=4,
        workers=4,
        group=2,
        name="graftsan",
    )
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            eng.stats()
            time.sleep(0.0002)

    readers = [threading.Thread(target=poll, daemon=True) for _ in range(2)]
    for t in readers:
        t.start()
    seen = sum(1 for _ in eng)
    stop.set()
    for t in readers:
        t.join()
    closers = [threading.Thread(target=eng.close) for _ in range(3)]
    for t in closers:
        t.start()
    for t in closers:
        t.join()
    if seen != total:
        raise SanitizeError(
            f"pipeline driver lost batches: {seen}/{total} emitted"
        )


def _drive_fleet(san: Graftsan, device) -> None:
    """Two-model FleetEngine with max_resident_models=1: every model swap
    is a page-in + LRU evict + batcher drain while other submitters keep
    routing — the lock-heaviest path in the repo. Engines are faked (no
    checkpoints, no compiler); the locks and the batchers are real."""
    import numpy as np

    from unittest import mock

    from ..serve.batcher import DynamicBatcher
    from ..serve.engine import InferenceEngine
    from ..serve.fleet.engine import FleetEngine
    from ..serve.fleet.registry import ModelRegistry, ModelSpec
    from ..serve.metrics import MetricsHub, ServeMetrics

    san.watch(FleetEngine)
    san.watch(DynamicBatcher)
    san.watch(ServeMetrics)
    san.watch(MetricsHub)

    class _FakeEngine:
        input_shape = (4,)
        num_classes = 3

        def predict(self, images):
            time.sleep(0.0002)
            return np.zeros((images.shape[0], 3), np.float32)

        def warmup(self):
            pass

        def info(self):
            return {"backend": "fake"}

    # A registry over checkpoints that don't exist: bypass the scanning
    # __init__ and install the specs directly (resolve/default_id logic
    # stays the real code).
    reg = ModelRegistry.__new__(ModelRegistry)
    reg.expt_dirs = [Path("graftsan-fake-expt")]
    reg.specs = {
        f"level_{lvl}": ModelSpec(
            model_id=f"level_{lvl}",
            expt_dir=Path("graftsan-fake-expt"),
            level=lvl,
        )
        for lvl in (0, 1)
    }

    answered = [0]
    answered_mu = threading.Lock()

    with mock.patch.object(
        InferenceEngine,
        "from_experiment",
        staticmethod(lambda *a, **k: _FakeEngine()),
    ):
        fleet = FleetEngine(
            reg,
            max_resident_models=1,
            max_wait_ms=1.0,
            queue_depth=64,
            device=device,
        )

        def client(i):
            x = np.zeros((1, 4), np.float32)
            for k in range(30):
                # Alternate models so the 1-slot LRU churns constantly.
                model = f"level_{(i + k) % 2}"
                try:
                    fut, _r = fleet.submit(x, model=model)
                    fut.result(timeout=30)
                # torchlint: disable=broad-except -- shed load (draining/evicted batcher, failed straggler) is a legal per-request answer under 1-slot LRU churn; the sanitizer's subject is the locks, and zero total successes still fails the smoke below
                except Exception:
                    continue
                with answered_mu:
                    answered[0] += 1

        clients = [
            threading.Thread(target=client, args=(i,), daemon=True)
            for i in range(4)
        ]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        fleet.info()
        fleet.drain(deadline_s=10.0)
    if answered[0] == 0:
        raise SanitizeError("fleet driver answered zero requests")


def _custom_driver(spec: str):
    """Resolution is deferred to drive time on purpose: run_sanitize pays
    for the full static pass before driving, and a bad spec should not
    error only after that wait in tests that probe it directly."""

    def drive(_san: Graftsan, _device) -> None:
        builder, _paths = load_builder(
            spec, error_cls=SanitizeError, what="--sanitize target"
        )
        fn = builder()
        if callable(fn):
            fn()

    return drive


# ------------------------------------------------------------------- runner


def _static_keys() -> set:
    """(class, attr) keys the static layer already claims (waived findings
    included — a reviewed waiver is an explanation, not a blind spot)."""
    from .concurrency_rules import static_race_keys
    from .core import analyze_project

    result = analyze_project([_PKG_ROOT], jobs=1)
    return static_race_keys(result.findings)


def run_sanitize(target: str, device: str = "cuda") -> int:
    from .drivers import runtime_device

    dev = runtime_device(device, SanitizeError)
    target = target or "all"
    if target == "all":
        drivers = [("pipeline", _drive_pipeline), ("fleet", _drive_fleet)]
    else:
        kind, payload = resolve_runtime_target(
            target,
            {"pipeline": _drive_pipeline, "fleet": _drive_fleet},
            error_cls=SanitizeError,
            what="--sanitize target",
            load=False,  # builder modules must load inside the patched window
        )
        drivers = [
            (target, payload if kind == "named" else _custom_driver(target))
        ]

    # Static pass FIRST (it forks a process pool; keep that outside the
    # patched window) — its mutation keys are the explanation set.
    static = _static_keys()

    san = Graftsan()
    with san:
        for name, drive in drivers:
            t0 = time.perf_counter()
            drive(san, dev)
            print(
                f"graftsan: drove {name} "
                f"({time.perf_counter() - t0:.2f}s, "
                f"{san.lock_count} package locks wrapped so far)"
            )

    cycles = san.cycles()
    races = san.races()
    unexplained = [
        r for r in races if (r["cls"], r["attr"]) not in static
    ]
    print(
        f"graftsan: {san.lock_count} locks wrapped, "
        f"{len(san.order_edges())} order edges, {len(cycles)} cycle(s), "
        f"{len(races)} observed race(s) ({len(unexplained)} unexplained)"
    )
    for c in cycles:
        print(f"graftsan: LOCK-ORDER CYCLE over {', '.join(c['locks'])}")
        for e in c["edges"]:
            print(f"    {e}")
    for r in races:
        tag = (
            "UNEXPLAINED (static blind spot)"
            if r in unexplained
            else "explained by a static finding"
        )
        print(
            f"graftsan: race on {r['cls']}.{r['attr']} — "
            f"{r['writes']} writes from {r['threads']} threads, {tag}"
        )
    return 1 if cycles or unexplained else 0
