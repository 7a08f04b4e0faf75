"""``--compile-audit``: every runtime dynamo compile attributed to the
static executable manifest — the runtime mirror of exec_manifest.py, as
sanitizer.py mirrors the thread rules.

The manifest claims the compile surface is finite and statically known.
This mode checks the claim against what dynamo actually does. A
:class:`CompileLedger` window records, from ``torch._dynamo.utils``:

* one record per compiled frame (``get_compilation_metrics()``): the code
  object's name, file and first line, how many cache entries the code
  object already had (a recompile when > 0) and dynamo's recompile reason;
* the counters: ``graph_break`` (reason -> count), ``stats.unique_graphs``
  and inductor's ``cudagraph_skips``.

It drives the package's compile-heavy paths — the serving engine's bucket
warm-up (``serve``) and the shared train step through
``compile_forward(train_forward, device)`` (``train``) — and fails when

* a graph break happened;
* a compile's code object lies in no manifest entry (a compile the static
  layer never enumerated);
* a compiled (plan kind, bucket) is outside the manifest (``covers``);
* a code object recompiled more often than the manifest allows.

On a CPU device the compiles use ``backend="aot_eager"``, as
train/steps.py's do; on CUDA, inductor. torch imports live inside
functions; the package stays importable with no accelerator stack. Exit
codes follow the CLI contract: 0 clean, 1 a failure above, 2 usage or
environment error (a request for CUDA without it included).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable, Optional

from .drivers import default_step_entry, resolve_runtime_target, runtime_device
from .exec_manifest import covers, entry_for, load_manifest

__all__ = ["AuditError", "CompileLedger", "run_compile_audit"]

_REPO = Path(__file__).resolve().parents[2]


class AuditError(RuntimeError):
    """Usage/environment error (CLI maps it to exit code 2)."""


def _rel(path: Optional[str]) -> str:
    if not path:
        return "?"
    p = Path(path).resolve()
    try:
        return p.relative_to(_REPO).as_posix()
    except ValueError:
        return p.as_posix()


def _counter_snapshot() -> dict:
    from torch._dynamo.utils import counters

    return {
        "graph_break": dict(counters["graph_break"]),
        "unique_graphs": int(counters["stats"]["unique_graphs"]),
        "cudagraph_skips": int(counters["inductor"]["cudagraph_skips"]),
    }


class CompileLedger:
    """Context manager: the compiles dynamo made while it was open.

    ``records`` holds one dict per compiled frame: ``name``, ``file``
    (repo-relative), ``line``, ``cache_size`` (the code object's cache
    entries before this compile: > 0 is a recompile), ``reason`` (dynamo's
    recompile reason), ``fail`` (a failed compile's type). ``graph_breaks``
    maps each break's reason to its count in the window. Windows may be
    opened more than once; everything accumulates."""

    def __init__(self):
        self.records: list = []
        self.graph_breaks: dict = {}
        self.unique_graphs = 0
        self.cudagraph_skips = 0
        self._mu = threading.Lock()
        self._seen: set = set()
        self._before: Optional[dict] = None

    def __enter__(self) -> "CompileLedger":
        from torch._dynamo import utils

        if hasattr(utils, "set_compilation_metrics_limit"):
            utils.set_compilation_metrics_limit(100_000)
        self._seen = {id(m) for m in utils.get_compilation_metrics()}
        self._before = _counter_snapshot()
        return self

    def __exit__(self, *exc) -> None:
        from torch._dynamo import utils

        after = _counter_snapshot()
        with self._mu:
            for m in utils.get_compilation_metrics():
                if id(m) in self._seen or getattr(m, "co_name", None) is None:
                    continue
                self.records.append({
                    "name": m.co_name,
                    "file": _rel(m.co_filename),
                    "line": int(m.co_firstlineno or 0),
                    "cache_size": int(getattr(m, "cache_size", 0) or 0),
                    "reason": getattr(m, "recompile_reason", None),
                    "fail": getattr(m, "fail_type", None),
                })
            for reason, n in after["graph_break"].items():
                d = n - self._before["graph_break"].get(reason, 0)
                if d:
                    self.graph_breaks[reason] = self.graph_breaks.get(reason, 0) + d
            self.unique_graphs += after["unique_graphs"] - self._before["unique_graphs"]
            self.cudagraph_skips += after["cudagraph_skips"] - self._before["cudagraph_skips"]

    def recompiles(self) -> list:
        return [r for r in self.records if r["cache_size"] > 0 or r["reason"]]

    def problems(self, manifest: dict) -> list:
        """What the manifest does not explain: graph breaks, compiles in
        no entry, failed compiles, and recompiles past its allowance."""
        out = [f"graph break x{n}: {reason}" for reason, n in sorted(self.graph_breaks.items())]
        for r in self.records:
            if r["fail"]:
                out.append(f"compile of {r['name']} ({r['file']}:{r['line']}) failed: {r['fail']}")
            elif entry_for(manifest, r["file"], r["line"]) is None:
                out.append(f"compile of {r['name']} ({r['file']}:{r['line']}) is in no "
                           "manifest entry")
        by_code: dict = {}
        for r in self.recompiles():
            by_code.setdefault((r["file"], r["line"], r["name"]), []).append(r)
        allowed = int(manifest.get("recompiles", 0))
        for (file, line, name), rs in sorted(by_code.items()):
            if len(rs) > allowed:
                reasons = "; ".join(str(r["reason"]).strip() for r in rs)
                out.append(f"{name} ({file}:{line}) recompiled {len(rs)}x (manifest allows "
                           f"{allowed}): {reasons}")
        return out

    def by_site(self, manifest: dict) -> dict:
        """Compiles per manifest entry name (``?`` for none)."""
        out: dict = {}
        for r in self.records:
            e = entry_for(manifest, r["file"], r["line"])
            key = f"{e['name']} ({e['file']}:{e['line']})" if e else "?"
            out[key] = out.get(key, 0) + 1
        return out


# ------------------------------------------------------------------ drives


def _drive_serve(ledger: CompileLedger, manifest: dict, device) -> list:
    """A real InferenceEngine over a small DeiT with flash attention (depth
    2, width 128, two heads of the kernels' head_dim 64, two buckets of the
    declared set): warm-up compiles every bucket, predict must then
    compile nothing. Returns coverage problems."""
    import numpy as np
    import torch

    from ..models.vit import VisionTransformer
    from ..ops.masking import make_masks
    from ..serve.engine import InferenceEngine

    model = VisionTransformer(num_classes=10, patch_size=16, embed_dim=128, depth=2,
                              num_heads=2, image_size=32, attention_impl="flash")
    model.init_weights(torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, model.state_dict(), make_masks(model),
                             input_shape=(32, 32, 3), buckets=(1, 8), device=device)
    x = np.zeros((3, 32, 32, 3), np.float32)
    n0 = len(ledger.records)
    with ledger:
        engine.warmup()
        engine.predict(x)  # rides the warmed bucket 8: no new compile
    problems = []
    compiled = len(ledger.records) - n0
    if compiled != len(engine.buckets):
        problems.append(f"serve: expected {len(engine.buckets)} compiles (one per bucket), "
                        f"observed {compiled}")
    kind = engine._plan_signature[0]
    for b in engine.compiled_buckets:
        if not covers(manifest, kind, b):
            problems.append(f"serve: compiled (plan={kind!r}, bucket={b}) is outside the "
                            "manifest's plan kinds x buckets")
    engine.close()
    return problems


def _drive_train(ledger: CompileLedger, manifest: dict, device) -> list:
    """The shared train step through ``compile_forward(train_forward)``,
    run twice: one compile, no recompile."""
    from ..train.steps import compile_forward, train_forward

    _model, _masks, _batch, step = default_step_entry(device)
    forward = compile_forward(train_forward, device)
    n0 = len(ledger.records)
    with ledger:
        step(forward)
        step(forward)
    if len(ledger.records) - n0 != 1:
        return [f"train: expected 1 compile of the train step, observed "
                f"{len(ledger.records) - n0}"]
    return []


def _custom_drive(spec: str) -> Callable:
    def drive(ledger: CompileLedger, manifest: dict, device) -> list:
        from .drivers import load_builder

        builder, _paths = load_builder(spec, error_cls=AuditError, what="--compile-audit target")
        fn = builder(device)  # set-up outside the window, like the built-ins
        if not callable(fn):
            raise AuditError(f"--compile-audit: {spec} must return a callable to drive")
        with ledger:
            out = fn()
        if isinstance(out, dict) and "buckets" in out:
            return [f"{spec}: compiled (plan={out['plan']!r}, bucket={b}) is outside the "
                    "manifest's plan kinds x buckets"
                    for b in out["buckets"] if not covers(manifest, out["plan"], b)]
        return []

    return drive


DRIVES = {"serve": _drive_serve, "train": _drive_train}


# ------------------------------------------------------------------ runner


def run_compile_audit(target: str = "all", device: str = "cuda",
                      print_fn: Callable = print) -> int:
    """Drive, record, attribute. Returns 0 (every compile attributed, no
    graph break, no recompile past the manifest, every (plan, bucket)
    covered) or 1; raises AuditError for usage problems. A ``file.py:fn``
    target's ``fn(device)`` returns the callable to drive; a dict it
    returns with ``plan`` and ``buckets`` is held to ``covers``."""
    try:
        import torch  # noqa: F401
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise AuditError(f"--compile-audit needs torch importable: {e}") from e
    dev = runtime_device(device, AuditError)
    target = target or "all"
    if target == "all":
        drives = list(DRIVES.items())
    else:
        kind, payload = resolve_runtime_target(target, DRIVES, error_cls=AuditError,
                                               what="--compile-audit target", load=False)
        drives = [(target, payload if kind == "named" else _custom_drive(target))]
    manifest = load_manifest()
    if manifest is None:
        raise AuditError("exec_manifest.json missing — run --exec-manifest emit and commit it "
                         "before auditing against it")

    import torch._dynamo.exc as dynamo_exc

    ledger = CompileLedger()
    problems: list = []
    for name, drive in drives:
        n0 = len(ledger.records)
        try:
            problems.extend(drive(ledger, manifest, dev))
        except dynamo_exc.TorchDynamoException as e:
            problems.append(f"{name}: dynamo refused the drive: {type(e).__name__}: "
                            f"{str(e).splitlines()[0] if str(e) else ''}")
        print_fn(f"compile-audit: drove {name} on {dev} "
                 f"({len(ledger.records) - n0} compile(s) in the window)")
    for r in ledger.records:
        e = entry_for(manifest, r["file"], r["line"])
        tag = f"entry {e['name']}" if e else "UNATTRIBUTED"
        again = f", recompile: {r['reason']}" if r in ledger.recompiles() else ""
        print_fn(f"  {r['name']} from {r['file']}:{r['line']} [{tag}{again}]")
    problems.extend(ledger.problems(manifest))
    for p in problems:
        print_fn(f"compile-audit: {p}")
    ok = not problems
    print_fn(f"compile-audit: {len(ledger.records)} compile(s), "
             f"{sum(ledger.graph_breaks.values())} graph break(s), "
             f"{len(ledger.recompiles())} recompile(s), {len(problems)} problem(s) — "
             f"{'clean' if ok else 'NOT clean'}")
    return 0 if ok else 1
